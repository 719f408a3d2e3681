"""ControlNet-SDV training in the port (``lkgd_torch.training.variants``) against
``lkgd_tpu.training.variants`` at fp32, on the tiny ControlNet and UNet of
``tests/test_torch_controlnet.py`` (every parameter random, the zero-init heads included)
at 32x32, 2 frames, 2 clips:

* the loss and every ControlNet gradient against ``jax.value_and_grad`` of the JAX step's
  loss with its sigmas and noise (drawn from ``jax.random.split(rng)`` as the step draws
  them) injected;
* the update on one set of gradients at a time: the train step's against the port's AdamW
  on the port's gradients, the port's AdamW on JAX's gradients against optax's on them, and
  where the gradients are above the floor below, the train step's against the JAX
  package's own jitted step; the EMA after two steps against that step's;
* the frozen UNet bit-identical afterwards, with no gradient;
* ``reverse_time_batch`` and ``consecutive_clip_batches`` equal to JAX's.

Tolerances: the loss rtol 1e-4, atol 2e-4; gradients, parameters and the EMA the same after
scaling each by its largest entry (a gradient by 1% of the largest ControlNet gradient where
that is larger: the biases just before GroupNorm groups of one channel, 32 channels in 32
groups at this width, have gradients that are zero but for rounding, ~1e-7 of the largest
in either package)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models.controlnet_svd import ControlNetSDV as JaxControlNet  # noqa: E402
from lkgd_tpu.models.controlnet_svd import ControlNetSDVConfig as JaxCNConfig  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.training import edm as jedm  # noqa: E402
from lkgd_tpu.training import train_state as jts  # noqa: E402
from lkgd_tpu.training import variants as jvar  # noqa: E402

from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.controlnet_svd import ControlNetSDV, ControlNetSDVConfig  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.training import train_state as tts  # noqa: E402
from lkgd_torch.training import variants as tvar  # noqa: E402

from tests.test_torch_controlnet import EMB, UNET  # noqa: E402
from tests.test_torch_porting import port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
B, T, S = 2, 2, 32
LAT = S // 4
KEYS = (jax.random.PRNGKey(7), jax.random.PRNGKey(8))


def _batch(seed=31):
    rng = np.random.default_rng(seed)
    return {"latents": (rng.standard_normal((B, T, LAT, LAT, 4)) * 0.5).astype(np.float32),
            "cond_latents": rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32),
            "image_embeddings": rng.standard_normal((B, 1, 32)).astype(np.float32),
            "control": rng.uniform(size=(B, T, S, S, 3)).astype(np.float32)}


def _draws(key):
    """The sigmas and noise the JAX step draws from ``key`` (``variants.py:37-40``)."""
    r_sigma, r_noise = jax.random.split(key)
    return {"sigmas": jedm.rand_cosine_interpolated(r_sigma, (B,)),
            "noise": jax.random.normal(r_noise, (B, T, LAT, LAT, 4), jnp.float32)}


def _torch(d: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _scaled_close(got, want, name, floor=1e-12):
    scale = max(floor, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                               err_msg=name, **TOL)


def _jax_loss(jcn, junet, cn_params, unet_params, batch, draws, cfg):
    """The loss of ``lkgd_tpu.training.variants.make_controlnet_train_step`` (:35-53) with
    its draws given, for ``jax.value_and_grad``."""
    latents = batch["latents"]
    noisy, inp = jedm.precondition_inputs(latents, draws["noise"], draws["sigmas"])
    timesteps = jedm.timesteps_from_sigmas(draws["sigmas"])
    cond = jnp.repeat(batch["cond_latents"][:, None], T, axis=1)
    model_in = jnp.concatenate([inp, cond], axis=-1)
    added = jnp.tile(jnp.asarray([[cfg.fps, cfg.motion_bucket_id, cfg.train_noise_aug]],
                                 jnp.float32), (B, 1))
    down, mid = jcn.apply(cn_params, model_in, timesteps, batch["image_embeddings"], added,
                          controlnet_cond=batch["control"])
    pred = junet.apply(unet_params, model_in, timesteps, batch["image_embeddings"], added,
                       down_block_additional_residuals=down, mid_block_additional_residual=mid)
    return jedm.edm_loss(pred, noisy, latents, draws["sigmas"])


@pytest.fixture(scope="module")
def jax_run():
    """Random JAX params, the JAX loss and gradients at the first key's draws, and the JAX
    package's own step twice (keys 7, 8) with an EMA."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    sample = jnp.zeros((B, T, LAT, LAT, 8))
    args = (sample, jnp.zeros((B,)), batch["image_embeddings"], jnp.ones((B, 3)))
    jcn = JaxControlNet(JaxCNConfig(unet=jcfg.SVDUNetConfig(**UNET),
                                    conditioning_embedding_out_channels=EMB))
    junet = JaxUNet(jcfg.SVDUNetConfig(**UNET))
    cn_params = randomize(jax.eval_shape(lambda: jcn.init(jax.random.PRNGKey(0), *args,
                                                          controlnet_cond=batch["control"])),
                          seed=41, scale=0.1)
    unet_params = randomize(jax.eval_shape(lambda: junet.init(jax.random.PRNGKey(1), *args)),
                            seed=42, scale=0.1)
    cfg = jts.SVDTrainConfig()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcn, junet, p, unet_params, batch, _draws(KEYS[0]), cfg)))(cn_params)
    optimizer = jts.make_optimizer(1e-3)
    updates, _ = optimizer.update(grads, optimizer.init(cn_params), cn_params)
    optax_after = optax.apply_updates(cn_params, updates)  # optax on these very gradients
    step = jax.jit(jvar.make_controlnet_train_step(junet, jcn, optimizer))
    state = jts.init_train_state(cn_params, optimizer, ema=True)
    states, step_losses = [], []
    for key in KEYS:
        state, step_loss = step(state, dict(batch, unet_params=unet_params), key)
        states.append(state)
        step_losses.append(float(step_loss))
    np.testing.assert_allclose(step_losses[0], float(loss), rtol=1e-6)
    return dict(cn_params=cn_params, unet_params=unet_params, loss=float(loss), grads=grads,
                optax_after=optax_after, states=states, step_losses=step_losses)


def _adamw_step(start: dict, grads: dict) -> dict:
    """The port's AdamW (lr 1e-3 with the global-norm clip) from the parameters ``start``
    with the gradients ``grads`` (zeros where one has none)."""
    params = torch.nn.ParameterList([torch.nn.Parameter(start[n].clone()) for n in start])
    optimizer = tts.make_optimizer(1e-3)
    optimizer.init(params)
    for p, name in zip(params, start):
        p.grad = grads[name].clone() if name in grads else None
    optimizer.step()
    return {name: p.detach() for name, p in zip(start, params)}


def _port_models(run):
    controlnet = ControlNetSDV(ControlNetSDVConfig(unet=tcfg.SVDUNetConfig(**UNET),
                                                   conditioning_embedding_out_channels=EMB))
    controlnet.load_state_dict(port_state_dict(run["cn_params"]), strict=True)
    unet = UNetSpatioTemporalCondition(tcfg.SVDUNetConfig(**UNET))
    unet.load_state_dict(port_state_dict(run["unet_params"]), strict=True)
    return controlnet, unet


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's side: the loss and gradients at the first key's draws, then two train
    steps with the draws injected, the gradients each step took, the parameters after each
    step and the state."""
    controlnet, unet = _port_models(jax_run)
    frozen = {n: p.detach().clone() for n, p in unet.named_parameters()}
    step = tvar.make_controlnet_train_step(unet)
    state = tts.init_train_state(controlnet, tts.make_optimizer(1e-3), ema=True)
    loss = tvar.controlnet_loss(controlnet, unet, _torch(_batch()), tts.SVDTrainConfig(),
                                **_torch(_draws(KEYS[0])))
    loss.backward()
    loss_grads = {n: None if p.grad is None else p.grad.clone()
                  for n, p in state.trainables.items()}
    unet_grads = [p.grad for p in unet.parameters()]
    controlnet.zero_grad(set_to_none=True)

    start = {n: p.detach().clone() for n, p in state.trainables.items()}
    grads, moved, step_losses = [], [], []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads[-1].__setitem__(n, p.grad.detach().clone()))
        for n, p in state.trainables.items()]
    for key in KEYS:
        grads.append({})
        state, step_loss = step(state, _torch(_batch()), **_torch(_draws(key)))
        moved.append({n: p.detach().clone() for n, p in state.trainables.items()})
        step_losses.append(step_loss.item())
    for h in hooks:
        h.remove()
    return dict(unet=unet, frozen=frozen, controlnet=controlnet, state=state,
                loss=loss.item(), loss_grads=loss_grads, unet_grads=unet_grads, start=start,
                grads=grads, moved=moved, step_losses=step_losses)


def _floor(want: dict) -> float:
    return 1e-2 * max(float(w.abs().max()) for w in want.values())


def test_loss_and_gradients_match_jax(jax_run, port_run):
    np.testing.assert_allclose(port_run["loss"], jax_run["loss"], **TOL)
    want = port_state_dict(jax_run["grads"])
    got = port_run["loss_grads"]
    assert sorted(got) == sorted(want)
    assert len(got) == len(list(port_run["controlnet"].parameters()))
    no_grad = sorted(n for n, g in got.items() if g is None)
    # attn2 attends to one key: the port broadcasts V, so its query side (norm2, to_q, to_k)
    # gets no gradient, where JAX's softmax over one key gives exact zeros
    assert no_grad and all(any(part in n for part in (".attn2.to_q.", ".attn2.to_k.", ".norm2."))
                           for n in no_grad), no_grad
    for name in no_grad:
        assert not want[name].abs().max()
    floor = _floor(want)
    for name, g in got.items():
        if g is not None:
            assert torch.isfinite(g).all(), name
            _scaled_close(g.numpy(), want[name].numpy(), name, floor)


def test_update_on_one_set_of_gradients(jax_run, port_run):
    """Adam's first step divides each entry by its own size plus 1e-8, so the rounding-level
    gradients of the tensors under the floor become moves of up to ~5e-4 that differ from
    program to program (JAX's own two included). So: the step applied the port's AdamW to
    its own gradients; the port's AdamW on JAX's gradients is optax's on them; and where
    the gradients are above the floor, the step is the JAX package's step."""
    start, moved = port_run["start"], port_run["moved"]
    for name, p in _adamw_step(start, port_run["grads"][0]).items():
        torch.testing.assert_close(moved[0][name], p, rtol=0, atol=0, msg=name)
    want = port_state_dict(jax_run["grads"])
    optax_after = port_state_dict(jax_run["optax_after"])
    for name, p in _adamw_step(start, want).items():
        _scaled_close(p.numpy(), optax_after[name].numpy(), name)
    after = port_state_dict(jax_run["states"][0].params)
    above = [n for n in want if want[n].abs().max() >= _floor(want)]
    assert len(above) > len(want) // 2
    for name in above:
        _scaled_close(moved[0][name].numpy(), after[name].numpy(), name)
    for i, loss in enumerate(port_run["step_losses"]):
        np.testing.assert_allclose(loss, jax_run["step_losses"][i], **TOL)


def test_ema_after_two_steps(jax_run, port_run):
    state, start, moved = port_run["state"], port_run["start"], port_run["moved"]
    assert state.step == 2
    ema = port_state_dict(jax_run["states"][1].ema_params)
    assert sorted(state.ema_params) == sorted(ema) == sorted(start)
    for name, e in state.ema_params.items():
        _scaled_close(e.numpy(), ema[name].numpy(), name)
    # e * 0.9999 + p * 0.0001 twice, in float64 from the port's own parameters after each
    # step: the EMA sits within fp32 rounding of it, off the start and off the parameters
    for name, e in state.ema_params.items():
        s0, p1, p2 = (x[name].double() for x in (start, moved[0], moved[1]))
        want64 = (s0 * 0.9999 + p1 * 1e-4) * 0.9999 + p2 * 1e-4
        torch.testing.assert_close(e.double(), want64, rtol=0,
                                   atol=1e-6 * float(s0.abs().max()) + 1e-12, msg=name)
        assert not torch.equal(e, start[name]) and not torch.equal(e, moved[1][name]), name


def test_unet_stays_frozen(port_run):
    unet = port_run["unet"]
    assert not any(p.requires_grad for p in unet.parameters())
    assert all(g is None for g in port_run["unet_grads"])
    for name, p in unet.named_parameters():
        assert torch.equal(p, port_run["frozen"][name]), f"frozen {name} moved"


def test_controlnet_step_draws_from_its_generator(jax_run):
    """Without injected draws the step takes sigmas and noise from the generator: the same
    seed gives the same loss, another seed another."""
    losses = []
    for seed in (3, 3, 4):
        controlnet, unet = _port_models(jax_run)
        state = tts.init_train_state(controlnet, tts.make_optimizer(1e-3))
        _, loss = tvar.make_controlnet_train_step(unet)(
            state, _torch(_batch()), torch.Generator().manual_seed(seed))
        losses.append(loss.item())
    assert losses[0] == losses[1] != losses[2]
    assert np.isfinite(losses).all()


def test_batch_transforms_match_jax():
    lat = np.random.default_rng(32).standard_normal((2, 9, 3, 3, 4)).astype(np.float32)
    batch = {"latents": lat, "cond_latents": lat[:, 0]}
    got = tvar.reverse_time_batch(_torch(batch))
    want = jvar.reverse_time_batch({k: jnp.asarray(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for clip_len in (4, 3):
        np.testing.assert_array_equal(
            tvar.consecutive_clip_batches(torch.from_numpy(lat), clip_len).numpy(),
            np.asarray(jvar.consecutive_clip_batches(jnp.asarray(lat), clip_len)))
