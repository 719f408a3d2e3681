"""The port's training path (``lkgd_torch.training``) against ``lkgd_tpu.training`` at fp32:

* the EDM functions on the same uniform draws;
* the tiny LKGD train step (knowledge fusion, a rank-2 temporal LoRA, as
  ``tests/test_training.py``): its loss and every trainable gradient against
  ``jax.value_and_grad`` of the same loss with the same injected sigmas, noise and
  dropout draws, and the trainables after one optimizer step against the JAX package's
  own jitted step (optax masked AdamW + global-norm clip);
* one masked AdamW + clip step against optax, with the clip on and off;
* ``Trainer.fit`` with checkpoints, rotation and resume, and the trained-parameter
  export against the JAX package's ``export_trainable_safetensors``, read back with
  ``safetensors.numpy``.

Tolerances: the loss and the UNet outputs rtol 1e-4, atol 2e-4 (fp32 through composed
graphs summed in another order); gradients the same after scaling each by its largest
entry; optimizer updates rtol 1e-5, atol 1e-7 (one fp32 Adam step, different operation
order)."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.training import edm as jedm  # noqa: E402
from lkgd_tpu.training import train_state as jts  # noqa: E402
from lkgd_tpu.training.trainer import export_trainable_safetensors as jax_export  # noqa: E402
from lkgd_tpu.utils.porting import export_state_dict  # noqa: E402

from lkgd_torch.models import layers as tlayers  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.training import edm as tedm  # noqa: E402
from lkgd_torch.training import train_state as tts  # noqa: E402
from lkgd_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402
from lkgd_torch.training.trainer import export_trainable_safetensors  # noqa: E402

from tests.test_torch_lora import tiny_lkgd, tiny_lkgd_configs, trainable  # noqa: E402,F401
from tests.test_torch_porting import port_state_dict  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
DROPOUT = 0.3  # large enough that both dropout masks act on the tiny batch
B, T, HW = 2, 4, 8


def _batch(seed=21):
    rng = np.random.default_rng(seed)
    return {"latents": (rng.standard_normal((B, T, HW, HW, 4)) * 0.5).astype(np.float32),
            "cond_latents": rng.standard_normal((B, HW, HW, 4)).astype(np.float32),
            "image_embeddings": rng.standard_normal((B, 1, 64)).astype(np.float32),
            "domain_features": rng.standard_normal((B, 1, 48)).astype(np.float32),
            "flow_features": rng.standard_normal((B, 1, 48)).astype(np.float32)}


def _draws(key):
    """The sigmas, noise and dropout uniforms the JAX step draws from ``key``."""
    r_sigma, r_noise, r_drop1, _ = jax.random.split(key, 4)
    return {"sigmas": jedm.rand_cosine_interpolated(r_sigma, (B,)),
            "noise": jax.random.normal(r_noise, (B, T, HW, HW, 4), jnp.float32),
            "dropout_u": jax.random.uniform(r_drop1, (B,))}


def _torch(d: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _assert_scaled_close(got, want, name):
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                               err_msg=name, **TOL)


# ------------------------------------------------------------------ EDM
def test_stratified_and_cosine_interpolated_sigmas():
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (7,)))  # the draw inside stratified_uniform
    np.testing.assert_allclose(tedm.stratified_uniform((7,), u=torch.from_numpy(u)).numpy(),
                               np.asarray(jedm.stratified_uniform(key, (7,))), rtol=1e-6)
    got = tedm.rand_cosine_interpolated((7,), u=torch.from_numpy(u)).numpy()
    want = np.asarray(jedm.rand_cosine_interpolated(key, (7,)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ((got >= 0.002 * 0.99) & (got <= 700 * 1.01)).all()
    g = torch.Generator().manual_seed(0)
    drawn = tedm.rand_cosine_interpolated((1000,), generator=g)
    assert drawn.shape == (1000,) and torch.isfinite(drawn).all()


def test_preconditioning_and_loss():
    rng = np.random.default_rng(4)
    x, eps, pred, target = (rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32)
                            for _ in range(4))
    sig = np.array([0.01, 1.0, 80.0], np.float32)
    for got, want in zip(tedm.precondition_inputs(*map(torch.from_numpy, (x, eps, sig))),
                         jedm.precondition_inputs(*map(jnp.asarray, (x, eps, sig)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for got, want in zip(tedm.denoise_and_weigh(*map(torch.from_numpy, (pred, x, sig))),
                         jedm.denoise_and_weigh(*map(jnp.asarray, (pred, x, sig)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tedm.edm_loss(*map(torch.from_numpy, (pred, x, target, sig))).item(),
        float(jedm.edm_loss(*map(jnp.asarray, (pred, x, target, sig)))), rtol=1e-6)
    np.testing.assert_allclose(tedm.timesteps_from_sigmas(torch.from_numpy(sig)).numpy(),
                               np.asarray(jedm.timesteps_from_sigmas(jnp.asarray(sig))),
                               rtol=1e-6)


# ------------------------------------------------------------------ the train step
def _jax_loss(jmod, params, batch, draws, cfg):
    """The loss of ``lkgd_tpu.training.train_state.make_svd_train_step`` (:97-135) with
    the draws given, so that ``jax.value_and_grad`` sees it."""
    latents = batch["latents"]
    noisy, inp = jedm.precondition_inputs(latents, draws["noise"], draws["sigmas"])
    timesteps = jedm.timesteps_from_sigmas(draws["sigmas"])
    p, u = cfg.conditioning_dropout_prob, draws["dropout_u"]
    ehs = jnp.where((u < 2 * p)[:, None, None], 0.0, batch["image_embeddings"])
    cond_latents = batch["cond_latents"] * (1.0 - ((u >= p) & (u < 3 * p)).astype(
        jnp.float32))[:, None, None, None]
    cond = jnp.repeat(cond_latents[:, None], T, axis=1)
    model_in = jnp.concatenate([inp, cond], axis=-1)
    ids = jnp.tile(jnp.asarray([[cfg.fps, cfg.motion_bucket_id, cfg.train_noise_aug]],
                               jnp.float32), (B, 1))
    pred = jmod.apply(params, model_in, timesteps, ehs, ids,
                      domain_features=batch["domain_features"],
                      flow_features=batch["flow_features"])
    return jedm.edm_loss(pred, noisy, latents, draws["sigmas"])


def _port_state(params, ema=False):
    _, tconf = tiny_lkgd_configs()
    unet = tlayers.materialize(lambda: UNetSpatioTemporalCondition(tconf), "cpu", torch.float32)
    unet.load_state_dict(port_state_dict(params), strict=True)
    return tts.init_train_state(unet, tts.make_optimizer(1e-3, trainable_predicate=trainable),
                                ema=ema)


def test_tiny_train_step_matches_jax(tiny_lkgd):
    jmod, params, _ = tiny_lkgd
    cfg = jts.SVDTrainConfig(conditioning_dropout_prob=DROPOUT)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(2)  # u = (0.61, 0.06): each mask acts on one sample
    draws = _draws(key)
    u = np.asarray(draws["dropout_u"])
    assert (u < 2 * DROPOUT).any() and ((u >= DROPOUT) & (u < 3 * DROPOUT)).any()

    # JAX: the loss and its gradients, then the package's own step
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmod, p, batch, draws, cfg)))(params)
    optimizer = jts.make_optimizer(1e-3, trainable_predicate=trainable)
    step_j = jax.jit(jts.make_svd_train_step(jmod, optimizer, cfg))
    state_j, loss_step_j = step_j(jts.init_train_state(params, optimizer), batch, key)
    np.testing.assert_allclose(float(loss_step_j), float(loss_j), rtol=1e-6)

    # the port, with the JAX draws injected
    state = _port_state(params)
    frozen_before = {n: p.detach().clone() for n, p in state.unet.named_parameters()
                     if not trainable(n)}
    loss = tts.svd_loss(state.unet, _torch(_batch()), tts.SVDTrainConfig(
        conditioning_dropout_prob=DROPOUT), **_torch(draws))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    want = export_state_dict(grads_j, path_predicate=trainable)
    got = {n: p.grad.numpy().copy() for n, p in state.trainables.items()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.isfinite(got[name]).all(), name
        _assert_scaled_close(got[name], want[name], name)
    assert all(p.grad is None for n, p in state.unet.named_parameters() if not trainable(n))

    state.optimizer.step()
    after = export_state_dict(state_j.params, path_predicate=trainable)
    for name, p in state.trainables.items():
        _assert_scaled_close(p.detach().numpy(), after[name], name)
    for name, p in state.unet.named_parameters():
        if not trainable(name):
            assert torch.equal(p, frozen_before[name]), f"frozen {name} moved"


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["clip_off", "clip_on"])
def test_masked_adamw_matches_optax(grad_scale):
    """Three steps of the masked AdamW with a global-norm clip against optax, on a tree
    with a frozen leaf (bit-identical after) and trainable ones."""
    rng = np.random.default_rng(6)
    shapes = {"lora_x": (3, 4), "knowledge_fusion_w": (5,), "frozen": (2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    tx = jts.make_optimizer(1e-2, trainable_predicate=trainable)
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params_j)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params_j)
        params_j = optax.apply_updates(params_j, updates)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = tts.make_optimizer(1e-2, trainable_predicate=trainable)
    opt.init(module)
    assert sorted(opt.params) == ["knowledge_fusion_w", "lora_x"]
    for g in grads:
        for k, p in opt.params.items():
            p.grad = torch.from_numpy(g[k].copy())  # the clip scales in place
        norm = opt.step()
    expect_norm = np.sqrt(sum((grads[-1][k] ** 2).sum() for k in opt.params))
    np.testing.assert_allclose(norm.item(), expect_norm, rtol=1e-5)
    for k in shapes:
        np.testing.assert_allclose(getattr(module, k).detach().numpy(), np.asarray(params_j[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert np.array_equal(module.frozen.detach().numpy(), init["frozen"])


# ------------------------------------------------------------------ trainer and export
def test_trainer_fit_checkpoint_resume(tiny_lkgd, tmp_path):
    _, params, _ = tiny_lkgd
    step = tts.make_svd_train_step(tts.SVDTrainConfig())
    batch = _torch(_batch())
    cfg = TrainerConfig(output_dir=str(tmp_path), max_steps=3, checkpoint_every=2,
                        checkpoints_total_limit=1, log_every=1)
    state = _port_state(params, ema=True)
    final = Trainer(step, state, cfg).fit(iter([batch] * 10))
    assert final.step == 3
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(set(r) == {"step", "train_loss", "steps_per_sec"} for r in records)
    assert all(np.isfinite(r["train_loss"]) for r in records)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["3.pt"]

    # resume into a fresh state built from the same initial weights
    resumed = Trainer(step, _port_state(params, ema=True), cfg)
    assert resumed.restore_latest() == 3
    for name, p in resumed.state.trainables.items():
        assert torch.equal(p, final.trainables[name]), name
    for name, e in resumed.state.ema_params.items():
        assert torch.equal(e, final.ema_params[name]), name
    moved = [n for n, p in final.trainables.items()
             if not torch.equal(p, _port_state(params).trainables[n])]
    assert moved
    cfg.max_steps = 4
    assert resumed.fit(iter([batch] * 10)).step == 4


def test_export_matches_jax_export(tiny_lkgd, tmp_path):
    from safetensors.numpy import load_file

    _, params, _ = tiny_lkgd
    n_j = jax_export(params, trainable, str(tmp_path / "jax.safetensors"))
    state = _port_state(params)
    n_t = export_trainable_safetensors(state.unet, trainable, str(tmp_path / "port.safetensors"))
    want, got = load_file(str(tmp_path / "jax.safetensors")), load_file(
        str(tmp_path / "port.safetensors"))
    assert n_t == n_j == len(want) > 0
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype and got[name].shape == value.shape, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)
