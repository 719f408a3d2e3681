"""The port's SD-2D train step (``lkgd_torch.training.sd2d``) against
``lkgd_tpu.training.sd2d`` at fp32 on the CPU, on the tiny 2D UNet of
``tests/test_sd2d_training.py`` (joint attention ``post="conv"``, a rank-2 LoRA on every
``attn1`` projection), every parameter random, 16x16 latents:

* ``joint_one_pair``: one x/y pair (halves ``[x, y]``, shared timesteps), ``snr_gamma=5``;
* ``joint_two_pairs``: two pairs (``[x0, x1, y0, y1]``), no SNR weighting;
* ``inpaint``: the 9-channel UNet with its conditioning encoder, ``extra_channels`` and
  ``cond_image``, independent timesteps, prompt dropout at 0.5, ``snr_gamma=5``.

The JAX package's own jitted step runs once with masked AdamW (lr 1e-3) behind an optimizer
that keeps the gradients it is given; its draws (``jax.random.split(rng, 3)``: ``randint``,
``normal``, ``uniform``) go to the port as ``timesteps=``, ``noise=`` and ``drop=``. Held:
the loss (rtol 1e-4, atol 2e-4); every trainable gradient scaled by its largest entry or by
1% of the largest of all, whichever is larger (the repo's parity tolerance after scaling:
Adam's first step turns rounding-level gradients into moves that differ between any two
programs); the update on one set of gradients (the port's AdamW on JAX's gradients against
optax's); the trained set, and the halves' pairing at two pairs."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models import unet_2d as junet  # noqa: E402
from lkgd_tpu.training import sd2d as jsd2d  # noqa: E402
from lkgd_tpu.training import train_state as jts  # noqa: E402

from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models import unet_2d as tunet  # noqa: E402
from lkgd_torch.models.layers import materialize  # noqa: E402
from lkgd_torch.training import sd2d as tsd2d  # noqa: E402
from lkgd_torch.training import train_state as tts  # noqa: E402
from lkgd_torch.utils.porting import unet2d_key_map  # noqa: E402

from tests.test_torch_cogvideox_train import _floor, _scaled_close, grads_kept  # noqa: E402
from tests.test_torch_porting import jit, port_state_dict, randomize  # noqa: E402
from tests.test_torch_sd2d import EMB, TINY_UNET  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
LR, H = 1e-3, 16
KEY = jax.random.PRNGKey(9)
CASES = {"joint_one_pair": dict(rows=2, snr_gamma=5.0, joint_streams=True),
         "joint_two_pairs": dict(rows=4, snr_gamma=None, joint_streams=True),
         "inpaint": dict(rows=2, snr_gamma=5.0, joint_streams=False, prompt_dropout_prob=0.5)}


def jax_trainable(path: str) -> bool:
    return "lora" in path or "joint" in path


def unet_configs(case: str):
    out = []
    for c, cls in ((jcfg, junet.UNet2DConfig), (tcfg, tcfg.UNet2DConfig)):
        lora = c.LoraRouter(rules=(c.LoraRule("*attn1*", "j", 2, 2.0),))
        if case == "inpaint":
            out.append(cls(**{**TINY_UNET, "in_channels": 9}, cond_embedding_channels=3,
                           cond_embedding_blocks=EMB, lora=lora))
        else:
            out.append(cls(**TINY_UNET, lora=lora, joint=c.JointAttentionConfig(
                post="conv", mask=(0, 1), spatial=True)))
    return tuple(out)


def train_config(module, case: str):
    kw = {k: v for k, v in CASES[case].items() if k != "rows"}
    return module.SD2DTrainConfig(**kw)


def batch(case: str) -> dict:
    rng = np.random.default_rng(list(CASES).index(case))
    rows = CASES[case]["rows"]
    out = {"latents": rng.normal(size=(rows, H, H, 4)).astype(np.float32) * 0.5,
           "prompt_embeds": rng.normal(size=(rows, 5, 32)).astype(np.float32)}
    if case == "inpaint":
        out["extra_channels"] = rng.normal(size=(rows, H, H, 5)).astype(np.float32)
        out["cond_image"] = rng.uniform(size=(rows, 4 * H, 4 * H, 3)).astype(np.float32)
    return out


def draws(case: str) -> dict:
    """The JAX step's draws from ``KEY`` (``lkgd_tpu/training/sd2d.py:47-61``)."""
    cfg = train_config(jsd2d, case)
    rows = CASES[case]["rows"]
    r_t, r_noise, r_drop = jax.random.split(KEY, 3)
    if cfg.joint_streams and not cfg.no_timestep_align:
        half = jax.random.randint(r_t, (rows // 2,), 0, cfg.num_train_timesteps)
        timesteps = jnp.concatenate([half, half])
    else:
        timesteps = jax.random.randint(r_t, (rows,), 0, cfg.num_train_timesteps)
    return {"timesteps": np.asarray(timesteps),
            "noise": np.asarray(jax.random.normal(r_noise, (rows, H, H, 4), jnp.float32)),
            "drop": np.asarray(jax.random.uniform(r_drop, (rows,)) < cfg.prompt_dropout_prob)}


@functools.cache
def param_shapes(inpaint: bool):
    """The UNet's parameter shapes, traced once for the joint cases (the batch moves none)."""
    case = "inpaint" if inpaint else "joint_one_pair"
    model = junet.UNet2DCondition(unet_configs(case)[0])
    b = {k: jnp.asarray(v) for k, v in batch(case).items()}
    init_kw = {"cond_image": b["cond_image"]} if inpaint else {}
    sample = jnp.concatenate([b["latents"], b["extra_channels"]], axis=-1) if inpaint \
        else b["latents"]
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), sample, jnp.zeros((sample.shape[0],)), b["prompt_embeds"],
        **init_kw))


@pytest.fixture(scope="module", params=list(CASES))
def jax_run(request):
    case = request.param
    jc, _ = unet_configs(case)
    model = junet.UNet2DCondition(jc)
    b = {k: jnp.asarray(v) for k, v in batch(case).items()}
    params = randomize(param_shapes(case == "inpaint"), seed=40 + list(CASES).index(case))
    optimizer = grads_kept(jts.make_optimizer(LR, trainable_predicate=jax_trainable))
    step = jit(jsd2d.make_sd2d_train_step(model, optimizer,
                                          config=train_config(jsd2d, case)))
    # the optimizer's state and optax's update each in one program: run op by op they
    # compile one small program per parameter shape
    new_state, loss = step(jit(lambda p: jts.init_train_state(p, optimizer))(params), b, KEY)
    grads = new_state.opt_state[0]
    plain = jts.make_optimizer(LR, trainable_predicate=jax_trainable)
    optax_after = jit(lambda g, p: optax.apply_updates(
        p, plain.update(g, plain.init(p), p)[0]))(grads, params)
    return dict(case=case, params=params, loss=float(loss), grads=grads,
                after=new_state.params, optax_after=optax_after)


def port_unet(run):
    _, tc = unet_configs(run["case"])
    unet = materialize(lambda: tunet.UNet2DCondition(tc), "cpu", torch.float32)
    unet.load_state_dict(port_state_dict(run["params"], unet2d_key_map), strict=True)
    return unet


def _torch(d: dict) -> dict:
    return {k: torch.tensor(v) for k, v in d.items()}


def _trained(tree) -> dict:
    return {n: v for n, v in port_state_dict(tree, unet2d_key_map).items()
            if tts.trainable_trans(n)}


def test_loss_and_gradients_match_jax(jax_run):
    unet = port_unet(jax_run)
    optimizer = tts.make_optimizer(LR, trainable_predicate=tts.trainable_trans)
    state = tts.init_train_state(unet, optimizer)
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in state.trainables.items()]
    step = tsd2d.make_sd2d_train_step(unet, optimizer,
                                      config=train_config(tsd2d, jax_run["case"]))
    state, loss = step(state, _torch(batch(jax_run["case"])), **_torch(draws(jax_run["case"])))
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(loss.item(), jax_run["loss"], **TOL)
    want = _trained(jax_run["grads"])
    assert sorted(grads) == sorted(want) == sorted(state.trainables)
    assert any("attn1n" in n for n in want) == jax_run["case"].startswith("joint")
    floor = _floor(want)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        _scaled_close(g.numpy(), want[name].numpy(), name, floor)
    assert state.step == 1


def test_update_on_one_set_of_gradients(jax_run):
    """The port's AdamW on JAX's gradients moves each trainable as optax does."""
    unet = port_unet(jax_run)
    optimizer = tts.make_optimizer(LR, trainable_predicate=tts.trainable_trans)
    state = tts.init_train_state(unet, optimizer)
    for name, g in _trained(jax_run["grads"]).items():
        state.trainables[name].grad = g.clone()
    optimizer.step()
    start, want = _trained(jax_run["params"]), _trained(jax_run["optax_after"])
    for name, p in state.trainables.items():
        _scaled_close(p.detach().numpy() - start[name].numpy(),
                      want[name].numpy() - start[name].numpy(), name)
    frozen = port_state_dict(jax_run["after"], unet2d_key_map)
    for name, p in unet.named_parameters():
        if name not in state.trainables:
            assert torch.equal(p.detach(), frozen[name]), name


def test_joint_halves_pair_row_for_row_at_two_pairs():
    """The train step's halves ``[x0, x1, y0, y1]`` under the UNet's block-wise mask
    ``(0, 1)``: the x block is rows 0-1 and the y block rows 2-3, so row 0's joint partner is
    row 2 (y0): moving row 2 moves row 0's output, moving row 3 (y1) does not."""
    _, tc = unet_configs("joint_two_pairs")
    unet = materialize(lambda: tunet.UNet2DCondition(tc), "cpu", torch.float32)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0.0, 0.15, generator=gen)
        b = _torch(batch("joint_two_pairs"))
        t = torch.full((4,), 300.0)
        base = unet(b["latents"], t, b["prompt_embeds"])
        for moved, changes in ((2, True), (3, False)):
            x = b["latents"].clone()
            x[moved] += 1.0
            out = unet(x, t, b["prompt_embeds"])
            assert torch.equal(out[0], base[0]) != changes, moved
