"""The frame-transition fine-tune (``--mode trans`` of ``lkgd_torch/cli/train_svd_lora.py``)
against ``lkgd_tpu`` at fp32:

* the trained set: the port's ``trainable_trans`` selects, under the port's names, exactly
  the parameters the JAX CLI's ``"lora_" in path or "joint" in path`` selects;
* the tiny trans train step (joint branch with flip, the yx/xy/y adapters at rank 2, one
  [x, y] pair, ``tie_stream_pairs``): the loss and every trainable gradient against
  ``jax.value_and_grad`` of the same loss with JAX's sigma, noise and dropout draws, and
  the trainables after one optimizer step (weight decay on the zero-gradient ``to_q`` /
  ``to_k`` of ``attn2`` included) against the JAX package's optimizer on those gradients;
* two pairs a step: both packages pair row 0 with row 2, not with its flipped copy in
  row 1; the port's CLI refuses that batch.

Tolerances as ``tests/test_torch_training.py``: the loss rtol 1e-4, atol 2e-4; gradients and
updated trainables the same after scaling each by its largest entry."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.training import edm as jedm  # noqa: E402
from lkgd_tpu.training import train_state as jts  # noqa: E402
from lkgd_tpu.utils.porting import export_state_dict  # noqa: E402

from lkgd_torch.cli import train_svd_lora as cli  # noqa: E402
from lkgd_torch.models import layers as tlayers  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.training import train_state as tts  # noqa: E402

from tests.test_torch_porting import TINY_UNET, port_state_dict, randomize  # noqa: E402
from tests.test_torch_train_cli import TINY, _args  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
DROPOUT = 0.3
T, HW = 4, 8


def jax_trainable(path: str) -> bool:
    """The JAX CLI's trans predicate (``lkgd_tpu/cli/train_svd_lora.py:87``)."""
    return "lora_" in path or "joint" in path


def trans_configs():
    """(JAX, port) tiny UNets of the trans CLI: the JAX CLI's joint topology and adapters
    (``lkgd_tpu/cli/train_svd_lora.py:79-86``) at rank 2, at tiny widths."""
    args = _args("unused", "--mode", "trans")
    tconf = cli.unet_config(args, TINY)
    jconf = jcfg.SVDUNetConfig(
        **TINY_UNET, num_frames=T,
        joint=jcfg.JointAttentionConfig(post="conv", flip=True, mask=(0, 1)),
        lora=jcfg.LoraRouter(rules=(
            jcfg.LoraRule("*attn1n*", "yx_lora", 2, 2.0, (0, 1)),
            jcfg.LoraRule("*attn1.*", "xy_lora", 2, 2.0, (1, 0)),
            jcfg.LoraRule("*attn2*", "y_lora", 2, 2.0, (0, 1)))))
    return jconf, tconf


def unet_inputs(rows, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, T, HW, HW, 8)).astype(np.float32),
            np.linspace(-1.0, 0.5, rows).astype(np.float32),
            rng.standard_normal((rows, 1, 64)).astype(np.float32),
            np.tile(np.array([[6, 127, 0.02]], np.float32), (rows, 1)))


@pytest.fixture(scope="module")
def tiny_trans():
    jconf, tconf = trans_configs()
    jmod = JaxUNet(jconf, dtype=jnp.float32)
    args = tuple(jnp.asarray(a) for a in unet_inputs(2))
    params = randomize(jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *args),
                       seed=14)
    return jmod, params, tconf


def _port_unet(params, tconf):
    unet = tlayers.materialize(lambda: UNetSpatioTemporalCondition(tconf), "cpu", torch.float32)
    unet.load_state_dict(port_state_dict(params), strict=True)
    return unet


def test_trainable_set_matches_jax(tiny_trans):
    _, params, tconf = tiny_trans
    want = sorted(export_state_dict(params, path_predicate=jax_trainable))
    with torch.device("meta"):
        names = [n for n, _ in UNetSpatioTemporalCondition(tconf).named_parameters()]
    got = sorted(n for n in names if cli.trainable_trans(n))
    assert got == want
    kinds = {k: sum(k in n for n in got) for k in
             (".attn1n.to_q.weight", ".conv1n.weight", "lora_yx_lora_A", "lora_xy_lora_A",
              ".attn2.to_v.lora_y_lora_A", ".attn2.to_q.lora_y_lora_A")}
    assert all(kinds.values()), kinds
    assert not any(cli.trainable_trans(n) for n in (
        "conv_in.weight", "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
        "down_blocks.0.attentions.0.transformer_blocks.0.norm1.weight"))


def _batch(seed=21):
    rng = np.random.default_rng(seed)
    return {"latents": (rng.standard_normal((2, T, HW, HW, 4)) * 0.5).astype(np.float32),
            "cond_latents": rng.standard_normal((2, HW, HW, 4)).astype(np.float32),
            "image_embeddings": rng.standard_normal((2, 1, 64)).astype(np.float32)}


def _draws(key):
    """What the JAX step draws from ``key`` with ``tie_stream_pairs``
    (``lkgd_tpu/training/train_state.py:99-104, 117``)."""
    r_sigma, r_noise, r_drop1, _ = jax.random.split(key, 4)
    return {"sigmas": jnp.repeat(jedm.rand_cosine_interpolated(r_sigma, (1,)), 2, axis=0),
            "noise": jax.random.normal(r_noise, (2, T, HW, HW, 4), jnp.float32),
            "dropout_u": jax.random.uniform(r_drop1, (2,))}


def _jax_loss(jmod, params, batch, draws, cfg):
    latents = batch["latents"]
    noisy, inp = jedm.precondition_inputs(latents, draws["noise"], draws["sigmas"])
    p, u = cfg.conditioning_dropout_prob, draws["dropout_u"]
    ehs = jnp.where((u < 2 * p)[:, None, None], 0.0, batch["image_embeddings"])
    cond = batch["cond_latents"] * (1.0 - ((u >= p) & (u < 3 * p)).astype(
        jnp.float32))[:, None, None, None]
    model_in = jnp.concatenate([inp, jnp.repeat(cond[:, None], T, axis=1)], axis=-1)
    ids = jnp.tile(jnp.asarray([[cfg.fps, cfg.motion_bucket_id, cfg.train_noise_aug]],
                               jnp.float32), (2, 1))
    pred = jmod.apply(params, model_in, jedm.timesteps_from_sigmas(draws["sigmas"]), ehs, ids)
    return jedm.edm_loss(pred, noisy, latents, draws["sigmas"])


def _scaled_close(got, want, name):
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                               err_msg=name, **TOL)


def test_tiny_trans_train_step_matches_jax(tiny_trans):
    jmod, params, tconf = tiny_trans
    cfg = jts.SVDTrainConfig(conditioning_dropout_prob=DROPOUT, tie_stream_pairs=True)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(5)  # u = (0.96, 0.76)
    draws = _draws(key)
    u = np.asarray(draws["dropout_u"])
    # the y row keeps its CLIP embedding, so y_lora's to_v learns; its image is dropped
    assert u[1] >= 2 * DROPOUT and DROPOUT <= u[1] < 3 * DROPOUT, u

    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmod, p, batch, draws, cfg)))(params)
    # the JAX package's optimizer on those gradients, as its train step applies it
    optimizer = jts.make_optimizer(1e-3, trainable_predicate=jax_trainable)
    updates, _ = jax.jit(optimizer.update)(grads_j, optimizer.init(params), params)
    params_j = optax.apply_updates(params, updates)

    unet = _port_unet(params, tconf)
    state = tts.init_train_state(unet, tts.make_optimizer(
        1e-3, trainable_predicate=cli.trainable_trans))
    frozen = {n: p.detach().clone() for n, p in unet.named_parameters()
              if not cli.trainable_trans(n)}
    loss = tts.svd_loss(unet, {k: torch.from_numpy(v) for k, v in _batch().items()},
                        tts.SVDTrainConfig(conditioning_dropout_prob=DROPOUT,
                                           tie_stream_pairs=True),
                        **{k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    want = export_state_dict(grads_j, path_predicate=jax_trainable)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
           for n, p in state.trainables.items()}
    assert sorted(got) == sorted(want)
    unused = [n for n, p in state.trainables.items() if p.grad is None]
    # one key: attn2's softmax is 1, so its query and key get no gradient in either package
    assert unused and all(".attn2.to_q." in n or ".attn2.to_k." in n for n in unused)
    for name in want:
        if name in unused:
            assert not np.abs(want[name]).any(), name
        else:
            _scaled_close(got[name], want[name], name)

    state.optimizer.step()
    after = export_state_dict(params_j, path_predicate=jax_trainable)
    for name, p in state.trainables.items():
        _scaled_close(p.detach().numpy(), after[name], name)
    decayed = unused[0]
    assert not np.array_equal(after[decayed], export_state_dict(
        params, path_predicate=jax_trainable)[decayed])  # weight decay moved it in both
    for name, p in unet.named_parameters():
        if not cli.trainable_trans(name):
            assert torch.equal(p, frozen[name]), f"frozen {name} moved"


def test_tie_stream_pairs_draws_one_sigma_a_pair():
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["latents"] = torch.cat([batch["latents"]] * 2)
    batch["cond_latents"] = torch.cat([batch["cond_latents"]] * 2)
    batch["image_embeddings"] = torch.cat([batch["image_embeddings"]] * 2)
    seen = {}

    def spy(x, timesteps, *a, **k):
        seen["t"] = timesteps
        return x[..., :4] * 0

    tts.svd_loss(spy, batch, tts.SVDTrainConfig(tie_stream_pairs=True),
                 torch.Generator().manual_seed(1))
    t = seen["t"]
    assert t.shape == (4,) and t[0] == t[1] and t[2] == t[3] and t[0] != t[2]


def test_two_pairs_pair_row_0_with_row_2(tiny_trans):
    """[x0, y0, x1, y1] at mask (0, 1): the stream gates repeat block-wise and the partner
    streams swap the halves, so x0's joint partner is x1 in both packages; a change of y0
    leaves x0's output as it was. The port's CLI refuses such a batch."""
    jmod, params, tconf = tiny_trans
    apply = jax.jit(jmod.apply)
    unet = _port_unet(params, tconf)
    base = unet_inputs(4, seed=5)
    outs = {}
    for moved in (None, 1, 2):
        x = base[0].copy()
        if moved is not None:
            x[moved] += 1.0
        want = np.asarray(apply(params, x, *base[1:]))
        with torch.no_grad():
            got = unet(torch.from_numpy(x), *(torch.from_numpy(a) for a in base[1:])).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        outs[moved] = want
    assert np.abs(outs[2][0] - outs[None][0]).max() > 1e-4  # x1 moves x0
    np.testing.assert_array_equal(outs[1][0], outs[None][0])  # y0 does not
    with pytest.raises(NotImplementedError, match="one .* pair a step"):
        cli.build(_args("unused", "--mode", "trans", "--per-device-batch-size", "2"), TINY)


def test_cli_trans_builds_fits_and_exports_the_jax_names(tiny_trans, tmp_path):
    """``build`` + ``fit`` of ``--mode trans`` at tiny widths: the rows are [clip, flipped
    clip], the joint branch and every adapter move, the frozen weights do not, and the
    export holds the names the JAX package's export of the same UNet holds."""
    from safetensors.numpy import load_file

    from lkgd_tpu.training.trainer import export_trainable_safetensors as jax_export

    from lkgd_torch.training.trainer import export_trainable_safetensors

    from tests.test_torch_train_cli import _clip

    run = cli.build(_args(tmp_path / "run", "--mode", "trans", "--max-steps", "2"), TINY)
    assert run.trainable is cli.trainable_trans
    clip = _clip()["pixel_values"]
    batch = run.preprocess(clip, torch.Generator().manual_seed(0))
    assert sorted(batch) == ["cond_latents", "image_embeddings", "latents"]  # no ViT
    lat = batch["latents"]
    assert lat.shape == (2, T, 24, 24, 4)
    torch.testing.assert_close(lat[1], lat[0].flip(0), rtol=1e-5, atol=1e-5)
    before = {n: p.detach().clone() for n, p in run.unet.named_parameters()}
    run.trainer.fit(iter([{"pixel_values": clip}] * 2))
    trained = run.trainer.state.trainables
    moved = {n for n, p in trained.items() if not torch.equal(p, before[n])}
    assert any(".conv1n." in n for n in moved) and any("lora_y_lora" in n for n in moved)
    # all but the B factors of attn2's query and key, zero and without gradient (one key);
    # weight decay moves even their A factors
    still = {n for n in trained if n not in moved}
    assert still and all(".attn2.to_q.lora_y_lora_B" in n or ".attn2.to_k.lora_y_lora_B" in n
                         for n in still), sorted(still)
    for name, p in run.unet.named_parameters():
        if name not in trained:
            assert torch.equal(p, before[name]), f"frozen {name} moved"

    _, params, _ = tiny_trans
    n_j = jax_export(params, jax_trainable, str(tmp_path / "jax.safetensors"))
    n_t = export_trainable_safetensors(run.unet, run.trainable, str(tmp_path / "port.safetensors"))
    want = load_file(str(tmp_path / "jax.safetensors"))
    got = load_file(str(tmp_path / "port.safetensors"))
    assert n_t == n_j == len(want) > 0 and sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].shape == value.shape and got[name].dtype == value.dtype, name
