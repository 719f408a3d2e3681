"""Flow-video training in the port (``lkgd_torch.training.flow``,
``lkgd_torch.data.datasets.FramesFlowDataset``) against ``lkgd_tpu`` at fp32:

* ``make_flow_batch_fn`` in "of" and "of_fix" at 32x32 (3 frames, 2 clips), the tiny UniMatch
  (``tests/test_torch_unimatch.py``) and the tiny VAE of ``tests/test_training_flow.py``
  (factor 4), every parameter random, with the normal JAX draws from the step's key
  injected as ``noise=``;
* ``make_joint_vf_batch`` at one clip, and its refusal of two;
* an "of_fix" train step on that batch through the dual-``conv_in`` UNet of
  ``tests/test_torch_flow.py`` (``in_channels=12``), its input convolutions trained: the
  loss and gradients against ``jax.value_and_grad`` of the JAX step's loss with its draws,
  and the trained tensors after one step against the JAX package's own step;
* ``FramesFlowDataset`` against the JAX class on a folder of PNGs and ``.flo`` files.

Tolerance rtol 1e-4, atol 2e-4 (gradients and parameters after scaling each by its largest
entry)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.data import datasets as jax_datasets  # noqa: E402
from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models import unimatch as J  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JaxVAE  # noqa: E402
from lkgd_tpu.models.vae_temporal import TemporalVAEConfig as JaxVAEConfig  # noqa: E402
from lkgd_tpu.training import edm as jedm  # noqa: E402
from lkgd_tpu.training import flow as jflow  # noqa: E402
from lkgd_tpu.training import train_state as jts  # noqa: E402
from lkgd_tpu.utils import optical_flow as jax_of  # noqa: E402

from lkgd_torch.data import datasets as port_datasets  # noqa: E402
from lkgd_torch.data.video_io import write_flo  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder  # noqa: E402
from lkgd_torch.training import flow as tflow  # noqa: E402
from lkgd_torch.training import train_state as tts  # noqa: E402
from lkgd_torch.utils import optical_flow as port_of  # noqa: E402
from lkgd_torch.utils.porting import vae_key_map  # noqa: E402

from tests.test_torch_flow import FIX  # noqa: E402
from tests.test_torch_porting import port_state_dict, randomize  # noqa: E402
from tests.test_torch_unimatch import _models  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
B, S, FRAMES = 2, 32, 3
T, LAT = FRAMES - 1, S // 4
VAE = dict(block_out_channels=(32, 64, 64), layers_per_block=1)
KEY = jax.random.PRNGKey(5)


def close(got, want, err=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=err, **TOL)


def _scaled_close(got, want, name):
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                               err_msg=name, **TOL)


def _inputs():
    rng = np.random.default_rng(51)
    # a drifting gradient, so that UniMatch has something to match
    y, x = np.mgrid[:S, :S] / S
    frames = np.stack([np.stack([np.sin(6 * x + 0.4 * i + c) * np.cos(4 * y - 0.3 * i)
                                 for c in range(3)], -1) for i in range(FRAMES)])
    frames = np.stack([frames, frames[:, ::-1]]) * 0.8 + rng.uniform(-0.1, 0.1,
                                                                      (B, FRAMES, S, S, 3))
    emb = rng.standard_normal((B, 1, 32))
    return frames.astype(np.float32), emb.astype(np.float32)


@pytest.fixture(scope="module")
def flow_batches():
    """The JAX and port batches of both modes, on the same UniMatch, VAE and noise."""
    img = jnp.zeros((1, S, S, 3))
    um_params, _, um = _models("flow", 52, img, img)
    jvae = JaxVAE(JaxVAEConfig(**VAE))
    vae_params = randomize(jax.eval_shape(lambda: jvae.init(jax.random.PRNGKey(1), img,
                                                            num_frames=1)), seed=53, scale=0.1)
    vae = AutoencoderKLTemporalDecoder(tcfg.TemporalVAEConfig(**VAE)).eval()
    vae.load_state_dict(port_state_dict(vae_params, vae_key_map), strict=True)
    jflow_fn = jax_of.make_flow_fn(J.UniMatch(J.UniMatchConfig.tiny()), um_params, (S, S))
    frames, emb = _inputs()
    noise = jax.random.normal(KEY, (B, S, S, 3), jnp.float32)  # the draw of flow.py:60
    out = {}
    for mode in ("of", "of_fix"):
        want = jflow.make_flow_batch_fn(jflow_fn, jvae, mode)(
            vae_params, jnp.asarray(frames), jnp.asarray(emb), KEY)
        got = tflow.make_flow_batch_fn(port_of.make_flow_fn(um, (S, S)), vae, mode)(
            torch.from_numpy(frames), torch.from_numpy(emb), noise=torch.tensor(np.asarray(noise)))
        out[mode] = (got, want)
    out["port_of"] = (tflow.make_flow_batch_fn(port_of.make_flow_fn(um, (S, S)), vae, "of"),
                      torch.from_numpy(frames), torch.from_numpy(emb))
    return out


@pytest.mark.parametrize("mode", ["of", "of_fix"])
def test_flow_batch_matches_jax(flow_batches, mode):
    got, want = flow_batches[mode]
    assert sorted(got) == sorted(want)
    assert got["latents"].shape == (B, T, LAT, LAT, 4)
    assert got["cond_latents"].shape == (B, LAT, LAT, 8 if mode == "of_fix" else 4)
    for key in want:
        assert got[key].dtype == torch.float32
        close(got[key], want[key], key)
    # the two clips' flows differ (flow images are flow / 50 around 0.5: small moves)
    assert (got["latents"][0] - got["latents"][1]).abs().max() > 3e-3


def test_flow_batch_draws_from_its_generator(flow_batches):
    """Without ``noise`` the conditioning frame's noise comes from the generator: one seed,
    one batch; another seed moves the condition and nothing else. An unknown mode is
    refused."""
    prep, frames, emb = flow_batches["port_of"]
    a, b, c = (prep(frames, emb, torch.Generator().manual_seed(seed)) for seed in (1, 1, 2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["latents"], c["latents"])
    assert not torch.equal(a["cond_latents"], c["cond_latents"])
    with pytest.raises(ValueError, match="of_fix"):
        tflow.make_flow_batch_fn(lambda f: f, None, "flow")


def test_joint_vf_batch_and_its_two_pair_refusal():
    rng = np.random.default_rng(54)
    v, f = (rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    emb = rng.standard_normal((1, 1, 8)).astype(np.float32)
    want = jflow.make_joint_vf_batch(jnp.asarray(v), jnp.asarray(f), jnp.asarray(emb))
    got = tflow.make_joint_vf_batch(torch.from_numpy(v), torch.from_numpy(f),
                                    torch.from_numpy(emb))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert torch.equal(got["latents"][0], torch.from_numpy(v[0]))
    assert torch.equal(got["latents"][1], torch.from_numpy(f[0]))
    two = torch.from_numpy(np.concatenate([v, f]))
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tflow.make_joint_vf_batch(two, two, torch.from_numpy(np.concatenate([emb, emb])))


def trained(name: str) -> bool:
    """The input convolutions of the flow UNet (JAX paths and the port's names alike)."""
    return "conv_in" in name


def _draws(key):
    """The sigmas, noise and dropout uniforms the JAX SVD step draws from ``key``."""
    r_sigma, r_noise, r_drop1, _ = jax.random.split(key, 4)
    return {"sigmas": jedm.rand_cosine_interpolated(r_sigma, (B,)),
            "noise": jax.random.normal(r_noise, (B, T, LAT, LAT, 4), jnp.float32),
            "dropout_u": jax.random.uniform(r_drop1, (B,))}


def _jax_loss(jmod, params, batch, draws, cfg):
    """The loss of ``lkgd_tpu.training.train_state.make_svd_train_step`` with its draws
    given."""
    latents = batch["latents"]
    noisy, inp = jedm.precondition_inputs(latents, draws["noise"], draws["sigmas"])
    p, u = cfg.conditioning_dropout_prob, draws["dropout_u"]
    ehs = jnp.where((u < 2 * p)[:, None, None], 0.0, batch["image_embeddings"])
    cond = batch["cond_latents"] * (1.0 - ((u >= p) & (u < 3 * p)).astype(
        jnp.float32))[:, None, None, None]
    model_in = jnp.concatenate([inp, jnp.repeat(cond[:, None], T, axis=1)], axis=-1)
    ids = jnp.tile(jnp.asarray([[cfg.fps, cfg.motion_bucket_id, cfg.train_noise_aug]],
                               jnp.float32), (B, 1))
    pred = jmod.apply(params, model_in, jedm.timesteps_from_sigmas(draws["sigmas"]), ehs, ids)
    return jedm.edm_loss(pred, noisy, latents, draws["sigmas"])


def test_of_fix_train_step_matches_jax(flow_batches):
    """The "of_fix" batch (8 conditioning channels: a 12-channel UNet input) through the
    dual-``conv_in`` UNet, every parameter random, ``conv_in``, ``conv_in2`` and its alpha
    trained; dropout draws that act on one clip each."""
    got_batch, want_batch = flow_batches["of_fix"]
    jmod = JaxUNet(jcfg.SVDUNetConfig(**FIX))
    args = (jnp.zeros((B, T, LAT, LAT, 12)), jnp.zeros((B,)), want_batch["image_embeddings"],
            jnp.ones((B, 3)))
    params = randomize(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args)),
                       seed=55, scale=0.1)
    cfg = jts.SVDTrainConfig(conditioning_dropout_prob=0.3)
    key = jax.random.PRNGKey(3)
    draws = _draws(key)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmod, p, want_batch, draws, cfg)))(params)
    optimizer = jts.make_optimizer(1e-3, trainable_predicate=trained)
    state_j, loss_step_j = jax.jit(jts.make_svd_train_step(jmod, optimizer, cfg))(
        jts.init_train_state(params, optimizer), want_batch, key)
    np.testing.assert_allclose(float(loss_step_j), float(loss_j), rtol=1e-6)

    unet = UNetSpatioTemporalCondition(tcfg.SVDUNetConfig(**FIX))
    unet.load_state_dict(port_state_dict(params), strict=True)
    state = tts.init_train_state(unet, tts.make_optimizer(1e-3, trainable_predicate=trained))
    assert sorted(state.trainables) == ["conv_in.bias", "conv_in.weight", "conv_in2.bias",
                                        "conv_in2.weight", "conv_in2_alpha"]
    frozen = {n: p.detach().clone() for n, p in unet.named_parameters() if not trained(n)}
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in state.trainables.items()]
    step = tts.make_svd_train_step(tts.SVDTrainConfig(conditioning_dropout_prob=0.3))
    state, loss = step(state, got_batch, **{k: torch.tensor(np.asarray(v))
                                            for k, v in draws.items()})
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    want_grads = port_state_dict(grads_j)
    assert sorted(grads) == sorted(state.trainables)
    for name, g in grads.items():
        _scaled_close(g.numpy(), want_grads[name].numpy(), name)
    after = port_state_dict(state_j.params)
    for name, p in state.trainables.items():
        _scaled_close(p.detach().numpy(), after[name].numpy(), name)
        assert not torch.equal(p, port_state_dict(params)[name]), name
    for name, p in unet.named_parameters():
        if not trained(name):
            assert torch.equal(p, frozen[name]), f"frozen {name} moved"


def test_frames_flow_dataset_matches_jax(tmp_path):
    """Two sequences of 5 PNG frames, one with 4 ``.flo`` flows; ``sample_n_frames`` equal to
    the folder's length, so that the JAX class's unseeded start is 0."""
    from PIL import Image

    rng = np.random.default_rng(56)
    for seq in ("bear", "car"):
        (tmp_path / "frames" / seq).mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)).save(
                tmp_path / "frames" / seq / f"{i:05d}.png")
    (tmp_path / "flow" / "bear").mkdir(parents=True)
    for i in range(4):
        write_flo(str(tmp_path / "flow" / "bear" / f"{i:05d}.flo"),
                  (rng.standard_normal((20, 28, 2)) * 6).astype(np.float32))
    kw = dict(flow_root=str(tmp_path / "flow"), sample_size=(16, 24), sample_n_frames=5)
    ours = port_datasets.FramesFlowDataset(str(tmp_path / "frames"), **kw)
    theirs = jax_datasets.FramesFlowDataset(str(tmp_path / "frames"), **kw)
    assert len(ours) == len(theirs) == 2
    for idx in range(2):
        got, want = ours[idx], theirs[idx]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{idx} {key}")
    assert ours[0]["pixel_values"].shape == (5, 16, 24, 3)
    assert ours[0]["flow"].shape == (4, 20, 28, 2) and "flow" not in ours[1]
    assert 127 <= int(ours[0]["motion_bucket_id"]) <= 300
    with pytest.raises(FileNotFoundError):
        port_datasets.FramesFlowDataset(str(tmp_path / "flow" / "bear"))
