"""The port's modules against their ``lkgd_tpu`` counterparts at fp32 on the same weights
(random normals, carried over by the numpy porter and loaded with strict=True): the
attention layers with their single-key shortcuts, the spatio-temporal resblock, and the
tiny UNet, VAE (encode_mode and decode) and CLIP of the end-to-end test. Tolerance rtol
1e-4, atol 2e-4, as the JAX package's own torch-oracle tests: fp32 rounding summed in
another order through composed graphs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import blocks_svd as jblocks  # noqa: E402
from lkgd_tpu.models import layers as jlayers  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPConfig  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionModelWithProjection as JaxCLIP  # noqa: E402
from lkgd_tpu.models.configs import SVDUNetConfig as JaxUNetConfig  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JaxVAE  # noqa: E402
from lkgd_tpu.models.vae_temporal import TemporalVAEConfig as JaxVAEConfig  # noqa: E402

from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models import layers as tlayers  # noqa: E402
from lkgd_torch.models.blocks_svd import SpatioTemporalResBlock  # noqa: E402
from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder  # noqa: E402
from lkgd_torch.utils.porting import clip_key_map, vae_key_map  # noqa: E402

from tests.test_torch_porting import (TINY_CLIP, TINY_UNET, TINY_VAE,  # noqa: E402
                                      port_state_dict, randomize)

TOL = dict(rtol=1e-4, atol=2e-4)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(jax_module, torch_factory, *init_args, key_map=None, seed=11, **init_kw):
    """Random params for ``jax_module`` and the port module holding the same weights."""
    shapes = jax.eval_shape(lambda *a: jax_module.init(jax.random.PRNGKey(0), *a, **init_kw),
                            *init_args)
    params = randomize(shapes, seed=seed)
    port = tlayers.materialize(torch_factory, "cpu", torch.float32)
    port.load_state_dict(port_state_dict(params, key_map), strict=True)
    return params, port


def _apply(jax_module, params, *args, **static):
    """The JAX module's output, jitted (one compile beats op-by-op dispatch on the CPU);
    ``static`` keywords are closed over."""
    fn = jax.jit(lambda p, *a: jax_module.apply(p, *a, **static))
    return np.asarray(fn(params, *(jnp.asarray(a) for a in args)))


def _run(port, *args, **kw):
    with torch.no_grad():
        return port(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args),
                    **kw).numpy()


@pytest.mark.parametrize("ctx_len", [None, 1, 5], ids=["self", "single_key", "cross"])
def test_attention(ctx_len):
    rng = np.random.default_rng(0)
    x = _np(rng, 2, 40, 32)
    ctx = None if ctx_len is None else _np(rng, 2, ctx_len, 24)
    kv = None if ctx_len is None else 24
    jmod = jlayers.Attention(32, heads=2, dim_head=16, kv_dim=kv)
    args = (x,) if ctx is None else (x, ctx)
    params, port = _pair(jmod, lambda: tlayers.Attention(32, 2, 16, kv_dim=kv),
                         *(jnp.asarray(a) for a in args))
    want = _apply(jmod, params, *args)
    got = _run(port, *args)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ctx_len", [None, 1], ids=["frames", "single_key"])
def test_frame_axis_attention(ctx_len):
    rng = np.random.default_rng(1)
    b, t, hw = 2, 4, 6
    x = _np(rng, b * t, hw, 32)
    kv = None if ctx_len is None else 24
    jmod = jlayers.FrameAxisAttention(32, heads=2, dim_head=16, kv_dim=kv)
    kw = dict(num_frames=t)
    if ctx_len is not None:
        kw.update(encoder_hidden_states=_np(rng, b, ctx_len, 24), per_sample_ctx=True)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    params, port = _pair(jmod, lambda: tlayers.FrameAxisAttention(32, 2, 16, kv_dim=kv),
                         jnp.asarray(x), **jkw)
    want = _apply(jmod, params, x, **jkw)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    np.testing.assert_allclose(_run(port, x, **tkw), want, **TOL)


@pytest.mark.parametrize("ctx_len", [1, 3], ids=["single_key", "three_keys"])
def test_frame_axis_attention_per_sample_context_with_lora(ctx_len):
    """A per-sample context of L tokens, LoRA adapters on ``to_k`` and ``to_v``: L = 3 takes
    the softmax over the sample's keys, L = 1 the shortcut (the control)."""
    rng = np.random.default_rng(5)
    b, t, hw = 2, 3, 5
    x, ctx = _np(rng, b * t, hw, 32), _np(rng, b, ctx_len, 24)
    spec = dict(name="ctx", rank=2, alpha=3.0)
    jmod = jlayers.FrameAxisAttention(32, heads=2, dim_head=16, kv_dim=24,
                                      adapters_k=(jlayers.LoraSpec(**spec),),
                                      adapters_v=(jlayers.LoraSpec(**spec),))
    adapters = {"to_k": (tlayers.LoraSpec(**spec),), "to_v": (tlayers.LoraSpec(**spec),)}
    kw = dict(num_frames=t, per_sample_ctx=True)
    params, port = _pair(jmod, lambda: tlayers.FrameAxisAttention(32, 2, 16, kv_dim=24,
                                                                  adapters=adapters),
                         jnp.asarray(x), encoder_hidden_states=jnp.asarray(ctx), **kw)
    assert {"to_k.ctx_A", "to_v.ctx_B"} <= {n.replace("lora_", "") for n in port.state_dict()}
    want = _apply(jmod, params, x, encoder_hidden_states=jnp.asarray(ctx), **kw)
    got = _run(port, x, kw["num_frames"], torch.from_numpy(ctx), per_sample_ctx=True)
    assert got.shape == (b * t, hw, 32)
    np.testing.assert_allclose(got, want, **TOL)
    # the output varies over frames and pixels exactly when there is more than one key
    varies = np.abs(got - got[:1, :1]).reshape(b, -1).max(axis=1)
    assert (varies > 1e-3).all() if ctx_len > 1 else (varies[0] < 1e-6)


@pytest.mark.parametrize("cin", [32, 64])
def test_spatio_temporal_res_block(cin):
    rng = np.random.default_rng(2)
    b, t = 2, 3
    x = _np(rng, b * t, 6, 5, cin)
    temb = _np(rng, b * t, 40)
    ind = np.zeros((b, t), np.float32)
    jmod = jblocks.SpatioTemporalResBlock(64, temb_channels=40, eps=1e-5)
    jargs = (jnp.asarray(x), jnp.asarray(temb), jnp.asarray(ind))
    params, port = _pair(jmod, lambda: SpatioTemporalResBlock(cin, 64, 40, 1e-5), *jargs)
    want = _apply(jmod, params, x, temb, ind)
    np.testing.assert_allclose(_run(port, x, temb, ind), want, **TOL)


def test_tiny_unet():
    rng = np.random.default_rng(3)
    b, t, h, w = 2, 4, 8, 8
    sample = _np(rng, b, t, h, w, 8)
    timesteps = np.array([0.3, -1.2], np.float32)
    ehs = _np(rng, b, 1, 64)
    ids = np.array([[6, 127, 0.02], [6, 127, 0.02]], np.float32)
    jmod = JaxUNet(JaxUNetConfig(**TINY_UNET), dtype=jnp.float32)
    jargs = tuple(jnp.asarray(a) for a in (sample, timesteps, ehs, ids))
    params, port = _pair(jmod, lambda: UNetSpatioTemporalCondition(
        tcfg.SVDUNetConfig(**TINY_UNET)), *jargs)
    want = _apply(jmod, params, sample, timesteps, ehs, ids)
    np.testing.assert_allclose(_run(port, sample, timesteps, ehs, ids), want, **TOL)


def test_tiny_unet_three_token_context():
    """An ``encoder_hidden_states`` of 3 tokens: the spatial cross-attention and the
    temporal blocks' per-sample context both attend over the 3 keys."""
    rng = np.random.default_rng(6)
    b, t, h, w = 2, 4, 8, 8
    sample = _np(rng, b, t, h, w, 8)
    timesteps = np.array([0.3, -1.2], np.float32)
    ehs = _np(rng, b, 3, 64)
    ids = np.array([[6, 127, 0.02], [6, 127, 0.02]], np.float32)
    jmod = JaxUNet(JaxUNetConfig(**TINY_UNET), dtype=jnp.float32)
    jargs = tuple(jnp.asarray(a) for a in (sample, timesteps, ehs, ids))
    params, port = _pair(jmod, lambda: UNetSpatioTemporalCondition(
        tcfg.SVDUNetConfig(**TINY_UNET)), *jargs)
    want = _apply(jmod, params, sample, timesteps, ehs, ids)
    got = _run(port, sample, timesteps, ehs, ids)
    np.testing.assert_allclose(got, want, **TOL)
    # the 3 tokens are not one: the first token alone, repeated, gives another output
    alone = _run(port, sample, timesteps, np.repeat(ehs[:, :1], 3, axis=1), ids)
    assert np.abs(alone - got).max() > 1e-3


def test_tiny_vae_encode_and_decode():
    rng = np.random.default_rng(4)
    t = 3
    x = _np(rng, t, 32, 32, 3, scale=0.5)
    z = _np(rng, t, 16, 16, 4)
    jmod = JaxVAE(JaxVAEConfig(**TINY_VAE), dtype=jnp.float32)
    params, port = _pair(jmod, lambda: AutoencoderKLTemporalDecoder(
        tcfg.TemporalVAEConfig(**TINY_VAE)), jnp.asarray(x), num_frames=t, key_map=vae_key_map)
    want_mode = _apply(jmod, params, x, method=JaxVAE.encode_mode)
    want_dec = _apply(jmod, params, z, num_frames=t, method=JaxVAE.decode)
    with torch.no_grad():
        got_mode = port.encode_mode(torch.from_numpy(x)).numpy()
        got_dec = port.decode(torch.from_numpy(z), t).numpy()
    np.testing.assert_allclose(got_mode, want_mode, **TOL)
    np.testing.assert_allclose(got_dec, want_dec, **TOL)


def test_tiny_clip():
    rng = np.random.default_rng(5)
    pixels = _np(rng, 2, 32, 32, 3)
    jmod = JaxCLIP(JaxCLIPConfig(**TINY_CLIP), dtype=jnp.float32)
    params, port = _pair(jmod, lambda: CLIPVisionModelWithProjection(
        tcfg.CLIPVisionConfig(**TINY_CLIP)), jnp.asarray(pixels), key_map=clip_key_map)
    want = _apply(jmod, params, pixels)
    np.testing.assert_allclose(_run(port, pixels), want, **TOL)

