"""The port's CogVideoX causal 3D VAE (``lkgd_torch.models.vae_cogvideox``) against
``lkgd_tpu.models.vae_cogvideox`` at fp32 on the CPU, on the same weights (every leaf
random): ``encode_mode`` and ``decode`` of a whole clip, the streaming ``chunked_decode``
and ``chunked_encode`` (held against JAX's: GroupNorm statistics are per chunk, so a
chunked decode is not the whole clip's), ``tiled_decode`` and ``tiled_encode`` with their
blend ramps, alone and over chunks; and the split of a convolution whose input or output
would pass 2^31 elements, against the unsplit call.

Tolerances: rtol 1e-4 / atol 2e-4 (fp32, convolutions summed in another order); the split
against the one call 1e-6 (the same sums, which the CPU's convolution may block differently
for another number of frames)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import vae_cogvideox as jvae  # noqa: E402

from lkgd_torch.models import vae_cogvideox as tvae  # noqa: E402
from lkgd_torch.models.configs import CogVideoXVAEConfig  # noqa: E402
from lkgd_torch.models.layers import materialize  # noqa: E402

from tests.test_torch_porting import port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
FRAMES, H, W = 9, 32, 48  # 3 latent frames of 8 x 12


@pytest.fixture(scope="module")
def vaes():
    """The tiny JAX VAE, random params, and the port's VAE with the same weights."""
    jmod = jvae.AutoencoderKLCogVideoX(jvae.CogVideoXVAEConfig.tiny())
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 1, H, W, 3))), seed=31, scale=0.1)
    port = materialize(lambda: tvae.AutoencoderKLCogVideoX(CogVideoXVAEConfig.tiny()), "cpu",
                       torch.float32)
    port.load_state_dict(port_state_dict(params), strict=True)
    return jmod, params, port.eval()


def _video(seed=0, frames=FRAMES):
    return np.random.default_rng(seed).uniform(-1, 1, size=(1, frames, H, W, 3)).astype(np.float32)


def _latents(seed=1):
    return np.random.default_rng(seed).normal(size=(1, 3, H // 4, W // 4, 4)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_config_matches_jax():
    import dataclasses

    assert (dataclasses.asdict(CogVideoXVAEConfig()) ==
            dataclasses.asdict(jvae.CogVideoXVAEConfig()))
    assert (dataclasses.asdict(CogVideoXVAEConfig.tiny()) ==
            dataclasses.asdict(jvae.CogVideoXVAEConfig.tiny()))


@pytest.mark.parametrize("frames", [1, FRAMES], ids=["image", "clip"])
def test_encode_mode_matches_jax(vaes, frames):
    jmod, params, port = vaes
    x = _video(frames=frames)
    want = jax.jit(lambda p, v: jmod.apply(p, v, method=jmod.encode_mode))(params, jnp.asarray(x))
    with torch.no_grad():
        _close(port.encode_mode(torch.from_numpy(x)), want)


def test_decode_matches_jax(vaes):
    jmod, params, port = vaes
    z = _latents()
    want = jax.jit(lambda p, v: jmod.apply(p, v, method=jmod.decode))(params, jnp.asarray(z))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    assert got.shape[1] == FRAMES
    _close(got, want)


@pytest.mark.parametrize("chunk", [1, 2])
def test_chunked_decode_matches_jax(vaes, chunk):
    jmod, params, port = vaes
    z = _latents()
    want = jvae.chunked_decode(jmod, params, jnp.asarray(z), chunk_latent_frames=chunk)
    with torch.no_grad():
        got = tvae.chunked_decode(port, torch.from_numpy(z), chunk_latent_frames=chunk)
        whole = port.decode(torch.from_numpy(z))
    _close(got, want)
    # GroupNorm's statistics are per chunk: not the whole clip's decode
    assert (got - whole).abs().max() > 1e-3


def test_chunked_encode_matches_jax(vaes):
    jmod, params, port = vaes
    x = _video()
    want = jvae.chunked_encode(jmod, params, jnp.asarray(x), chunk_frames=4)
    with torch.no_grad():
        _close(tvae.chunked_encode(port, torch.from_numpy(x), chunk_frames=4), want)
    with pytest.raises(ValueError, match="multiple"):
        tvae.chunked_encode(port, torch.from_numpy(x), chunk_frames=6)


@pytest.mark.parametrize("chunk", [None, 2], ids=["whole", "chunked"])
def test_tiled_decode_matches_jax(vaes, chunk):
    """4 x 6 latent tiles over 8 x 12 with overlap 0.25: two rows and three columns of
    tiles, the last ones moved inward."""
    jmod, params, port = vaes
    z = _latents()
    kw = dict(tile_latent_height=4, tile_latent_width=6, overlap=0.25, chunk_latent_frames=chunk)
    want = jvae.tiled_decode(jmod, params, jnp.asarray(z), **kw)
    with torch.no_grad():
        _close(tvae.tiled_decode(port, torch.from_numpy(z), **kw), want)


@pytest.mark.parametrize("chunk", [None, 4], ids=["whole", "chunked"])
def test_tiled_encode_matches_jax(vaes, chunk):
    jmod, params, port = vaes
    x = _video()
    kw = dict(tile_height=16, tile_width=24, overlap=0.25, chunk_frames=chunk)
    want = jvae.tiled_encode(jmod, params, jnp.asarray(x), **kw)
    with torch.no_grad():
        _close(tvae.tiled_encode(port, torch.from_numpy(x), **kw), want)


@pytest.mark.parametrize("cached", [False, True], ids=["whole_clip", "continuation"])
def test_convolutions_split_past_the_element_limit_exactly(vaes, monkeypatch, cached):
    """With the limit lowered to a few frames, every causal and per-frame convolution runs
    in several calls: the decode and encode equal the one-call results, the conv cache of a
    continuation chunk included."""
    assert tvae._runs(49, 480 * 720 * 128, 2) == 25  # the full decode's last level: 2 calls
    _, _, port = vaes
    z, x = torch.from_numpy(_latents()), torch.from_numpy(_video())
    with torch.no_grad():
        if cached:
            want = tvae.chunked_decode(port, z, chunk_latent_frames=2)
        else:
            want = (port.decode(z), port.encode_mode(x))
        monkeypatch.setattr(tvae, "MAX_ELEMENTS", 3 * 16 * 24 * 32)
        if cached:
            got = tvae.chunked_decode(port, z, chunk_latent_frames=2)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            for g, w in zip((port.decode(z), port.encode_mode(x)), want):
                torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
