"""Depth-Anything in the port (``lkgd_torch.models.depth_anything``) against
``lkgd_tpu.models.depth_anything`` at fp32: ``bicubic_resize`` against the JAX package's on
up- and downscales; ``DepthAnythingConfig.tiny()`` at its native 28 x 28 and at 42 x 56 (the
position embedding resampled bicubically); a tiny-width config at ``image_size`` 462, whose
33^2 + 1 = 1090 tokens (2 heads of D=16) send the port's attention down the flash branch
(here, on the CPU, the plain version of the fp32 flash form; JAX's XLA attention); the
processor with its antialiased resizes. The JAX params are carried across by
``depth_anything_state_dict`` and loaded strictly; its reassemble transposed convolutions
are mirrored on the way, which the random kernels here check, as flax's transposed
convolution is torch's with the kernel mirrored (pinned here too); the names read back
by the JAX package's ``port_depth_anything``. Tolerance rtol 1e-4,
atol 2e-4 of the depth normalised by its largest value."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import depth_anything as J  # noqa: E402
from lkgd_tpu.ops.resize import bicubic_resize as jax_bicubic  # noqa: E402

from lkgd_torch.models import depth_anything as P  # noqa: E402
from lkgd_torch.ops import attention  # noqa: E402
from lkgd_torch.ops.resize import bicubic_resize  # noqa: E402
from lkgd_torch.utils.porting import depth_anything_state_dict  # noqa: E402
from tests.test_torch_porting import flatten, jit  # noqa: E402
from tests.test_torch_raft import close, random_params  # noqa: E402

FLASH = dict(image_size=462, patch_size=14, hidden_size=32, depth=4, num_heads=2,
             out_indices=(0, 1, 2, 3), neck_hidden_sizes=(8, 8, 16, 16),
             fusion_hidden_size=16, head_hidden_size=8)


def jax_params(cfg, seed: int = 7):
    x = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    params = random_params(jax.eval_shape(J.DepthAnything(cfg).init, jax.random.PRNGKey(0),
                                          x), seed)
    # a positive last bias keeps the final ReLU from zeroing the whole depth map
    params["params"]["head_conv3"]["bias"] = jnp.full((1,), 0.5)
    return params


def port_model(cfg, params):
    port = P.build_depth_anything(P.DepthAnythingConfig(**cfg.__dict__), device="cpu")
    port.load_state_dict(depth_anything_state_dict(flatten(params)), strict=True)
    return port


@pytest.fixture(scope="module")
def tiny():
    cfg = J.DepthAnythingConfig.tiny()
    params = jax_params(cfg)
    return cfg, params, port_model(cfg, params)


@pytest.mark.parametrize("src,dst", [((6, 6), (9, 13)), ((37, 37), (20, 31)),
                                     ((5, 8), (5, 8)), ((4, 4), (37, 37))])
def test_bicubic_resize(src, dst):
    x = np.random.default_rng(0).standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jax_bicubic(jnp.asarray(x), dst))
    got = bicubic_resize(torch.from_numpy(x), dst)
    assert tuple(got.shape) == want.shape == (2, *dst, 3)
    close(got, want, rtol=1e-5, atol=1e-5)


def _compare(cfg, params, port, hw, seed=1):
    x = np.random.default_rng(seed).standard_normal((1, *hw, 3)).astype(np.float32)
    want = np.asarray(jit(J.DepthAnything(cfg).apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, *hw)
    scale = np.abs(want).max()
    assert scale > 1e-3
    close(got.numpy() / scale, want / scale)


@pytest.mark.parametrize("hw", [(28, 28), (42, 56)])
def test_tiny_model(tiny, hw):
    _compare(*tiny, hw)


def test_flash_width(monkeypatch):
    cfg = J.DepthAnythingConfig(**FLASH)
    params = jax_params(cfg, seed=8)
    port = port_model(cfg, params)
    branches = []
    real = attention.use_flash
    monkeypatch.setattr(attention, "use_flash",
                        lambda q, k, mask: branches.append(real(q, k, mask)) or branches[-1])
    _compare(cfg, params, port, (462, 462))
    assert branches == [True] * 4 and attention.FLASH_MIN_SEQ <= 1090


@pytest.mark.parametrize("k", [4, 2])
def test_flax_transposed_kernel_is_mirrored(k):
    """flax's ``ConvTranspose`` (kernel = stride, the reassemble upsamples of the JAX module)
    is torch's ``ConvTranspose2d`` with the kernel flipped in both spatial axes: the reason
    ``depth_anything_state_dict`` flips it (ROADMAP.md Queue 3)."""
    import flax.linen as nn

    x = np.random.default_rng(4).standard_normal((1, 3, 3, 2)).astype(np.float32)
    conv = nn.ConvTranspose(3, (k, k), strides=(k, k))
    params = random_params(jax.eval_shape(conv.init, jax.random.PRNGKey(0), x), 9)
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    kernel = np.asarray(params["params"]["kernel"])  # (k, k, in, out)
    bias = torch.from_numpy(np.asarray(params["params"]["bias"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for flip, same in ((True, True), (False, False)):
        w = kernel[::-1, ::-1] if flip else kernel
        got = torch.nn.functional.conv_transpose2d(
            xt, torch.from_numpy(w.transpose(2, 3, 0, 1).copy()), bias, stride=k)
        assert np.allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5) == same


def test_names_are_hf_checkpoints(tiny):
    """The JAX package's ``port_depth_anything`` reads the port's state dict (HF's names)
    back to the JAX params, the reassemble kernels mirrored; the port holds HF's keys of
    ``hf_depth_anything_key_map`` and, beyond them, exactly the weights HF's model holds
    and never reads (``mask_token``, the deepest fusion layer's first residual unit)."""
    cfg, params, port = tiny
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    hf = set(J.hf_depth_anything_key_map(cfg))
    unit = "neck.fusion_stage.layers.0.residual_layer1"
    assert set(sd) - hf == {"backbone.embeddings.mask_token"} | {
        f"{unit}.{c}.{leaf}" for c in ("convolution1", "convolution2")
        for leaf in ("weight", "bias")} and hf <= set(sd)
    back, want = flatten(J.port_depth_anything(sd, cfg)), flatten(params)
    assert sorted(back) == sorted(want)
    for name, x in want.items():
        if "reassemble_0_resize/kernel" in name or "reassemble_1_resize/kernel" in name:
            x = x[::-1, ::-1]
        np.testing.assert_array_equal(back[name], x, err_msg=name)


def test_processor(tiny):
    cfg, params, port = tiny
    image = np.random.default_rng(3).uniform(size=(45, 61, 3)).astype(np.float32)
    want = np.asarray(J.make_depth_processor(params, cfg)(image))
    got = P.make_depth_processor(port)(image)
    assert got.shape == want.shape == (45, 61, 3) and got.dtype == np.float32
    close(got, want)
