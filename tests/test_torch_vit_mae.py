"""The port's knowledge encoder (``lkgd_torch.models.vit_mae``) against ``lkgd_tpu`` at fp32
on the same weights: the tiny ViT, its timm parameter names, and
``encode_knowledge_features``, whose resize to the ViT's input size downsamples with
``jax.image.resize``'s antialiased bilinear kernel (the port's ``resize_bilinear``).
Tolerance rtol 1e-4, atol 2e-4, as the other torch-oracle tests."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import vit_mae as jvit  # noqa: E402
from lkgd_tpu.utils.porting import export_state_dict  # noqa: E402

from lkgd_torch.models import vit_mae as tvit  # noqa: E402
from lkgd_torch.models.layers import materialize  # noqa: E402
from lkgd_torch.ops.resize import resize_bilinear  # noqa: E402
from lkgd_torch.utils.porting import vit_key_map  # noqa: E402

from tests.test_torch_porting import port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)


@pytest.fixture(scope="module")
def tiny_vit():
    jmod = jvit.ViT(jvit.ViTConfig.tiny())
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 32, 3))), seed=6)
    port = materialize(lambda: tvit.ViT(tvit.ViTConfig.tiny()), "cpu", torch.float32)
    port.load_state_dict(port_state_dict(params, vit_key_map), strict=True)
    return jmod, params, port


def test_port_names_are_timm_names(tiny_vit):
    """The export of the JAX ViT maps back to our names through timm_vit_key_map."""
    _, params, port = tiny_vit
    names = sorted(port.state_dict())
    assert "patch_embed.proj.weight" in names and "blocks.1.attn.qkv.weight" in names
    assert "blocks.0.mlp.fc2.bias" in names and "head.weight" in names
    exported = export_state_dict(params)
    assert sorted(jvit.timm_vit_key_map(vit_key_map(k)) for k in exported) == sorted(exported)


def test_tiny_vit(tiny_vit):
    jmod, params, port = tiny_vit
    x = np.random.default_rng(7).normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 48)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", [48, 32, 20], ids=["downsample", "same", "upsample"])
def test_encode_knowledge_features(tiny_vit, size):
    jmod, params, port = tiny_vit
    frames = np.random.default_rng(8).uniform(-1, 1, size=(2, 3, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jvit.encode_knowledge_features(jmod, params, jnp.asarray(frames)))
    with torch.no_grad():
        got = tvit.encode_knowledge_features(port, torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 1, 48)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape,size", [((2, 512, 512, 3), (384, 384)),
                                        ((1, 50, 40, 3), (20, 32))])
def test_resize_bilinear_matches_jax_image_resize(shape, size):
    """Antialiased downsampling (512 -> 384, as the knowledge encoder at 512x512), and a mix
    of down- and upsampling; F.interpolate's bilinear mode does not antialias. JAX places
    the kernel taps in fp32, the port in float64: TOL."""
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, 3), method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=size,
                                            mode="bilinear", align_corners=False)
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2
