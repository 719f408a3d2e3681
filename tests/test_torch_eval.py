"""The port's evaluation modules against the JAX package's: every metric function, the CLIP
feature extractor at tiny widths, InceptionV3 block by block at small sizes and whole at
299 on one image, I3D whole on a (1, 10, 64, 64, 3) clip, and the published key lists. The
JAX parameters reach the port through ``lkgd_torch.utils.porting.inception_state_dict`` /
``i3d_state_dict``. Tolerance: rtol 1e-4, atol 2e-4 at fp32 (features relative to their
largest magnitude where the nets' depth grows them); Frechet fits in float64 to 1e-6."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import lkgd_tpu.eval.fid_inception as jfi  # noqa: E402
import lkgd_tpu.eval.i3d as ji  # noqa: E402
import lkgd_tpu.eval.metrics as jm  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPConfig  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionModelWithProjection as JaxCLIP  # noqa: E402

from lkgd_torch.eval import fid_inception as tfi  # noqa: E402
from lkgd_torch.eval import i3d as ti  # noqa: E402
from lkgd_torch.eval import metrics as tm  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection  # noqa: E402
from lkgd_torch.utils.porting import (clip_key_map, from_flax_params, i3d_state_dict,  # noqa: E402
                                      inception_state_dict)
from tests.test_torch_porting import TINY_CLIP, jit, port_state_dict, randomize  # noqa: E402

RTOL, ATOL = 1e-4, 2e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _synthetic(init, seed: int, scale: float = 0.05) -> dict:
    """``init_synthetic``'s tree (its shapes traced once) with numpy values: convolution
    kernels normal x ``scale``, BatchNorm random around identity, biases small. Op by op
    the JAX ``init_synthetic`` compiles one program per shape (~20-50 s here)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, parent = path[-1].key, path[-2].key
        if parent == "bn":
            if name == "var":
                return (np.abs(rng.normal(size=x.shape)) + 0.5).astype(np.float32)
            base = 1.0 if name == "weight" else 0.0
            return (rng.normal(size=x.shape) * 0.1 + base).astype(np.float32)
        return (rng.normal(size=x.shape) * (scale if name == "kernel" else 0.1)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ metric functions
def test_pixel_metrics_and_clip_score():
    rng = np.random.default_rng(0)
    a, b = rng.random((2, 3, 12, 10, 3), dtype=np.float32)
    b = np.clip(a + 0.05 * b, 0, 1)
    _close(tm.psnr(_t(a), _t(b)), jm.psnr(jnp.asarray(a), jnp.asarray(b)))
    _close(tm.psnr(_t(a), _t(a)), jm.psnr(jnp.asarray(a), jnp.asarray(a)))  # the 1e-12 floor
    _close(tm.ssim(_t(a), _t(b)), jm.ssim(jnp.asarray(a), jnp.asarray(b)))
    _close(tm.ssim(_t(a * 255), _t(b * 255), 255.0),
           jm.ssim(jnp.asarray(a * 255), jnp.asarray(b * 255), 255.0))
    e1, e2 = rng.normal(size=(2, 5, 16)).astype(np.float32)
    _close(tm.clip_score(_t(e1), _t(e2)), jm.clip_score(jnp.asarray(e1), jnp.asarray(e2)))


@pytest.mark.parametrize("n", [40, 6], ids=["full_rank", "rank_deficient"])
def test_frechet_distances(n):
    rng = np.random.default_rng(n)
    fa, fb = rng.normal(size=(n, 8)), rng.normal(size=(n, 8)) * 1.3 + 0.2
    want = jm.frechet_distance(fa, fb)
    assert tm.frechet_distance(fa, fb) == pytest.approx(want, rel=1e-6, abs=1e-6)
    assert tm.fid_from_features(_t(fa), _t(fb)) == pytest.approx(jm.fid_from_features(fa, fb),
                                                                 rel=1e-6, abs=1e-6)
    assert tm.fvd_from_features(fa, fb) == pytest.approx(jm.fvd_from_features(fa, fb),
                                                         rel=1e-6, abs=1e-6)


def test_aesthetic_mlp():
    params = _np(jm.AestheticMLP.init(jax.random.PRNGKey(3), in_dim=32))
    params = {k: {"kernel": v["kernel"], "bias": v["bias"] + 0.01} for k, v in params.items()}
    mlp = tm.AestheticMLP(in_dim=32)
    mlp.load_state_dict(from_flax_params(
        {f"{k}/{leaf}": v[leaf] for k, v in params.items() for leaf in v}), strict=True)
    x = np.random.default_rng(1).normal(size=(4, 32)).astype(np.float32)
    _close(mlp(_t(x)), jm.AestheticMLP.apply(params, jnp.asarray(x)))
    mlp.init_params(torch.Generator().manual_seed(0))
    assert [tuple(l.weight.shape) for l in mlp.layers] == [(1024, 32), (128, 1024), (64, 128),
                                                           (16, 64), (1, 16)]


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_depth_metrics(masked):
    rng = np.random.default_rng(2)
    gt = rng.random((2, 9, 11)).astype(np.float32) + 0.5
    pred = (gt * 1.7 + 0.3 + 0.05 * rng.normal(size=gt.shape)).astype(np.float32)
    mask = (rng.random(gt.shape) > 0.3) if masked else None
    tmask = None if mask is None else _t(mask)
    jmask = None if mask is None else jnp.asarray(mask)
    for got, want in zip(tm.align_depth_least_square(_t(pred), _t(gt), tmask),
                         jm.align_depth_least_square(jnp.asarray(pred), jnp.asarray(gt), jmask)):
        _close(got, want)
    for align in (True, False):
        got = tm.depth_metrics(_t(pred), _t(gt), tmask, align)
        want = jm.depth_metrics(jnp.asarray(pred), jnp.asarray(gt), jmask, align)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=RTOL, abs=ATOL), k


def test_clip_feature_extractor():
    clip = JaxCLIP(JaxCLIPConfig(**TINY_CLIP), dtype=jnp.float32)
    params = randomize(jax.eval_shape(lambda: clip.init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 32, 32, 3)))), seed=5)
    port = CLIPVisionModelWithProjection(tcfg.CLIPVisionConfig(**TINY_CLIP))
    port.load_state_dict(port_state_dict(params, clip_key_map), strict=True)
    images = np.random.default_rng(3).random((3, 40, 44, 3)).astype(np.float32)
    got = tm.make_clip_feature_extractor(port.eval())(_t(images))
    _close(got, jm.make_clip_feature_extractor(clip, params)(jnp.asarray(images)))
    _close(torch.linalg.vector_norm(got, dim=-1), np.ones(3))


# ------------------------------------------------------------------ InceptionV3
@pytest.fixture(scope="module")
def inception():
    params = _synthetic(jfi.init_synthetic, 1)
    model = tfi.InceptionV3().eval()
    model.load_state_dict(inception_state_dict(params), strict=True)
    return params, model


@pytest.mark.parametrize("block,shape,fn", [
    ("Mixed_5b", (1, 9, 9, 192), lambda p, x: jfi._inception_a(p, x)),
    ("Mixed_6a", (1, 9, 9, 288), lambda p, x: jfi._inception_b(p, x)),
    ("Mixed_6b", (1, 7, 7, 768), lambda p, x: jfi._inception_c(p, x)),
    ("Mixed_7a", (1, 9, 9, 768), lambda p, x: jfi._inception_d(p, x)),
    ("Mixed_7b", (1, 5, 5, 1280), lambda p, x: jfi._inception_e(p, x, "avg")),
    ("Mixed_7c", (1, 5, 5, 2048), lambda p, x: jfi._inception_e(p, x, "max")),
], ids=["A", "B", "C", "D", "E_avg", "E_max"])
def test_inception_blocks(inception, block, shape, fn):
    params, model = inception
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = jit(fn)(params[block], jnp.asarray(x))
    with torch.no_grad():
        got = getattr(model, block)(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)


def test_inception_whole_at_299(inception):
    """One image at 299 (no resize) and the resize path's preprocess on another size."""
    params, model = inception
    image = np.random.default_rng(5).random((1, 299, 299, 3)).astype(np.float32)
    want = np.asarray(jit(jfi.inception_v3_features)(params, jnp.asarray(image)))
    got = model(_t(image))
    assert got.shape == (1, 2048)
    _close(got / np.abs(want).max(), want / np.abs(want).max())
    small = np.random.default_rng(6).random((2, 40, 52, 3)).astype(np.float32)
    _close(tfi.preprocess(_t(small)), jit(jfi.preprocess)(jnp.asarray(small)))


def test_inception_keys_and_pytorch_fid_state_dict(inception):
    params, _ = inception
    model = tfi.InceptionV3()
    assert list(model.state_dict()) == jfi.expected_torch_keys()
    sd = dict(inception_state_dict(params))
    # a pytorch-fid checkpoint also holds the 1008-way fc and BatchNorm counters
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    sd["Mixed_5b.branch1x1.bn.num_batches_tracked"] = torch.tensor(0)
    tfi.load_torch_state_dict(model, sd)
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(RuntimeError, match="Missing key"):
        tfi.load_torch_state_dict(model, sd)


# ------------------------------------------------------------------ I3D
def test_i3d_whole_and_keys():
    params = _synthetic(ji.init_synthetic, 2)
    model = ti.InceptionI3d().eval()
    assert list(model.state_dict()) == ji.expected_torch_keys()
    model.load_state_dict(i3d_state_dict(params), strict=True)
    video = np.random.default_rng(7).random((1, 10, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jit(ji.i3d_features)(params, jnp.asarray(video)))
    got = model(_t(video))
    assert got.shape == (1, 400)
    _close(got, want)
    sd = dict(i3d_state_dict(params))
    sd["logits.conv3d.bias"] = sd["logits.conv3d.bias"][:10]
    with pytest.raises(RuntimeError, match="size mismatch"):
        ti.load_torch_state_dict(model, sd)


def test_same_padding_is_tensorflows():
    x = torch.zeros(1, 1, 9, 10, 11)
    # out = ceil(n / s); the smaller half of the padding goes before
    assert ti.same_pad(x, (3, 3, 3), (2, 2, 2)).shape == (1, 1, 11, 11, 13)
    assert ti.same_pad(x, (7, 7, 7), (2, 2, 2)).shape == (1, 1, 15, 15, 17)
    y = ti.same_pad(torch.ones(1, 1, 1, 1, 4), (1, 1, 3), (1, 1, 2))
    assert y[0, 0, 0, 0].tolist() == [1.0, 1.0, 1.0, 1.0, 0.0]
