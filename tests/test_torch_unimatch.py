"""UniMatch in the port (``lkgd_torch.models.unimatch``, ``lkgd_torch.utils.optical_flow``,
``lkgd_torch.utils.motion``) against ``lkgd_tpu`` at fp32: every functional helper on the
same inputs; each module with the JAX params carried across by
``lkgd_torch.utils.porting.unimatch_state_dict`` and loaded strictly; the tiny model end to
end on the flow (atol 1e-3 px), stereo and depth tasks; the flow wrappers at 30x44 (padded to
32x48 and resized back), the bidirectional, stereo and depth wrappers; the motion helpers.
Tolerance rtol 1e-4, atol 2e-4 unless a line says otherwise: the wrappers' flow and
disparity at atol 1e-3 px, since ``jax.image.resize`` of the 0-255 frames is 2.3e-6 of full
scale from the float64 result (the port's ``resize_bilinear`` 9e-8), and the random tiny
model carries that into its pixels. Every parameter is random
(fan-in-scaled kernels, non-zero biases and norm scales)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import unimatch as J  # noqa: E402
from lkgd_tpu.utils import motion as jax_motion  # noqa: E402
from lkgd_tpu.utils import optical_flow as jax_of  # noqa: E402

from lkgd_torch.models import unimatch as P  # noqa: E402
from lkgd_torch.utils import motion as port_motion  # noqa: E402
from lkgd_torch.utils import optical_flow as port_of  # noqa: E402
from lkgd_torch.utils.porting import unimatch_state_dict  # noqa: E402

from tests.test_torch_porting import flatten  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
DEPTH_CFG = dict(num_scales=1, upsample_factor=8, attn_splits_list=(2,),
                 corr_radius_list=(-1,), prop_radius_list=(-1,))


def close(got, want, err="", **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=err, **(tol or TOL))


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def random_params(shapes, seed: int):
    """A flax tree of random leaves shaped as ``shapes``: kernels normal / sqrt(fan-in),
    biases 0.1 x normal, norm scales 1 + 0.1 x normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name in ("kernel", "trident_weight"):
            value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            value = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_module(module, params):
    """Load ``params`` (a JAX module's) strictly into the port's ``module``."""
    module.load_state_dict(unimatch_state_dict(flatten(params)), strict=True)
    return module.eval()


def jax_module(module, seed, *args, **kw):
    """(random params, jitted apply) of a JAX module at these inputs."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return random_params(shapes, seed), jax.jit(lambda p, *a: module.apply(p, *a, **kw))


# ------------------------------------------------------------------ functional helpers
def test_instance_norm_coords_and_position_embedding():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32) * 3 + 1
    close(P.instance_norm(t(x)), J.instance_norm(jnp.asarray(x)))
    close(P.coords_grid(5, 7), J.coords_grid(5, 7), atol=0, rtol=0)
    close(P.position_embedding_sine(6, 10, 16), J.position_embedding_sine(6, 10, 16),
          rtol=1e-5, atol=1e-5)


def test_bilinear_sample_and_flow_warp():
    """In and out of range, exact integers, the edges; (B, ..., 2) with two middle axes."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    coords = rng.uniform(-1.5, 10.5, size=(2, 5, 7, 2)).astype(np.float32)
    coords[0, 0, :3] = [[0, 0], [9, 7], [4, 3]]
    close(P.bilinear_sample(t(img), t(coords)), J.bilinear_sample(jnp.asarray(img),
                                                                  jnp.asarray(coords)),
          rtol=1e-5, atol=1e-5)
    flow = rng.uniform(-2, 2, size=(2, 8, 10, 2)).astype(np.float32)
    close(P.flow_warp(t(img), t(flow)), J.flow_warp(jnp.asarray(img), jnp.asarray(flow)),
          rtol=1e-5, atol=1e-5)


def test_windows_and_shift_mask():
    x = np.random.default_rng(2).standard_normal((2, 8, 12, 3)).astype(np.float32)
    split = P.split_windows(t(x), 2)
    close(split, J.split_windows(jnp.asarray(x), 2), atol=0, rtol=0)
    assert torch.equal(P.merge_windows(split, 2), t(x))
    for h, w, k in ((8, 12, 2), (16, 16, 4)):
        close(P.shift_window_attn_mask(h, w, k), J.shift_window_attn_mask(h, w, k), atol=0,
              rtol=0)


@pytest.mark.parametrize("with_shift", [False, True])
def test_split_window_attention(with_shift):
    rng = np.random.default_rng(3)
    h, w, c = 8, 12, 16
    q, k, v = (rng.standard_normal((2, h * w, c)).astype(np.float32) for _ in range(3))
    mask = J.shift_window_attn_mask(h, w, 2)
    want = J.split_window_attention(*map(jnp.asarray, (q, k, v)), 2, h, w, with_shift, mask)
    got = P.split_window_attention(t(q), t(k), t(v), 2, h, w, with_shift,
                                   P.shift_window_attn_mask(h, w, 2))
    close(got, want)
    close(P._single_head_attention(t(q), t(k), t(v)),
          J._single_head_attention(*map(jnp.asarray, (q, k, v))))


def _features(seed, shape=(2, 6, 8, 16), scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) * scale for _ in range(2))


@pytest.mark.parametrize("kind", ["global", "local", "global_stereo", "local_stereo"])
def test_correlation_softmax_matchers(kind):
    f0, f1 = _features(4, scale=2.0)
    fn = {"global": ("global_correlation_softmax", ()),
          "local": ("local_correlation_softmax", (2,)),
          "global_stereo": ("global_correlation_softmax_stereo", ()),
          "local_stereo": ("local_correlation_softmax_stereo", (3,))}[kind]
    want = getattr(J, fn[0])(jnp.asarray(f0), jnp.asarray(f1), *fn[1])
    got = getattr(P, fn[0])(t(f0), t(f1), *fn[1])
    assert got.shape == want.shape
    close(got, want)


def _camera(b=2):
    K = np.tile(np.array([[[20.0, 0, 7.5], [0, 20.0, 5.0], [0, 0, 1.0]]], np.float32), (b, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    pose[:, 0, 3] = 0.3
    pose[-1, 1, 3] = -0.1  # the last sample also moves down and turns
    pose[-1, :3, :3] = [[0.995, -0.0998, 0], [0.0998, 0.995, 0], [0, 0, 1]]
    return K, pose


def test_depth_plane_sweep_rigid_flow_and_flow_correlation():
    f0, f1 = _features(5, shape=(2, 6, 8, 16))
    K, pose = _camera()
    cands = np.broadcast_to(np.linspace(2.0, 0.1, 12, dtype=np.float32).reshape(1, -1, 1, 1),
                            (2, 12, 6, 8)).copy()
    for argmax in (False, True):
        want = J.correlation_softmax_depth(*map(jnp.asarray, (f0, f1, K, pose, cands)),
                                           depth_from_argmax=argmax)
        close(P.correlation_softmax_depth(t(f0), t(f1), t(K), t(pose), t(cands), argmax),
              want)
    depth = np.random.default_rng(6).uniform(0.5, 5.0, size=(2, 6, 8)).astype(np.float32)
    close(P.compute_flow_with_depth_pose(t(depth), t(K), t(pose)),
          J.compute_flow_with_depth_pose(*map(jnp.asarray, (depth, K, pose))))
    flow = np.random.default_rng(7).uniform(-3, 3, size=(2, 6, 8, 2)).astype(np.float32)
    close(P.local_correlation_with_flow(t(f0), t(f1), t(flow), 4),
          J.local_correlation_with_flow(*map(jnp.asarray, (f0, f1, flow)), 4))


@pytest.mark.parametrize("scale_magnitude", [True, False])
def test_convex_and_bilinear_upsampling(scale_magnitude):
    rng = np.random.default_rng(8)
    flow = rng.standard_normal((2, 4, 5, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 4, 5, 9 * 16)).astype(np.float32)
    close(P.upsample_flow_with_mask(t(flow), t(mask), 4, scale_magnitude),
          J.upsample_flow_with_mask(jnp.asarray(flow), jnp.asarray(mask), 4, scale_magnitude))
    close(P._bilinear_resize_flow(t(flow), 2), J._bilinear_resize_flow(jnp.asarray(flow), 2),
          rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ modules
def test_encoder_modules():
    """ResidualBlock (strided, with its downsample), CNNEncoder at one and two scales."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 24, 8)).astype(np.float32)
    params, apply = jax_module(J.ResidualBlock(12, 2), 10, jnp.asarray(x))
    close(port_module(P.ResidualBlock(8, 12, 2), params)(t(x)), apply(params, x))
    img = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    for scales in (1, 2):
        params, apply = jax_module(J.CNNEncoder(32, scales), 11, jnp.asarray(img))
        got = port_module(P.CNNEncoder(32, scales), params)(t(img))
        want = apply(params, img)
        assert len(got) == len(want) == scales
        for g, w in zip(got, want):
            close(g, w)


@pytest.mark.parametrize("splits", [1, 2])
def test_feature_transformer(splits):
    """Two blocks: plain windows, then shifted ones (the Swin mask) when split."""
    f0, f1 = _features(12, shape=(2, 8, 12, 32))
    params, apply = jax_module(J.FeatureTransformer(32, 2, 4), 13, jnp.asarray(f0),
                               jnp.asarray(f1), attn_num_splits=splits)
    got = port_module(P.FeatureTransformer(32, 2, 4), params)(t(f0), t(f1), splits)
    want = apply(params, f0, f1)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("radius", [-1, 1])
def test_self_attn_propagation(radius):
    feature, _ = _features(14, shape=(2, 6, 8, 16))
    flow = np.random.default_rng(15).standard_normal((2, 6, 8, 2)).astype(np.float32)
    params, apply = jax_module(J.SelfAttnPropagation(16), 16, jnp.asarray(feature),
                               jnp.asarray(flow), local_window_radius=radius)
    close(port_module(P.SelfAttnPropagation(16), params)(t(feature), t(flow), radius),
          apply(params, feature, flow))


@pytest.mark.parametrize("flow_dim,bilinear_up", [(2, False), (1, False), (1, True)])
def test_update_block_gru_and_upsampler(flow_dim, bilinear_up):
    rng = np.random.default_rng(17)
    net, inp = (rng.standard_normal((2, 4, 6, 128)).astype(np.float32) for _ in range(2))
    corr = rng.standard_normal((2, 4, 6, 81)).astype(np.float32)
    flow = rng.standard_normal((2, 4, 6, flow_dim)).astype(np.float32)
    params, apply = jax_module(J.BasicUpdateBlock(81, 4, flow_dim, bilinear_up), 18,
                               *map(jnp.asarray, (net, inp, corr, flow)))
    got = port_module(P.BasicUpdateBlock(81, 4, flow_dim, bilinear_up), params)(
        t(net), t(inp), t(corr), t(flow))
    want = apply(params, net, inp, corr, flow)
    assert (got[1] is None) == (want[1] is None) == bilinear_up
    for g, w in zip(got, want):
        if w is not None:
            close(g, w)
    feature = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    flow2 = rng.standard_normal((2, 4, 6, 2)).astype(np.float32)
    params, apply = jax_module(J.ConvexUpsampler(4), 19, jnp.asarray(flow2),
                               jnp.asarray(feature), is_depth=bilinear_up)
    close(port_module(P.ConvexUpsampler(34, 4), params)(t(flow2), t(feature), bilinear_up),
          apply(params, flow2, feature))


# ------------------------------------------------------------------ the model
def _images(seed, b=1, h=32, w=48):
    base = np.random.default_rng(seed).uniform(0, 255, size=(b, h + 8, w + 8, 3))
    return (base[:, :h, :w].astype(np.float32), base[:, 4:h + 4, 2:w + 2].astype(np.float32))


def _config(task):
    cfg = J.UniMatchConfig.tiny()
    if task == "depth":
        cfg = dataclasses.replace(cfg, **DEPTH_CFG)
    return cfg


def _models(task, seed, *args, **kw):
    """(JAX params, jitted JAX apply, the port's model with them) of the tiny UniMatch."""
    cfg = _config(task)
    params, apply = jax_module(J.UniMatch(cfg), seed, *args, task=task, **kw)
    model = P.build_unimatch(P.UniMatchConfig(**dataclasses.asdict(cfg)), task, device="cpu")
    return params, apply, port_module(model, params)


@pytest.mark.parametrize("task", ["flow", "stereo", "depth"])
def test_tiny_unimatch_matches_jax(task):
    img0, img1 = _images(20, b=2)
    kw = {}
    if task == "depth":
        K, pose = _camera()
        K[:, 0, 2], K[:, 1, 2] = 24.0, 16.0
        kw = dict(intrinsics=jnp.asarray(K), pose=jnp.asarray(pose), num_depth_candidates=16)
    params, apply, model = _models(task, 21, jnp.asarray(img0), jnp.asarray(img1), **kw)
    want = np.asarray(apply(params, img0, img1))
    with torch.no_grad():
        got = model(t(img0), t(img1), **{k: t(v) if k != "num_depth_candidates" else v
                                         for k, v in kw.items()})
    assert got.shape == want.shape == ((2, 32, 48, 2) if task == "flow" else (2, 32, 48))
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-2
    if task == "flow":
        close(got, want, atol=1e-3, rtol=0)  # pixels
    else:
        close(got, want)


def test_state_dict_names_and_tasks():
    """The refinement block follows the task; the depth model has the convex upsampler and
    no mask head; the names are the JAX module's, the transformer's blocks as a list."""
    flow, stereo, depth = (P.UniMatch(P.UniMatchConfig(**dataclasses.asdict(_config(task))),
                                      task) for task in ("flow", "stereo", "depth"))
    names = flow.state_dict()
    assert "backbone.trident_weight" in names and "upsampler.conv1.weight" not in names
    assert "transformer.layers.1.cross_attn_ffn.mlp_2.weight" in names
    assert names["refine.flow_head_conv2.weight"].shape[0] == 2
    assert stereo.state_dict()["refine.flow_head_conv2.weight"].shape[0] == 1
    assert "upsampler.conv1.weight" in depth.state_dict()
    assert "refine.mask_conv1.weight" not in depth.state_dict()
    with pytest.raises(ValueError, match="num_scales"):
        P.UniMatch(P.UniMatchConfig.tiny(), "depth")


# ------------------------------------------------------------------ wrappers
@pytest.fixture(scope="module")
def flow_models():
    img = jnp.zeros((1, 32, 48, 3))
    return _models("flow", 22, img, img)


def test_flow_wrappers_at_30x44(flow_models):
    """Padded to 32x48 with JAX's antialiased bilinear resize, resized back, rescaled."""
    params, _, model = flow_models
    frames = np.random.default_rng(23).uniform(size=(3, 30, 44, 3)).astype(np.float32)
    jmodel = J.UniMatch(J.UniMatchConfig.tiny())
    want = jax_of.make_flow_fn(jmodel, params, (30, 44))(jnp.asarray(frames))
    got = port_of.make_flow_fn(model, (30, 44))(t(frames))
    assert got.shape == (2, 30, 44, 2)
    close(got, want, atol=1e-3, rtol=0)
    want_f, want_b = jax_of.make_bidirectional_flow_fn(jmodel, params, (30, 44))(
        jnp.asarray(frames))
    got_f, got_b = port_of.make_bidirectional_flow_fn(model, (30, 44))(t(frames))
    close(got_f, want_f, atol=1e-3, rtol=0)
    close(got_b, want_b, atol=1e-3, rtol=0)
    assert torch.equal(port_of.flow_normalize(got_f), got_f)
    assert (port_of.FLOW_MEAN, port_of.FLOW_STD, port_of.PADDING_FACTOR) == (
        jax_of.FLOW_MEAN, jax_of.FLOW_STD, jax_of.PADDING_FACTOR)


def test_stereo_and_depth_wrappers():
    rng = np.random.default_rng(24)
    left, right = (rng.uniform(size=(1, 30, 44, 3)).astype(np.float32) for _ in range(2))
    img = jnp.zeros((1, 32, 48, 3))
    params, _, model = _models("stereo", 25, img, img)
    want = jax_of.make_stereo_fn(J.UniMatch(J.UniMatchConfig.tiny()), params, (30, 44))(
        jnp.asarray(left), jnp.asarray(right))
    got = port_of.make_stereo_fn(model, (30, 44))(t(left), t(right))
    assert got.shape == (1, 30, 44)
    close(got, want, atol=1e-3, rtol=0)  # pixels, as the flow wrappers

    K, pose = _camera(1)
    kw = dict(intrinsics=jnp.asarray(K), pose=jnp.asarray(pose), num_depth_candidates=16)
    params, _, model = _models("depth", 26, img, img, **kw)
    left, right = (rng.uniform(size=(1, 32, 48, 3)).astype(np.float32) for _ in range(2))
    jfn = jax_of.make_depth_fn(J.UniMatch(_config("depth")), params, (32, 48),
                               num_depth_candidates=16)
    want = jfn(jnp.asarray(left), jnp.asarray(right), jnp.asarray(K), jnp.asarray(pose))
    got = port_of.make_depth_fn(model, (32, 48), num_depth_candidates=16)(
        t(left), t(right), t(K), t(pose))
    assert got.shape == (1, 32, 48)
    close(got, want)
    with pytest.raises(ValueError, match="multiple-of-16"):
        port_of.make_depth_fn(model, (30, 44))


def test_motion_helpers_match_jax():
    for fps, bucket in ((7.0, 127.0), (3.0, 10.0), (25.0, 255.0)):
        assert port_motion.motion2flow(fps, bucket) == jax_motion.motion2flow(fps, bucket)
        assert port_motion.bucket2motion(bucket) == jax_motion.bucket2motion(bucket)
    for fps, score in ((7.0, 3.0), (3.0, 0.1), (25.0, 40.0)):
        assert port_motion.flow2motion(fps, score) == jax_motion.flow2motion(fps, score)
        assert port_motion.motion2bucket(score) == jax_motion.motion2bucket(score)
    flows = np.random.default_rng(27).standard_normal((3, 4, 5, 6, 2)) * [[[[[1.0]]]], [[[[5.0]]]],
                                                                           [[[[30.0]]]]]
    np.testing.assert_array_equal(port_motion.cal_motion_bucket_ids(flows),
                                  jax_motion.cal_motion_bucket_ids(flows))
