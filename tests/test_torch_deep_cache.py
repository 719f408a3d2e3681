"""DeepCache and the UNet's second input head in the port against ``lkgd_tpu`` at fp32.

DeepCache (``deep_cache=`` / ``return_deep_feature=`` of the UNet, ``deep_cache_interval``
of the base pipeline): the contract of ``tests/test_deep_cache.py`` (a cached step on the
same step's feature is exact, a cached step moves with the current latents, ControlNet
residuals are refused beside a cache), the cached UNet against JAX's, and the base pipeline
at ``dc=2`` and ``3`` over 4 steps (full and cached steps in different orders) against JAX
with JAX's noise injected, at rtol 1e-4, atol 2e-4. ``sequential_cfg`` beside DeepCache
raises ("mutually"), and every other pipeline refuses ``dc > 1``, which JAX ignores there.

The y head (``y_input_head_mask``): the tiny UNet with the mask against JAX (every tensor
random, the mask's rows and its halved form under ``halve_stream_masks``), and the routing
test of ``tests/test_sd2d_training.py:43-68`` mirrored."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.pipelines.svd import StableVideoDiffusionPipeline as JaxPipeline  # noqa: E402

from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.controlnet_svd import ControlNetSDVConfig  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline  # noqa: E402
from lkgd_torch.pipelines.svd_controlnet import (  # noqa: E402
    StableVideoDiffusionControlNetPipeline)
from lkgd_torch.pipelines.svd_flow import (StableVideoDiffusionFlowPipeline,  # noqa: E402
                                           StableVideoDiffusionJointVFPipeline)
from lkgd_torch.pipelines.svd_smooth import StableVideoDiffusionSmoothPipeline  # noqa: E402
from lkgd_torch.pipelines.svd_trans import StableVideoDiffusionTransPipeline  # noqa: E402

from tests.test_torch_controlnet import (EMB, LAT, PLAIN, T, UNET, close, draws,  # noqa: E402
                                         jax_kw, joint_configs, torch_kw)
from tests.test_torch_porting import load_jax_params, port_state_dict, randomize  # noqa: E402

DC_STEPS = 4  # dc=2: full, cached, full, cached; dc=3: full, cached, cached, full


def _unet_inputs(rows=2, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, T, LAT, LAT, 8)).astype(np.float32),
            np.full((rows,), 0.3, np.float32),
            (rng.standard_normal((rows, 1, 32)) * 0.1).astype(np.float32),
            np.ones((rows, 3), np.float32))


def _jax_unet(config, seed, rows=2):
    """A JAX UNet, its params (every leaf random) and the port's UNet with them."""
    module = JaxUNet(config)
    args = _unet_inputs(rows)
    params = randomize(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)),
                       seed=seed)
    return module, params


def _port_unet(config, params):
    unet = UNetSpatioTemporalCondition(config)
    unet.load_state_dict(port_state_dict(params), strict=True)
    return unet.eval()


@pytest.fixture(scope="module")
def unet():
    module, params = _jax_unet(PLAIN[0], seed=12)
    return module, params, _port_unet(PLAIN[1], params)


def _t(args):
    return [torch.from_numpy(a) for a in args]


# ------------------------------------------------------------------ the UNet contract
def test_cached_step_is_exact_for_same_step_feature(unet):
    _, _, port = unet
    args = _t(_unet_inputs())
    with torch.no_grad():
        full, feature = port(*args, return_deep_feature=True)
        cached = port(*args, deep_cache=feature)
        cached2, same = port(*args, deep_cache=feature, return_deep_feature=True)
    assert feature.shape == (2 * T, LAT, LAT, UNET["block_out_channels"][1])
    assert torch.equal(full, cached) and torch.equal(full, cached2) and same is feature


def test_cached_step_tracks_current_shallow_path(unet):
    _, _, port = unet
    x, *rest = _t(_unet_inputs())
    with torch.no_grad():
        _, feature = port(x, *rest, return_deep_feature=True)
        approx = port(x + 0.3, *rest, deep_cache=feature)
        exact = port(x + 0.3, *rest)
        stale = port(x, *rest)
    assert not torch.equal(approx, exact)  # an approximation
    assert (approx - stale).abs().max() > 1e-3  # that moves with the latents


def test_controlnet_residuals_rejected_with_cache(unet):
    _, _, port = unet
    args = _t(_unet_inputs())
    with torch.no_grad():
        _, feature = port(*args, return_deep_feature=True)
        with pytest.raises(ValueError, match="ControlNet"):
            port(*args, deep_cache=feature, mid_block_additional_residual=torch.zeros(1))


def test_full_and_cached_unet_match_jax(unet):
    """The feature (the JAX layout ``(B*T, h, w, C1)``), a full call and a cached call on a
    moved sample equal JAX's."""
    module, params, port = unet
    args = _unet_inputs()
    out, feature = jax.jit(lambda p, *a: module.apply(p, *a, return_deep_feature=True))(
        params, *args)
    moved = (args[0] + 0.3,) + args[1:]
    cached = jax.jit(lambda p, c, *a: module.apply(p, *a, deep_cache=c))(params, feature, *moved)
    with torch.no_grad():
        got_out, got_feature = port(*_t(args), return_deep_feature=True)
        got_cached = port(*_t(moved), deep_cache=torch.tensor(np.asarray(feature)))
    close(got_out, out, "full")
    close(got_feature, feature, "deep feature")
    close(got_cached, cached, "cached")


# ------------------------------------------------------------------ the pipeline
@pytest.fixture(scope="module")
def pipe_params():
    jpipe = JaxPipeline(unet_config=PLAIN[0], **jax_kw(num_inference_steps=DC_STEPS))
    return randomize(jax.eval_shape(jpipe.init_params, jax.random.PRNGKey(0)), seed=41)


@pytest.mark.parametrize("dc", [2, 3])
def test_deep_cache_pipeline_matches_jax(pipe_params, dc):
    jpipe = JaxPipeline(unet_config=PLAIN[0],
                        **jax_kw(num_inference_steps=DC_STEPS, deep_cache_interval=dc))
    tpipe = StableVideoDiffusionPipeline(
        unet_config=PLAIN[1], **torch_kw(num_inference_steps=DC_STEPS, deep_cache_interval=dc))
    load_jax_params(tpipe, pipe_params)
    image, noise_aug, init_noise = draws(1, seed=20 + dc)
    want = np.asarray(jpipe._generate(pipe_params, jnp.asarray(image), jax.random.PRNGKey(0),
                                      jnp.asarray(noise_aug), jnp.asarray(init_noise)))
    kw = dict(noise_aug=torch.from_numpy(noise_aug), initial_noise=torch.from_numpy(init_noise))
    got = tpipe(image, output_type="latent", **kw)
    close(got, want, f"latents at dc={dc}")
    # an approximation: the exact loop gives other latents
    exact = StableVideoDiffusionPipeline(unet_config=PLAIN[1],
                                         **torch_kw(num_inference_steps=DC_STEPS))
    exact.unet, exact.vae, exact.image_encoder = tpipe.models
    assert (exact(image, output_type="latent", **kw) - got).abs().max() > 1e-4


def test_deep_cache_counts_full_and_cached_steps():
    """Step i runs the full UNet when i % dc == 0 (step 0 always), else the cached one."""
    tpipe = StableVideoDiffusionPipeline(
        unet_config=PLAIN[1], **torch_kw(num_inference_steps=5, deep_cache_interval=3))
    tpipe.init_params(torch.Generator().manual_seed(0))
    calls = []
    unet_forward = tpipe.unet.forward

    def spy(*args, **kw):
        calls.append("cached" if kw.get("deep_cache") is not None else "full")
        return unet_forward(*args, **kw)

    tpipe.unet.forward = spy
    image, noise_aug, init_noise = draws(1, seed=3)
    tpipe(image, output_type="latent", noise_aug=torch.from_numpy(noise_aug),
          initial_noise=torch.from_numpy(init_noise))
    assert calls == ["full", "cached", "cached", "full", "cached"]


def test_sequential_cfg_conflict_rejected():
    tpipe = StableVideoDiffusionPipeline(
        unet_config=PLAIN[1], **torch_kw(deep_cache_interval=2, sequential_cfg=True))
    with pytest.raises(ValueError, match="mutually"):
        tpipe.denoise(torch.full((1, 64, 64, 3), 0.5))


@pytest.mark.parametrize("name", ["trans", "smooth", "controlnet", "flow", "joint_vf"])
def test_other_pipelines_refuse_deep_cache(name):
    """The JAX package ignores ``deep_cache_interval`` in these pipelines (their loops
    have no cache); the port refuses it when it is built."""
    unet = joint_configs()[1] if name in ("trans", "smooth", "joint_vf") else PLAIN[1]
    cls, extra = {
        "trans": (StableVideoDiffusionTransPipeline, {}),
        "smooth": (StableVideoDiffusionSmoothPipeline, {"start_step": 1, "total_frames": 6}),
        "controlnet": (StableVideoDiffusionControlNetPipeline, {"controlnet_config":
                       ControlNetSDVConfig(unet=PLAIN[1],
                                           conditioning_embedding_out_channels=EMB)}),
        "flow": (StableVideoDiffusionFlowPipeline, {}),
        "joint_vf": (StableVideoDiffusionJointVFPipeline, {})}[name]
    with pytest.raises(ValueError, match="deep_cache_interval"):
        cls(unet_config=unet, **torch_kw(deep_cache_interval=2), **extra)
    cls(unet_config=unet, **torch_kw(), **extra)  # dc=1 builds


# ------------------------------------------------------------------ the y head
Y_MASK = (0, 1, 0, 1)


@pytest.fixture(scope="module")
def y_head():
    jconf = jcfg.SVDUNetConfig(**UNET, y_input_head_mask=Y_MASK)
    module, params = _jax_unet(jconf, seed=13, rows=4)
    return module, params, tcfg.SVDUNetConfig(**UNET, y_input_head_mask=Y_MASK)


@pytest.mark.parametrize("halved", [False, True])
def test_y_head_unet_matches_jax(y_head, halved):
    """Four rows under ``(0, 1, 0, 1)``, and two rows (one CFG side) under the halved mask
    ``(0, 1)``; the same parameters."""
    module, params, tconf = y_head
    rows = 2 if halved else 4
    jconf = module.config
    if halved:
        jconf, tconf = jcfg.halve_stream_masks(jconf), tcfg.halve_stream_masks(tconf)
        assert jconf.y_input_head_mask == tconf.y_input_head_mask == (0, 1)
    args = _unet_inputs(rows, seed=5)
    want = jax.jit(JaxUNet(jconf).apply)(params, *args)
    with torch.no_grad():
        got = _port_unet(tconf, params)(*_t(args))
    close(got, want)


def test_svd_dual_input_head_routes_by_stream():
    """``tests/test_sd2d_training.py:43-68`` in the port: moving the y head's conv changes
    only stream 1, moving its time embedding changes only stream 1."""
    config = tcfg.SVDUNetConfig(**{**UNET, "cross_attention_dim": 64}, y_input_head_mask=(0, 1))
    unet = UNetSpatioTemporalCondition(config).eval()
    from lkgd_torch.models.layers import init_params

    init_params(unet, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.normal(size=(2, 2, 16, 16, 8)).astype(np.float32)),
            torch.zeros(2), torch.ones(2, 1, 64), torch.ones(2, 3))

    def moved(prefix):
        other = UNetSpatioTemporalCondition(config).eval()
        other.load_state_dict({k: v + 0.1 if k.startswith(prefix) else v
                               for k, v in unet.state_dict().items()})
        with torch.no_grad():
            return other(*args)

    with torch.no_grad():
        out0 = unet(*args)
    out1 = moved("conv_in_y.")
    assert (out1[1] - out0[1]).abs().max() > 1e-4
    torch.testing.assert_close(out1[0], out0[0], atol=1e-6, rtol=0)
    out2 = moved("time_embedding_y.")
    torch.testing.assert_close(out2[0], out0[0], atol=1e-6, rtol=0)
    assert (out2[1] - out0[1]).abs().max() > 1e-5


def test_y_head_config_fields_match_jax():
    """The two new fields exist with the JAX defaults, and ``halve_stream_masks`` cuts the
    y mask as the JAX function does (lengths below four and odd ones stay)."""
    for mask in [(0, 1, 0, 1), (0, 1), (0, 1, 1), None]:
        j = jcfg.halve_stream_masks(jcfg.SVDUNetConfig(y_input_head_mask=mask))
        t = tcfg.halve_stream_masks(tcfg.SVDUNetConfig(y_input_head_mask=mask))
        assert t.y_input_head_mask == j.y_input_head_mask
    fields = {f.name: f.default for f in dataclasses.fields(tcfg.SVDUNetConfig)}
    jfields = {f.name: f.default for f in dataclasses.fields(jcfg.SVDUNetConfig)}
    for name in ("dual_cond_conv_in", "y_input_head_mask"):
        assert fields[name] == jfields[name]
