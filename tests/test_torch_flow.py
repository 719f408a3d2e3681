"""The flow pipelines in the port (``lkgd_torch.pipelines.svd_flow``) against
``lkgd_tpu.pipelines.svd_flow`` at fp32, on the tiny configs of
``tests/test_pipelines_variants.py:18-37`` with 2-step loops: ``flow``, ``flow_fix`` (the
dual-``conv_in`` UNet at ``in_channels=12``, ``conv_in2`` and its alpha random) and joint
video+flow (with and without a flow-condition image), every parameter random, with the
normals JAX draws from ``jax.random.split(rng, 3)`` handed to the port; latents and frames
at rtol 1e-4, atol 2e-4. The dual-``conv_in`` UNet alone, ``flow_codec`` and
``control_preprocess`` against the JAX modules, and the CLI's ``--mode flow`` at tiny widths
on the CPU."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.pipelines.svd_flow import (  # noqa: E402
    StableVideoDiffusionFlowPipeline as JaxFlowPipeline,
    StableVideoDiffusionJointVFPipeline as JaxJointVFPipeline)
from lkgd_tpu.utils import control_preprocess as jax_control  # noqa: E402
from lkgd_tpu.utils import flow_codec as jax_codec  # noqa: E402

from lkgd_torch.cli import run_inference_svd as cli  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.pipelines.svd_flow import (StableVideoDiffusionFlowPipeline,  # noqa: E402
                                           StableVideoDiffusionJointVFPipeline)
from lkgd_torch.utils import control_preprocess as port_control  # noqa: E402
from lkgd_torch.utils import flow_codec as port_codec  # noqa: E402
from lkgd_torch.utils.flow_codec import flow_latent_unnormalize  # noqa: E402

from tests.test_torch_controlnet import (LAT, S, STEPS, T, TINY_WIDTHS, UNET, close,  # noqa: E402
                                         jax_kw, joint_configs, torch_kw)
from tests.test_torch_porting import load_jax_params, port_state_dict, randomize  # noqa: E402

FIX = dict(UNET, in_channels=12, dual_cond_conv_in=True)


def _configs(kind):
    if kind == "joint_vf":
        return joint_configs()
    unet = FIX if kind == "flow_fix" else UNET
    return jcfg.SVDUNetConfig(**unet), tcfg.SVDUNetConfig(**unet)


def _pipelines(kind, **pipe_kw):
    jconf, tconf = _configs(kind)
    if kind == "joint_vf":
        return (JaxJointVFPipeline(unet_config=jconf, **jax_kw(**pipe_kw)),
                StableVideoDiffusionJointVFPipeline(unet_config=tconf, **torch_kw(**pipe_kw)))
    return (JaxFlowPipeline(unet_config=jconf, mode=kind, **jax_kw(**pipe_kw)),
            StableVideoDiffusionFlowPipeline(unet_config=tconf, mode=kind, **torch_kw(**pipe_kw)))


def jax_draws(kind, rng, streams: int = 1, flow_cond: bool = True) -> dict:
    """The normals the JAX pipeline draws from ``rng`` (``svd_flow.py:40, 48, 70, 123, 130,
    137, 148``), as the port's ``noise_aug``, ``noise_aug2`` and ``initial_noise``."""
    rng_aug, rng_aug2, rng_lat = jax.random.split(rng, 3)
    image_shape = (1, S, S, 3)
    out = {"noise_aug": jax.random.normal(rng_aug, image_shape, jnp.float32),
           "initial_noise": jax.random.normal(rng_lat, (streams, T, LAT, LAT, 4), jnp.float32)}
    if kind != "flow" and flow_cond:
        out["noise_aug2"] = jax.random.normal(rng_aug2, image_shape, jnp.float32)
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return (rng.uniform(size=(1, S, S, 3)).astype(np.float32),
            rng.uniform(size=(1, S, S, 3)).astype(np.float32))


@pytest.mark.parametrize("kind,with_flow", [("flow", True), ("flow_fix", True),
                                            ("joint_vf", True), ("joint_vf", False)])
def test_flow_pipeline_matches_jax(images, kind, with_flow):
    jpipe, tpipe = _pipelines(kind)
    params = randomize(jax.eval_shape(jpipe.init_params, jax.random.PRNGKey(0)), seed=51)
    load_jax_params(tpipe, params)
    if kind == "flow_fix":  # conv_in2 and its alpha, zero at init, are random here
        assert float(jnp.abs(params["unet"]["params"]["conv_in2_alpha"]).max()) > 0
    image, flow_img = images
    flow_cond = flow_img if with_flow else None
    rng = jax.random.PRNGKey(3)
    streams = 2 if kind == "joint_vf" else 1
    want = jpipe(params, image, flow_cond=flow_cond, rng=rng, output_type="latent")
    given = jax_draws(kind, rng, streams, with_flow)
    got = tpipe(image, flow_cond=flow_cond, output_type="latent", **given)
    assert got.shape == (streams, T, LAT, LAT, 4)
    close(got, want, "latents")
    # frames: the JAX call's own decode (un-normalised flow) against the port's
    want_frames = jpipe(params, image, flow_cond=flow_cond, rng=rng)
    if kind == "joint_vf":
        got_frames = (tpipe.decode_latents(got[:1]),
                      tpipe.decode_latents(flow_latent_unnormalize(got[1:])))
        for g, w in zip(got_frames, want_frames):
            assert g.shape == (1, T, S, S, 3)
            close(g, w, "frames")
    else:
        got_frames = tpipe.decode_latents(flow_latent_unnormalize(got))
        assert got_frames.shape == (1, T, S, S, 3)
        close(got_frames, want_frames, "frames")


def test_dual_conv_in_unet_matches_jax():
    """The flow variant's UNet alone (``in_channels=12``: ``conv_in2`` takes the first 6
    channels and nothing more), every tensor random; a zero-channel ``cond2`` is the same
    call."""
    jconf, tconf = _configs("flow_fix")
    rng = np.random.default_rng(2)
    args = (rng.standard_normal((2, T, LAT, LAT, 12)).astype(np.float32),
            np.full((2,), 0.3, np.float32), rng.standard_normal((2, 1, 32)).astype(np.float32),
            np.ones((2, 3), np.float32))
    module = JaxUNet(jconf)
    params = randomize(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)), seed=9)
    assert params["params"]["conv_in2"]["kernel"].shape == (3, 3, 6, 32)
    want = jax.jit(module.apply)(params, *args)
    unet = UNetSpatioTemporalCondition(tconf).eval()
    unet.load_state_dict(port_state_dict(params), strict=True)
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        got = unet(*targs)
        empty = unet(*targs, cond2=targs[0][..., 12:])
        alpha = unet.conv_in2_alpha.clone()
        unet.conv_in2_alpha.zero_()
        without = unet(*targs)
        unet.conv_in2_alpha.copy_(alpha)
    close(got, want)
    assert torch.equal(got, empty)
    assert (got - without).abs().max() > 1e-3  # conv_in2 counts once its alpha is not zero


def test_flow_pipelines_refuse_what_jax_ignores(images):
    """Batched CFG only (the JAX loops ignore ``sequential_cfg``); one image for joint
    video+flow; the two modes alone."""
    with pytest.raises(ValueError, match="sequential_cfg"):
        StableVideoDiffusionFlowPipeline(unet_config=_configs("flow")[1],
                                         **torch_kw(sequential_cfg=True))
    with pytest.raises(ValueError, match="mode"):
        StableVideoDiffusionFlowPipeline(unet_config=_configs("flow")[1], mode="joint",
                                         **torch_kw())
    joint = StableVideoDiffusionJointVFPipeline(unet_config=_configs("joint_vf")[1],
                                                **torch_kw())
    with pytest.raises(ValueError, match="one pair"):
        joint.denoise(torch.from_numpy(np.concatenate(images)))


# ------------------------------------------------------------------ utilities
def test_flow_codec_matches_jax():
    rng = np.random.default_rng(4)
    latents = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    flow = rng.uniform(-80, 80, size=(3, 5, 2)).astype(np.float32)
    flow4 = np.concatenate([flow, rng.uniform(0, 9, (3, 5, 1)), rng.uniform(-1, 1, (3, 5, 1))],
                           -1).astype(np.float32)
    image = rng.uniform(size=(3, 5, 3)).astype(np.float32)
    cases = [("flow_latent_normalize", latents, {"scale": 0.18215}),
             ("flow_latent_normalize", latents, {}), ("flow_latent_unnormalize", latents, {}),
             ("flow_to_image_naive", flow, {}), ("image_to_flow_naive", image, {}),
             ("flow_expand_polar", flow, {}), ("flow_squeeze_polar", flow4, {})]
    for name, x, kw in cases:
        want = np.asarray(getattr(jax_codec, name)(jnp.asarray(x), **kw))
        got = getattr(port_codec, name)(torch.from_numpy(x), **kw).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=name)
    for const in ("FLOW_CLIP_MAX", "FLOW_NORM_CLIP_MAX", "FLOW_LATENT_MEAN", "FLOW_LATENT_STD"):
        assert getattr(port_codec, const) == pytest.approx(getattr(jax_codec, const), rel=1e-12)
    bf16 = port_codec.flow_latent_normalize(torch.from_numpy(latents).bfloat16(), scale=0.18215)
    assert bf16.dtype == torch.bfloat16


def test_control_preprocess_matches_jax():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    for kind in ("canny", "tile", "ip2p", "softedge"):
        np.testing.assert_array_equal(port_control.control_preprocess(images, kind),
                                      jax_control.control_preprocess(images, kind), err_msg=kind)
    port_control.register_processor("negative", lambda img: 1.0 - img)
    np.testing.assert_array_equal(port_control.control_preprocess(images, "negative"),
                                  1.0 - images)
    with pytest.raises(KeyError, match="unknown control type"):
        port_control.control_preprocess(images, "depth")


def test_cli_flow_mode_tiny_on_cpu(tmp_path):
    import imageio.v3 as iio

    from lkgd_torch.data.video_io import load_input

    rng = np.random.default_rng(6)
    iio.imwrite(str(tmp_path / "a.png"), (rng.uniform(size=(40, 60, 3)) * 255).astype(np.uint8))
    out = str(tmp_path / "flow.gif")
    cli.main(["--mode", "flow", "--image", str(tmp_path / "a.png"), "--output", out, "--height",
              str(S), "--width", str(S), "--num-frames", str(T), "--num-inference-steps",
              str(STEPS), "--device", "cpu", "--dtype", "fp32"], TINY_WIDTHS)
    video = load_input(out)
    assert video.shape == (T, S, S, 3) and np.isfinite(video).all()
