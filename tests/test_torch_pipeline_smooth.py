"""Long-video smoothing in the port (``lkgd_torch.pipelines.svd_smooth``) against
``lkgd_tpu.pipelines.svd_smooth`` at fp32: the tiny joint pipeline (spatial and temporal
joint attention, flip, two stream-masked LoRA adapters, every leaf random) over a 10-frame
video in 4-frame chunks from ``start_step=1``, with JAX's own draws of the augmentation
noise, the SDEdit noise and the per-step offsets given to the port; latents and frames at
rtol 1e-4, atol 2e-4 (fp32 rounding through the composed UNet, as the other pipelines'
tests). ``sequential_cfg`` equals the batched form at rtol 2e-4, atol 2e-4 (the JAX
package's own tolerance for that comparison). The frame-count check, and the CLI's
``--mode smooth`` at a tiny size on the CPU."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPConfig  # noqa: E402
from lkgd_tpu.models.vae_temporal import TemporalVAEConfig as JaxVAEConfig  # noqa: E402
from lkgd_tpu.pipelines.svd import SVDPipelineConfig as JaxPipeConfig  # noqa: E402
from lkgd_tpu.pipelines.svd_smooth import (  # noqa: E402
    StableVideoDiffusionSmoothPipeline as JaxSmoothPipeline)

from lkgd_torch.cli import run_inference_svd as cli  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.pipelines.svd import SVDPipelineConfig  # noqa: E402
from lkgd_torch.pipelines.svd_smooth import StableVideoDiffusionSmoothPipeline  # noqa: E402

from tests.test_torch_joint import joint_unet_configs  # noqa: E402
from tests.test_torch_pipeline_trans import TINY_WIDTHS  # noqa: E402
from tests.test_torch_porting import (H, T, TINY_CLIP, TINY_PIPE, TINY_VAE, W,  # noqa: E402
                                      load_jax_params, tiny_jax_params)

TOTAL, START = 10, 1
SMOOTH = dict(start_step=START, total_frames=TOTAL)


def torch_smooth(unet_config, **pipe_kw):
    return StableVideoDiffusionSmoothPipeline(
        config=SVDPipelineConfig(**TINY_PIPE, **pipe_kw), unet_config=unet_config,
        vae_config=tcfg.TemporalVAEConfig(**TINY_VAE),
        clip_config=tcfg.CLIPVisionConfig(**TINY_CLIP), dtype=torch.float32, device="cpu",
        **SMOOTH)


def jax_draws(rng, jpipe):
    """The normals and offsets ``_generate_impl`` draws from ``rng``
    (``lkgd_tpu/pipelines/svd_smooth.py:53, 58, 67, 82``)."""
    rng_aug, rng_noise, rng_offsets = jax.random.split(rng, 3)
    n_steps = jpipe.schedule.num_steps - START
    return dict(
        noise_aug=np.asarray(jax.random.normal(rng_aug, (TOTAL, H, W, 3), jnp.float32)),
        initial_noise=np.asarray(jax.random.normal(rng_noise, (1, TOTAL, H // 2, W // 2, 4),
                                                   jnp.float32)),
        offsets=np.asarray(jax.random.randint(rng_offsets, (n_steps,), 0, T)))


@pytest.fixture(scope="module")
def smooth():
    """The JAX tiny smooth pipeline's latents and frames for one video and key, the draws
    behind them, and the port's pipeline with the same params."""
    jconf, tconf = joint_unet_configs()
    jpipe = JaxSmoothPipeline(config=JaxPipeConfig(**TINY_PIPE), unet_config=jconf,
                              vae_config=JaxVAEConfig(**TINY_VAE),
                              clip_config=JaxCLIPConfig(**TINY_CLIP), dtype=jnp.float32,
                              **SMOOTH)
    params = tiny_jax_params(jpipe)
    video = np.random.default_rng(8).uniform(size=(TOTAL, H, W, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(2)  # offsets (1, 3): both shift the buffer
    latents = jpipe._generate(params, jnp.asarray(video), rng)
    frames = np.asarray(jpipe._decode(params["vae"], latents))
    tpipe = torch_smooth(tconf)
    load_jax_params(tpipe, params)
    draws = jax_draws(rng, jpipe)
    return dict(video=video, draws=draws, latents=np.asarray(latents), frames=frames,
                tpipe=tpipe, tconf=tconf,
                got=tpipe(video, output_type="latent", **_given(draws)))


def _given(draws):
    return dict(noise_aug=torch.from_numpy(draws["noise_aug"].copy()),
                initial_noise=torch.from_numpy(draws["initial_noise"].copy()),
                offsets=draws["offsets"].tolist())


def test_smooth_latents_and_frames_match_jax(smooth):
    tpipe, draws, got = smooth["tpipe"], smooth["draws"], smooth["got"]
    assert tpipe.n_chunks == 4 and len(draws["offsets"]) == TINY_PIPE["num_inference_steps"] - 1
    assert draws["offsets"].min() > 0  # the buffer is shifted: edge frames are replicated
    assert got.shape == (1, TOTAL, H // 2, W // 2, 4)
    np.testing.assert_allclose(got.numpy(), smooth["latents"], rtol=1e-4, atol=2e-4)
    frames = tpipe.decode_latents(got).numpy()
    assert frames.shape == (1, TOTAL, H, W, 3)
    np.testing.assert_allclose(frames, smooth["frames"], rtol=1e-4, atol=2e-4)


def test_smooth_sequential_cfg_matches_batched(smooth):
    """[fwd, bwd] rows through the half-batch UNet, once per CFG side, on the same
    parameters equal the batched [fwd, bwd, fwd_cond, bwd_cond] call."""
    tpipe = smooth["tpipe"]
    seq = torch_smooth(smooth["tconf"], sequential_cfg=True)
    for src, dst in zip(tpipe.models, seq.models):
        dst.load_state_dict(src.state_dict(), strict=True)
    assert seq.unet_seq.config.joint.mask == (0, 1)
    got = seq(smooth["video"], output_type="latent", **_given(smooth["draws"]))
    np.testing.assert_allclose(got.numpy(), smooth["got"].numpy(), rtol=2e-4, atol=2e-4)


def test_smooth_checks_the_frame_count_and_offsets(smooth):
    tpipe, draws = smooth["tpipe"], smooth["draws"]
    with pytest.raises(ValueError, match="built for 10 frames, got 9"):
        tpipe(smooth["video"][:9])
    with pytest.raises(ValueError, match="offsets must be"):
        tpipe(smooth["video"], output_type="latent", **{**_given(draws), "offsets": [0, T]})


def test_cli_smooth_mode_tiny_on_cpu(tmp_path):
    import imageio.v3 as iio

    from lkgd_torch.data.video_io import load_input

    rng = np.random.default_rng(2)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(8):  # one more frame than is smoothed
        iio.imwrite(str(frames_dir / f"{i:03d}.png"),
                    (rng.uniform(size=(40, 60, 3)) * 255).astype(np.uint8))
    out = str(tmp_path / "out.gif")
    cli.main(["--mode", "smooth", "--image", str(frames_dir), "--output", out, "--height",
              str(H), "--width", str(W), "--num-frames", str(T), "--num-inference-steps", "3",
              "--smooth-start-step", "1", "--smooth-total-frames", "7", "--flip", "--temporal",
              "--lora-rank", "2", "--device", "cpu", "--dtype", "fp32"], TINY_WIDTHS)
    frames = load_input(out)
    assert frames.shape == (7, H, W, 3) and np.isfinite(frames).all()
    args = cli.make_parser().parse_args(["--mode", "smooth", "--image", "v.mp4"])
    assert (args.smooth_start_step, args.smooth_total_frames) == (10, 50)
    config = cli.unet_config(args)
    assert config.joint is not None and config.joint.mask == (0, 1, 0, 1)
