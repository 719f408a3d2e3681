"""Frame-transition generation in the port (``lkgd_torch.pipelines.svd_trans``) end to end
against ``lkgd_tpu.pipelines.svd_trans`` at fp32: the tiny joint pipeline (spatial and
temporal joint attention, flip, two stream-masked LoRA adapters, every leaf random) with
injected ``noise_aug`` and ``initial_noise``, latents and frames at rtol 1e-4, atol 2e-4
(fp32 rounding through a 3-step loop of the composed UNet, as the base pipeline's test).
``sequential_cfg`` equals the batched form in the port for base and trans at rtol 2e-4,
atol 2e-4 (the JAX package's own tolerance for that comparison: only the batching of the
same arithmetic differs). And the CLI's ``--mode trans`` at a tiny size on the CPU."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPConfig  # noqa: E402
from lkgd_tpu.models.vae_temporal import TemporalVAEConfig as JaxVAEConfig  # noqa: E402
from lkgd_tpu.pipelines.svd import SVDPipelineConfig as JaxPipeConfig  # noqa: E402
from lkgd_tpu.pipelines.svd_trans import (  # noqa: E402
    StableVideoDiffusionTransPipeline as JaxTransPipeline)

from lkgd_torch.cli import run_inference_svd as cli  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline  # noqa: E402
from lkgd_torch.pipelines.svd_trans import StableVideoDiffusionTransPipeline  # noqa: E402

from tests.test_torch_joint import joint_unet_configs  # noqa: E402
from tests.test_torch_porting import (H, T, TINY_CLIP, TINY_PIPE, TINY_UNET, TINY_VAE, W,  # noqa: E402
                                      load_jax_params, tiny_jax_params)


def torch_pipeline(cls, unet_config, **pipe_kw):
    return cls(config=SVDPipelineConfig(**TINY_PIPE, **pipe_kw), unet_config=unet_config,
               vae_config=tcfg.TemporalVAEConfig(**TINY_VAE),
               clip_config=tcfg.CLIPVisionConfig(**TINY_CLIP), dtype=torch.float32, device="cpu")


def noise(streams: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(streams, H, W, 3)).astype(np.float32),
            rng.standard_normal((streams, H, W, 3)).astype(np.float32),
            rng.standard_normal((streams, T, H // 2, W // 2, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def trans():
    """The JAX tiny trans pipeline, its random params, and the port's with them loaded."""
    jconf, tconf = joint_unet_configs()
    jpipe = JaxTransPipeline(config=JaxPipeConfig(**TINY_PIPE), unet_config=jconf,
                             vae_config=JaxVAEConfig(**TINY_VAE),
                             clip_config=JaxCLIPConfig(**TINY_CLIP), dtype=jnp.float32)
    params = tiny_jax_params(jpipe)
    tpipe = torch_pipeline(StableVideoDiffusionTransPipeline, tconf)
    load_jax_params(tpipe, params)
    return jpipe, params, tpipe, tconf


def test_trans_pipeline_latents_and_frames_match_jax(trans):
    jpipe, params, tpipe, _ = trans
    image, noise_aug, init_noise = noise(2)
    want_lat = np.asarray(jpipe(params, image[0], image[1], output_type="latent",
                                noise_aug=jnp.asarray(noise_aug),
                                initial_noise=jnp.asarray(init_noise)), np.float32)
    want_frames = np.asarray(jpipe._decode(params["vae"], jnp.asarray(want_lat)))
    kw = dict(noise_aug=torch.from_numpy(noise_aug), initial_noise=torch.from_numpy(init_noise))
    got_lat = tpipe(image[0], image[1], output_type="latent", **kw)
    assert got_lat.shape == (2, T, H // 2, W // 2, 4)
    np.testing.assert_allclose(got_lat.numpy(), want_lat, rtol=1e-4, atol=2e-4)
    got_frames = tpipe.decode_latents(torch.tensor(want_lat)).numpy()
    np.testing.assert_allclose(got_frames, want_frames, rtol=1e-4, atol=2e-4)
    # the whole call, from the pair already stacked
    got_all = tpipe(image, **kw)
    assert got_all.shape == (2, T, H, W, 3)
    np.testing.assert_allclose(got_all, want_frames, rtol=1e-4, atol=2e-4)
    # the two streams differ, and each depends on the other's frame (joint attention)
    assert np.abs(got_lat[0].numpy() - got_lat[1].numpy()).max() > 1e-3
    other = tpipe(image[0], image[1] * 0.5, output_type="latent", **kw)
    assert (other[0] - got_lat[0]).abs().max() > 1e-4


def test_trans_pipeline_refuses_an_odd_batch(trans):
    tpipe = trans[2]
    with pytest.raises(ValueError, match="pairs"):
        tpipe(noise(3)[0])


def test_trans_sequential_cfg_matches_batched(trans):
    """The halves [x_u, y_u] and [x_c, y_c] through the half-batch UNet (mask (0, 1), LoRA
    masks halved) on the same parameters equal the batched [x_u, y_u, x_c, y_c] call."""
    _, _, tpipe, tconf = trans
    seq = torch_pipeline(StableVideoDiffusionTransPipeline, tconf, sequential_cfg=True)
    for src, dst in zip(tpipe.models, seq.models):
        dst.load_state_dict(src.state_dict(), strict=True)
    assert seq.unet_seq.config.joint.mask == (0, 1)
    assert seq.unet_seq.down_blocks[0].attentions[0].transformer_blocks[0].attn1n.to_k.weight \
        is seq.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1n.to_k.weight
    image, noise_aug, init_noise = noise(2, seed=6)
    kw = dict(output_type="latent", noise_aug=torch.from_numpy(noise_aug),
              initial_noise=torch.from_numpy(init_noise))
    np.testing.assert_allclose(seq(image, **kw).numpy(), tpipe(image, **kw).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_base_sequential_cfg_matches_batched():
    unet_config = tcfg.SVDUNetConfig(**TINY_UNET)
    batched = torch_pipeline(StableVideoDiffusionPipeline, unet_config)
    batched.init_params(torch.Generator().manual_seed(3))
    seq = torch_pipeline(StableVideoDiffusionPipeline, unet_config, sequential_cfg=True)
    for src, dst in zip(batched.models, seq.models):
        dst.load_state_dict(src.state_dict(), strict=True)
    image, noise_aug, init_noise = noise(1, seed=7)
    kw = dict(output_type="latent", noise_aug=torch.from_numpy(noise_aug),
              initial_noise=torch.from_numpy(init_noise))
    np.testing.assert_allclose(seq(image, **kw).numpy(), batched(image, **kw).numpy(),
                               rtol=2e-4, atol=2e-4)


TINY_WIDTHS = cli.Widths(unet=TINY_UNET, vae=tcfg.TemporalVAEConfig(**TINY_VAE),
                         clip=tcfg.CLIPVisionConfig(**TINY_CLIP))


@pytest.mark.parametrize("extra", [
    ["--flip", "--temporal", "--lora-rank", "2"],
    ["--post-joint", "conv_fuse", "--sequential-cfg", "--nospatial", "--temporal"],
    ["--post-joint", "scale", "--knowledge-fusion"]], ids=["lora", "conv_fuse_seq", "scale"])
def test_cli_trans_mode_tiny_on_cpu(tmp_path, extra):
    import imageio.v3 as iio

    from lkgd_torch.data.video_io import load_input

    rng = np.random.default_rng(1)
    for name in ("a.png", "b.png"):
        iio.imwrite(str(tmp_path / name), (rng.uniform(size=(40, 60, 3)) * 255).astype(np.uint8))
    out = str(tmp_path / "out.gif")
    cli.main(["--mode", "trans", "--image", str(tmp_path / "a.png"), "--end-image",
              str(tmp_path / "b.png"), "--output", out, "--height", str(H), "--width", str(W),
              "--num-frames", str(T), "--num-inference-steps", "2", "--device", "cpu",
              "--dtype", "fp32", *extra], TINY_WIDTHS)
    frames = load_input(out)
    assert frames.shape == (T, H, 2 * W, 3) and np.isfinite(frames).all()


def test_cli_trans_unet_config_follows_the_flags():
    """The two LoRA rules of the JAX CLI, and the joint topology from the flags."""
    args = cli.make_parser().parse_args(
        ["--mode", "trans", "--image", "a.png", "--joint-mask", "0,0,1,1", "--flip",
         "--temporal", "--nospatial", "--post-joint", "scale", "--lora-rank", "4"])
    config = cli.unet_config(args)
    assert config.joint == tcfg.JointAttentionConfig(post="scale", flip=True, mask=(0, 0, 1, 1),
                                                     spatial=False, temporal=True)
    assert [(r.pattern, r.name, r.rank, r.alpha, r.streams) for r in config.lora.rules] == [
        ("*attn1n*", "yx_lora", 4, 4, (0, 0, 1, 1)),
        ("*temporal_transformer_blocks*attn1.*", "xy_lora", 4, 4, (1, 1, 0, 0))]
    assert config.block_out_channels == (320, 640, 1280, 1280)
    base = cli.unet_config(cli.make_parser().parse_args(["--image", "a.png"]))
    assert base.joint is None and base.lora.rules == ()
