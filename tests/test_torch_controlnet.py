"""ControlNet-SDV in the port (``lkgd_torch.models.controlnet_svd``,
``lkgd_torch.pipelines.svd_controlnet``) against ``lkgd_tpu`` at fp32, on the tiny configs
of ``tests/test_pipelines_variants.py:18-37`` (64x64, 4 frames, a VAE that downsamples by
4, an embedder of two stride-2 convolutions) with 2-step loops: the weight export and a
strict load, the ControlNet's residuals with every zero-init tensor random, the UNet with
residuals, ``init_from_unet``, and the pipeline's latents and frames (batched,
``sequential_cfg``, ``reverse_time``, trans+ControlNet at ``controlnet_cond_scale=0.5,
controlnet_scale=0.8``) with JAX's noise injected, at rtol 1e-4, atol 2e-4 (fp32 rounding
through the composed UNet, as the other pipelines' tests). A control input changes nothing
at init (zero heads), and the CLI's ``--mode controlnet`` runs at tiny widths on the CPU.

The tiny configurations here are shared with ``test_torch_deep_cache.py`` and
``test_torch_flow.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import configs as jcfg  # noqa: E402
from lkgd_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPConfig  # noqa: E402
from lkgd_tpu.models.controlnet_svd import ControlNetSDV as JaxControlNet  # noqa: E402
from lkgd_tpu.models.controlnet_svd import ControlNetSDVConfig as JaxCNConfig  # noqa: E402
from lkgd_tpu.models.controlnet_svd import init_from_unet as jax_init_from_unet  # noqa: E402
from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition as JaxUNet  # noqa: E402
from lkgd_tpu.models.vae_temporal import TemporalVAEConfig as JaxVAEConfig  # noqa: E402
from lkgd_tpu.pipelines.svd import SVDPipelineConfig as JaxPipeConfig  # noqa: E402
from lkgd_tpu.pipelines.svd_controlnet import (  # noqa: E402
    StableVideoDiffusionControlNetPipeline as JaxCNPipeline)
from lkgd_tpu.utils.porting import export_state_dict, svd_export_key_map  # noqa: E402

from lkgd_torch.cli import run_inference_svd as cli  # noqa: E402
from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.controlnet_svd import ControlNetSDV, ControlNetSDVConfig  # noqa: E402
from lkgd_torch.models.controlnet_svd import init_from_unet  # noqa: E402
from lkgd_torch.models.layers import init_params, materialize  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.pipelines.svd import SVDPipelineConfig  # noqa: E402
from lkgd_torch.pipelines.svd_controlnet import (  # noqa: E402
    StableVideoDiffusionControlNetPipeline)

from tests.test_torch_porting import load_jax_params, port_state_dict, randomize  # noqa: E402

# tests/test_pipelines_variants.py:18-37
S, T, STEPS = 64, 4, 2
LAT = S // 4
UNET = dict(block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
            up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
            layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=32)
VAE = dict(block_out_channels=(32, 64, 64), layers_per_block=1)
CLIP = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, projection_dim=32)  # CLIPVisionConfig.tiny()
PIPE = dict(height=S, width=S, num_frames=T, num_inference_steps=STEPS, decode_chunk_size=2)
EMB = (16, 32, 96)  # two stride-2 convolutions: the VAE's factor of 4
TOL = dict(rtol=1e-4, atol=2e-4)


def joint_configs():
    """(JAX, port) JOINT_UNET of tests/test_pipelines_variants.py:18-28."""
    out = []
    for c in (jcfg, tcfg):
        joint = c.JointAttentionConfig(post="conv", flip=True, mask=(0, 1, 0, 1), spatial=True,
                                       temporal=True)
        lora = c.LoraRouter(rules=(
            c.LoraRule(pattern="*attn1n*", name="yx", rank=2, streams=(0, 1, 0, 1)),
            c.LoraRule(pattern="*temporal*attn1.*", name="xy", rank=2, streams=(1, 0, 1, 0))))
        out.append(c.SVDUNetConfig(**UNET, joint=joint, lora=lora))
    return tuple(out)


def jax_kw(**pipe_kw):
    return dict(config=JaxPipeConfig(**{**PIPE, **pipe_kw}), vae_config=JaxVAEConfig(**VAE),
                clip_config=JaxCLIPConfig(**CLIP), dtype=jnp.float32)


def torch_kw(**pipe_kw):
    return dict(config=SVDPipelineConfig(**{**PIPE, **pipe_kw}),
                vae_config=tcfg.TemporalVAEConfig(**VAE), clip_config=tcfg.CLIPVisionConfig(**CLIP),
                dtype=torch.float32, device="cpu")


def draws(streams: int, seed: int, latent_streams: int = None):
    """Images in [0, 1], augmentation normals and initial latent normals, numpy."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(streams, S, S, 3)).astype(np.float32),
            rng.standard_normal((streams, S, S, 3)).astype(np.float32),
            rng.standard_normal((latent_streams or streams, T, LAT, LAT, 4)).astype(np.float32))


def close(got, want, err=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=err, **TOL)


# ------------------------------------------------------------------ the models alone
def _model_inputs(rows=2, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, T, LAT, LAT, 8)).astype(np.float32),
            np.full((rows,), 0.25 * np.log(7.0), np.float32),
            rng.standard_normal((rows, 1, 32)).astype(np.float32),
            np.asarray([[6.0, 127.0, 0.02]] * rows, np.float32),
            rng.uniform(size=(rows, T, S, S, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def models():
    """JAX ControlNet and UNet params, every leaf random, and the port's models with them."""
    sample, ts, ehs, ids, control = _model_inputs()
    jcn = JaxControlNet(JaxCNConfig(unet=jcfg.SVDUNetConfig(**UNET),
                                    conditioning_embedding_out_channels=EMB))
    junet = JaxUNet(jcfg.SVDUNetConfig(**UNET))
    cparams = randomize(jax.eval_shape(lambda: jcn.init(jax.random.PRNGKey(0), sample, ts, ehs,
                                                        ids, controlnet_cond=control)), seed=21)
    uparams = randomize(jax.eval_shape(lambda: junet.init(jax.random.PRNGKey(1), sample, ts,
                                                          ehs, ids)), seed=22)
    tcn = ControlNetSDV(ControlNetSDVConfig(unet=tcfg.SVDUNetConfig(**UNET),
                                            conditioning_embedding_out_channels=EMB))
    tcn.load_state_dict(port_state_dict(cparams), strict=True)
    tunet = UNetSpatioTemporalCondition(tcfg.SVDUNetConfig(**UNET))
    tunet.load_state_dict(port_state_dict(uparams), strict=True)
    # one compiled ControlNet for every scale, one UNet with residuals
    residuals = jax.jit(lambda p, scale, *a: jcn.apply(p, *a[:4], controlnet_cond=a[4],
                                                       conditioning_scale=scale))
    unet = jax.jit(lambda p, d, m, ind, *a: junet.apply(
        p, *a, down_block_additional_residuals=d, mid_block_additional_residual=m,
        image_only_indicator=ind))
    return dict(cparams=cparams, uparams=uparams, tcn=tcn.eval(), tunet=tunet.eval(),
                residuals=residuals, unet=unet, inputs=(sample, ts, ehs, ids, control))


def test_controlnet_export_names_load_strictly(models):
    """The port's names are those of ``export_state_dict(params, svd_export_key_map)``,
    with the same values; ``load_state_dict(strict=True)`` took them (the fixture)."""
    want = export_state_dict(models["cparams"], key_map=svd_export_key_map)
    got = port_state_dict(models["cparams"])
    assert sorted(got) == sorted(want) == sorted(models["tcn"].state_dict())
    assert "controlnet_cond_embedding.blocks.3.weight" in got
    assert "controlnet_down_blocks.3.weight" in got and "controlnet_mid_block.bias" in got
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)


@pytest.mark.parametrize("scale", [1.0, 0.8])
def test_controlnet_residuals_match_jax(models, scale):
    """Every tensor random, zero heads and the embedder's ``conv_out`` included."""
    args = models["inputs"]
    down, mid = models["residuals"](models["cparams"], scale, *args)
    with torch.no_grad():
        tdown, tmid = models["tcn"](*(torch.from_numpy(a) for a in args[:4]),
                                    controlnet_cond=torch.from_numpy(args[4]),
                                    conditioning_scale=scale)
    assert len(tdown) == len(down) == 4
    for i, (g, w) in enumerate(zip(tdown, down)):
        assert g.shape == w.shape
        close(g, w, f"down residual {i}")
    close(tmid, mid, "mid residual")


def test_unet_with_residuals_matches_jax(models):
    """The residuals are added to every skip and after the mid block (each reshaped and
    cast), here with an image-only indicator that flags one frame."""
    sample, ts, ehs, ids, control = models["inputs"]
    down, mid = models["residuals"](models["cparams"], 1.0, *models["inputs"])
    indicator = np.zeros((2, T), np.float32)
    indicator[1, 2] = 1.0
    want = models["unet"](models["uparams"], down, mid, indicator, sample, ts, ehs, ids)
    with torch.no_grad():
        got = models["tunet"](*(torch.from_numpy(a) for a in (sample, ts, ehs, ids)),
                              down_block_additional_residuals=[torch.tensor(np.asarray(d))
                                                               for d in down],
                              mid_block_additional_residual=torch.tensor(np.asarray(mid)),
                              image_only_indicator=torch.from_numpy(indicator))
    close(got, want)
    with torch.no_grad():  # the residuals count
        plain = models["tunet"](*(torch.from_numpy(a) for a in (sample, ts, ehs, ids)),
                                image_only_indicator=torch.from_numpy(indicator))
    assert (plain - got).abs().max() > 1e-3


def test_init_from_unet_matches_jax():
    """Copies the encoder, mid block, embeddings and ``conv_in`` of a joint UNet with LoRA;
    the joint branch and the adapters, which the ControlNet lacks, are skipped; the zero
    heads and the embedder keep their values."""
    jconf, tconf = joint_configs()
    sample, ts, ehs, ids, control = _model_inputs(rows=4)
    jcn = JaxControlNet(JaxCNConfig(unet=jconf, conditioning_embedding_out_channels=EMB))
    cparams = randomize(jax.eval_shape(lambda: jcn.init(jax.random.PRNGKey(0), sample, ts, ehs,
                                                        ids, controlnet_cond=control)), seed=5)
    uparams = randomize(jax.eval_shape(lambda: JaxUNet(jconf).init(
        jax.random.PRNGKey(1), sample, ts, ehs, ids)), seed=6)
    want = port_state_dict(jax_init_from_unet(jcn, cparams, uparams))

    tcn = ControlNetSDV(ControlNetSDVConfig(unet=tconf, conditioning_embedding_out_channels=EMB))
    tcn.load_state_dict(port_state_dict(cparams), strict=True)
    tunet = UNetSpatioTemporalCondition(tconf)
    tunet.load_state_dict(port_state_dict(uparams), strict=True)
    before = {k: v.clone() for k, v in tcn.state_dict().items()}
    copied = init_from_unet(tcn, tunet)
    got = tcn.state_dict()
    # the JAX function copies whole subtrees, the UNet's joint branch and adapters with them
    extra = set(want) - set(got)
    assert extra and all("1n." in n or ".lora_" in n for n in extra), sorted(extra)[:5]
    assert set(got) <= set(want)
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
    moved = [n for n in got if not torch.equal(got[n], before[n])]
    assert copied == len(moved) > 0
    assert all(n.split(".")[0] in ("down_blocks", "mid_block", "time_embedding",
                                   "add_embedding", "conv_in") for n in moved)
    assert any(n.startswith("controlnet_down_blocks") for n in got)


def test_zero_init_heads():
    """``init_params`` zeroes the embedder's ``conv_out`` and every head, as the JAX
    module's ``kernel_init=zeros``; every other weight is drawn."""
    cn = materialize(lambda: ControlNetSDV(ControlNetSDVConfig(
        unet=tcfg.SVDUNetConfig(**UNET), conditioning_embedding_out_channels=EMB)), "cpu",
        torch.float32)
    init_params(cn, torch.Generator().manual_seed(0))
    zero = sorted(n for n, p in cn.named_parameters()
                  if n.endswith("weight") and not p.abs().sum())
    assert zero == sorted(["controlnet_cond_embedding.conv_out.weight",
                           "controlnet_mid_block.weight"]
                          + [f"controlnet_down_blocks.{i}.weight" for i in range(4)])


# ------------------------------------------------------------------ the pipeline
def _cn_configs(unet_pair):
    junet, tunet = unet_pair
    return (JaxCNConfig(unet=junet, conditioning_embedding_out_channels=EMB),
            ControlNetSDVConfig(unet=tunet, conditioning_embedding_out_channels=EMB))


def _pipelines(unet_pair, **kw):
    """(JAX, port) ControlNet pipelines on one UNet config pair; ``kw``: the pipelines'
    options, ``sequential_cfg`` going into the pipeline config."""
    seq = kw.pop("sequential_cfg", False)
    jcn, tcn = _cn_configs(unet_pair)
    jpipe = JaxCNPipeline(unet_config=unet_pair[0], controlnet_config=jcn,
                          **jax_kw(sequential_cfg=seq), **kw)
    tpipe = StableVideoDiffusionControlNetPipeline(
        unet_config=unet_pair[1], controlnet_config=tcn, **torch_kw(sequential_cfg=seq), **kw)
    return jpipe, tpipe


def _load(tpipe, params):
    load_jax_params(tpipe, params)
    tpipe.controlnet.load_state_dict(port_state_dict(params["controlnet"]), strict=True)


PLAIN = (jcfg.SVDUNetConfig(**UNET), tcfg.SVDUNetConfig(**UNET))
CASES = {"batched": (PLAIN, {}), "sequential_cfg": (PLAIN, {"sequential_cfg": True}),
         "reverse_time": (PLAIN, {"reverse_time": True}),
         "trans": ("joint", {"controlnet_cond_scale": 0.5, "controlnet_scale": 0.8})}


@pytest.fixture(scope="module")
def params():
    """Random params (every leaf) for the plain and the joint ControlNet pipelines."""
    out = {}
    for key, pair in (("plain", PLAIN), ("joint", joint_configs())):
        jpipe, _ = _pipelines(pair)
        out[key] = randomize(jax.eval_shape(jpipe.init_params, jax.random.PRNGKey(0)),
                             seed=31 if key == "plain" else 32)
    out["decode"] = jpipe._decode  # one compiled decode for every case
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_controlnet_pipeline_matches_jax(params, case):
    pair, kw = CASES[case]
    joint = pair == "joint"
    pair = joint_configs() if joint else pair
    jpipe, tpipe = _pipelines(pair, **dict(kw))
    p = params["joint" if joint else "plain"]
    _load(tpipe, p)
    streams = 2 if joint else 1
    image, noise_aug, init_noise = draws(streams, seed=7)
    control = np.random.default_rng(8).uniform(size=(T, S, S, 3)).astype(np.float32)
    want = np.asarray(jpipe(p, image, control=control, output_type="latent",
                            noise_aug=jnp.asarray(noise_aug),
                            initial_noise=jnp.asarray(init_noise)))
    want_frames = np.asarray(params["decode"](p["vae"], jnp.asarray(want)))
    got = tpipe(image, control=control, output_type="latent",
                noise_aug=torch.from_numpy(noise_aug), initial_noise=torch.from_numpy(init_noise))
    assert got.shape == (streams, T, LAT, LAT, 4)
    close(got, want, "latents")
    close(tpipe.decode_latents(got), want_frames, "frames")
    if case == "batched":  # the control reaches the output: zeros give other latents
        other = tpipe(image, output_type="latent", noise_aug=torch.from_numpy(noise_aug),
                      initial_noise=torch.from_numpy(init_noise))
        assert (other - got).abs().max() > 1e-3


def test_control_changes_nothing_at_init():
    """``init_params`` leaves the heads zero, so a control input changes no output."""
    _, tpipe = _pipelines(PLAIN)
    tpipe.init_params(torch.Generator().manual_seed(0))
    image, noise_aug, init_noise = draws(1, seed=9)
    control = np.random.default_rng(10).uniform(size=(T, S, S, 3)).astype(np.float32)
    kw = dict(noise_aug=torch.from_numpy(noise_aug), initial_noise=torch.from_numpy(init_noise))
    with_control = tpipe(image, control=control, **kw)
    without = tpipe(image, **kw)
    np.testing.assert_allclose(with_control, without, atol=1e-5)


def test_controlnet_pipeline_refuses_deep_cache():
    with pytest.raises(ValueError, match="deep_cache_interval"):
        StableVideoDiffusionControlNetPipeline(unet_config=PLAIN[1],
                                               **torch_kw(deep_cache_interval=2))


TINY_WIDTHS = cli.Widths(unet=UNET, vae=tcfg.TemporalVAEConfig(**VAE),
                         clip=tcfg.CLIPVisionConfig(**CLIP), controlnet_embedding=EMB)


@pytest.mark.parametrize("extra", [[], ["--control-video", "VIDEO", "--reverse-time",
                                        "--controlnet-cond-scale", "0.5"]])
def test_cli_controlnet_mode_tiny_on_cpu(tmp_path, extra):
    import imageio.v3 as iio

    from lkgd_torch.data.video_io import load_input

    rng = np.random.default_rng(3)
    iio.imwrite(str(tmp_path / "a.png"), (rng.uniform(size=(40, 60, 3)) * 255).astype(np.uint8))
    frames = tmp_path / "control"
    frames.mkdir()
    for i in range(T + 1):  # one frame more than is used
        iio.imwrite(str(frames / f"{i:03d}.png"),
                    (rng.uniform(size=(40, 60, 3)) * 255).astype(np.uint8))
    extra = [str(frames) if a == "VIDEO" else a for a in extra]
    out = str(tmp_path / "out.gif")
    cli.main(["--mode", "controlnet", "--image", str(tmp_path / "a.png"), "--output", out,
              "--height", str(S), "--width", str(S), "--num-frames", str(T),
              "--num-inference-steps", str(STEPS), "--device", "cpu", "--dtype", "fp32",
              *extra], TINY_WIDTHS)
    video = load_input(out)
    assert video.shape == (T, S, S, 3) and np.isfinite(video).all()
    args = cli.make_parser().parse_args(["--mode", "controlnet", "--image", "a.png", *extra])
    pipe_args = (args.reverse_time, args.controlnet_cond_scale)
    assert pipe_args == ((True, 0.5) if extra else (False, 1.0))
