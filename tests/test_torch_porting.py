"""lkgd_torch weight porting: the numpy ``from_flax_params`` against the JAX package's
``export_state_dict``, strict loads into the port's modules, and the port's independence
from jax. Also holds the helpers the other ``test_torch_*`` files share: the tiny
configs of ``tests/test_pipeline_torch_oracle.py`` and JAX->port weight loading."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# the suite runs in several worker processes on a few cores: each worker imports every
# test file, and two intra-op threads apiece keep torch from oversubscribing the cores
torch.set_num_threads(2)

from lkgd_tpu.models.clip_vision import CLIPVisionConfig as JaxCLIPConfig  # noqa: E402
from lkgd_tpu.models.configs import SVDUNetConfig as JaxUNetConfig  # noqa: E402
from lkgd_tpu.models.vae_temporal import TemporalVAEConfig as JaxVAEConfig  # noqa: E402
from lkgd_tpu.pipelines.svd import SVDPipelineConfig as JaxPipeConfig  # noqa: E402
from lkgd_tpu.pipelines.svd import StableVideoDiffusionPipeline as JaxPipeline  # noqa: E402
from lkgd_tpu.utils.porting import (clip_export_key_map, export_state_dict,  # noqa: E402
                                    svd_export_key_map, vae_export_key_map)

from lkgd_torch.models import configs as tcfg  # noqa: E402
from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition  # noqa: E402
from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline  # noqa: E402
from lkgd_torch.utils.porting import clip_key_map, from_flax_params, vae_key_map  # noqa: E402

# the tiny end-to-end configuration of tests/test_pipeline_torch_oracle.py:35-46
H = W = 48
T, STEPS = 4, 3
TINY_UNET = dict(
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
    up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
    layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=64)
TINY_CLIP = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=2,
                 intermediate_size=128, projection_dim=64)
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1)
TINY_PIPE = dict(height=H, width=W, num_frames=T, num_inference_steps=STEPS,
                 decode_chunk_size=2)
KEY_MAPS = {"unet": None, "vae": vae_key_map, "image_encoder": clip_key_map}
EXPORT_MAPS = {"unet": svd_export_key_map, "vae": vae_export_key_map,
               "image_encoder": clip_export_key_map}


# XLA:CPU options for the JAX references the port's tests compile: LLVM's cheap pipeline
# takes about a third off each compile at tiny widths; the HLO passes are the default ones
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jit(fn, **kw):
    """``jax.jit`` of a JAX reference, compiled with ``FAST_COMPILE``."""
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def flatten(params) -> dict:
    """A flax tree as ``/``-joined paths -> numpy leaves."""
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def randomize(params, seed=11, scale=0.15):
    """Random normals in every leaf of ``params`` (arrays or shape structs); zero-init
    leaves would hide their subgraphs."""
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        jnp.asarray(rng.normal(size=np.shape(l), scale=scale), jnp.float32) for l in leaves])


def port_state_dict(params, key_map=None) -> dict:
    """A flax param tree -> the port's state dict, through the numpy porter."""
    return from_flax_params(flatten(params), key_map=key_map)


def tiny_jax_pipeline() -> JaxPipeline:
    return JaxPipeline(config=JaxPipeConfig(**TINY_PIPE),
                       unet_config=JaxUNetConfig(**TINY_UNET),
                       vae_config=JaxVAEConfig(**TINY_VAE),
                       clip_config=JaxCLIPConfig(**TINY_CLIP), dtype=jnp.float32)


def tiny_torch_pipeline(device="cpu") -> StableVideoDiffusionPipeline:
    return StableVideoDiffusionPipeline(
        config=SVDPipelineConfig(**TINY_PIPE), unet_config=tcfg.SVDUNetConfig(**TINY_UNET),
        vae_config=tcfg.TemporalVAEConfig(**TINY_VAE),
        clip_config=tcfg.CLIPVisionConfig(**TINY_CLIP), dtype=torch.float32, device=device)


def load_jax_params(pipe: StableVideoDiffusionPipeline, params) -> None:
    """Load the JAX pipeline's params into the port pipeline, strictly."""
    for name, model in zip(("unet", "vae", "image_encoder"), pipe.models):
        model.load_state_dict(port_state_dict(params[name], KEY_MAPS[name]), strict=True)


def tiny_jax_params(pipe: JaxPipeline, seed: int = 11):
    """Random params for the tiny JAX pipeline; the tree's shapes come from eval_shape
    (tracing only), its values from numpy."""
    return randomize(jax.eval_shape(pipe.init_params, jax.random.PRNGKey(0)), seed=seed)


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params(tiny_jax_pipeline())


@pytest.mark.parametrize("model", ["unet", "vae", "image_encoder"])
def test_from_flax_params_matches_export(jax_params, model):
    """Same names and identical values as the JAX package's exporter."""
    want = export_state_dict(jax_params[model], key_map=EXPORT_MAPS[model])
    got = port_state_dict(jax_params[model], KEY_MAPS[model])
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)


def test_strict_load_into_port_modules(jax_params):
    pipe = tiny_torch_pipeline()
    load_jax_params(pipe, jax_params)  # strict=True raises on any missing/extra name
    got = pipe.unet.state_dict()["down_blocks.0.resnets.0.temporal_res_block.conv1.weight"]
    want = export_state_dict(jax_params["unet"])[
        "down_blocks.0.resnets.0.temporal_res_block.conv1.weight"]
    assert got.shape == want.shape == (32, 32, 3, 1, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_is_seeded_and_shaped():
    """Random weights come from the generator alone: equal seeds, equal weights."""
    a, b = tiny_torch_pipeline(), tiny_torch_pipeline()
    a.init_params(torch.Generator().manual_seed(3))
    b.init_params(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.unet.state_dict().items(), b.unet.state_dict().values()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa).all(), name
    mix = a.unet.state_dict()["down_blocks.0.resnets.0.time_mixer.mix_factor"]
    assert mix.item() == 0.5


def test_port_imports_no_jax():
    """The machine with the card has no JAX and no transformers, and the port shares no
    module with the JAX package: importing every module under ``lkgd_torch/`` and
    ``chip_smoke`` (import only) pulls in none of jax, jaxlib, flax, optax, transformers or
    lkgd_tpu, and no source file of the port imports transformers anywhere. The modules of
    the latest slices are among them (``parallel/pp.py``; the fp32 backward's source and
    its C entries among the kernels the build binds)."""
    code = ("import importlib, pkgutil, sys, lkgd_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(lkgd_torch.__path__, 'lkgd_torch.')]\n"
            "for name in names + ['chip_smoke']:\n"
            "    importlib.import_module(name)\n"
            "assert len(names) > 70, names\n"
            "new = ['lkgd_torch.utils.inversion', 'lkgd_torch.ops.quantization', "
            "'lkgd_torch.parallel.sequence', 'lkgd_torch.parallel.mesh', "
            "'lkgd_torch.cli.verify_parity', 'lkgd_torch.cli.collect_env', "
            "'lkgd_torch.cli.web_demo', 'lkgd_torch.cli.gradio_demo', "
            "'lkgd_torch.parallel.pp']\n"
            "assert set(new) <= set(names), sorted(set(new) - set(names))\n"
            "from lkgd_torch.ops import _build\n"
            "assert 'flash_attention_bwd_f32.cu' in [p.name for p in _build.SOURCES]\n"
            "assert {'lkgd_flash_bwd_f32', 'lkgd_flash_bwd_f32_smem_bytes'} <= set(_build._SIGNATURES)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'transformers', 'lkgd_tpu'))\n"
            "print(len(names), bad); sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=180, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sources = sorted((root / "lkgd_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert not [str(f) for f in sources if any(
        line.lstrip().startswith(("import transformers", "from transformers"))
        for line in f.read_text().splitlines())]


def test_video_io_copy_matches_jax_package(tmp_path):
    """The port's own ``video_io`` gives the arrays of ``lkgd_tpu.data.video_io``: the
    resize and centre crop of ``process_frames`` (down and up), and a GIF and a PNG written
    by one and read by the other."""
    from lkgd_tpu.data import video_io as theirs

    from lkgd_torch.data import video_io as ours

    frames = np.random.default_rng(0).uniform(size=(3, 40, 56, 3)).astype(np.float32)
    for size in ((24, 24), (64, 96)):
        np.testing.assert_array_equal(ours.process_frames(frames, *size),
                                      theirs.process_frames(frames, *size))
    for module, name in ((ours, "ours"), (theirs, "theirs")):
        module.write_video(str(tmp_path / f"{name}.gif"), frames, fps=7)
    for name in ("ours", "theirs"):
        path = str(tmp_path / f"{name}.gif")
        got, want = ours.load_input(path), theirs.load_input(path)
        assert got.shape == frames.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours.load_input(str(tmp_path / "ours.gif")),
                                  ours.load_input(str(tmp_path / "theirs.gif")))
    import imageio.v3 as iio

    iio.imwrite(str(tmp_path / "frame.png"), (frames[0] * 255).astype(np.uint8))
    np.testing.assert_array_equal(ours.load_input(str(tmp_path / "frame.png")),
                                  theirs.load_input(str(tmp_path / "frame.png")))


def test_gif_without_imageio_is_the_same_file(tmp_path, monkeypatch):
    """Where imageio is missing (the card's machine), PIL writes the GIF: byte for byte the
    file imageio writes."""
    from lkgd_torch.data import video_io

    frames = np.random.default_rng(1).uniform(size=(3, 24, 40, 3)).astype(np.float32)
    video_io.write_video(str(tmp_path / "imageio.gif"), frames, fps=5)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    video_io.write_video(str(tmp_path / "pil.gif"), frames, fps=5)
    with pytest.raises(ImportError):
        video_io.write_video(str(tmp_path / "clip.mp4"), frames)
    assert (tmp_path / "pil.gif").read_bytes() == (tmp_path / "imageio.gif").read_bytes()


@pytest.mark.parametrize("entry", ["pipeline", "trans_pipeline", "smooth_pipeline", "loader",
                                   "controlnet_pipeline", "flow_pipeline", "joint_vf_pipeline",
                                   "inference_cli", "smooth_cli", "controlnet_cli", "flow_cli",
                                   "training_cli",
                                   "trans_training_cli", "matmul_microbench",
                                   "flash_variant_microbench", "flash_bwd_ab", "kernel_ab",
                                   "group_norm_ab", "cogvideox_i2v_pipeline",
                                   "cogvideox_t2v_pipeline", "cogvideox_v2v_pipeline",
                                   "cogvideox_cli", "unimatch", "train_cogvideox_lora",
                                   "embed_text", "t5_encoder", "sd2d_inpaint_pipeline",
                                   "sd2d_joint_control_pipeline", "sd2d_condition_pipeline",
                                   "sd2d_cli", "sd2d_training", "precompute_cache_cli",
                                   "compute_metrics_cli", "inception", "i3d", "annotate_cli",
                                   "raft", "rife", "dpt", "depth_anything", "hed", "pidinet",
                                   "lineart", "lineart_anime", "openpose", "segformer", "blip",
                                   "cogvlm", "caption_cli", "cogvideox_sp_cli",
                                   "verify_parity_cli", "collect_env_cli", "web_demo_cli",
                                   "web_demo_cogvideox", "gradio_demo_cli"])
def test_default_device_is_the_card_and_its_absence_raises(entry, tmp_path):
    """Every entry point defaults to the card; where there is none (here) it raises with a
    message that names the CPU switch, instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default does not raise")
    from lkgd_torch.cli import (annotate, caption, collect_env, compute_metrics, embed_text,
                                gradio_demo, precompute_cache, run_inference_cogvideox,
                                run_inference_sd2d, run_inference_svd, train_cogvideox_lora,
                                train_svd_lora, verify_parity, web_demo)
    from lkgd_torch.eval.fid_inception import build_inception
    from lkgd_torch.eval.i3d import build_i3d
    from lkgd_torch.data.datasets import PrefetchLoader
    from lkgd_torch.experiments import (flash_bwd_ab, flash_variant_microbench, group_norm_ab,
                                        kernel_ab, matmul_microbench)
    from lkgd_torch.models import (blip, cogvlm, hed, lineart, lineart_anime, openpose,
                                   pidinet, segformer)
    from lkgd_torch.models.depth_anything import DepthAnythingConfig, build_depth_anything
    from lkgd_torch.models.midas import MidasConfig, build_dpt
    from lkgd_torch.models.raft import RAFTConfig, build_raft
    from lkgd_torch.models.rife import build_rife
    from lkgd_torch.models.t5_text import build_t5_encoder
    from lkgd_torch.models.unimatch import UniMatchConfig, build_unimatch
    from lkgd_torch.pipelines import cogvideox_i2v as cog
    from lkgd_torch.pipelines import sd2d
    from lkgd_torch.training.sd2d import build_sd2d_training
    from lkgd_torch.pipelines.svd_controlnet import StableVideoDiffusionControlNetPipeline
    from lkgd_torch.pipelines.svd_flow import (StableVideoDiffusionFlowPipeline,
                                               StableVideoDiffusionJointVFPipeline)
    from lkgd_torch.pipelines.svd_smooth import StableVideoDiffusionSmoothPipeline
    from lkgd_torch.pipelines.svd_trans import StableVideoDiffusionTransPipeline

    tiny = dict(config=SVDPipelineConfig(**TINY_PIPE), unet_config=tcfg.SVDUNetConfig(**TINY_UNET),
                vae_config=tcfg.TemporalVAEConfig(**TINY_VAE),
                clip_config=tcfg.CLIPVisionConfig(**TINY_CLIP), dtype=torch.float32)
    calls = {
        "pipeline": lambda: StableVideoDiffusionPipeline(**tiny),
        "trans_pipeline": lambda: StableVideoDiffusionTransPipeline(**tiny),
        "smooth_pipeline": lambda: StableVideoDiffusionSmoothPipeline(**tiny),
        "loader": lambda: PrefetchLoader([{"x": np.zeros(2)}] * 2, batch_size=2),
        "controlnet_pipeline": lambda: StableVideoDiffusionControlNetPipeline(**tiny),
        "flow_pipeline": lambda: StableVideoDiffusionFlowPipeline(**tiny),
        "joint_vf_pipeline": lambda: StableVideoDiffusionJointVFPipeline(**tiny),
        "controlnet_cli": lambda: run_inference_svd.main(
            ["--mode", "controlnet", "--image", str(tmp_path / "a.png"), "--reverse-time",
             "--control-video", str(tmp_path / "control.mp4")]),
        "flow_cli": lambda: run_inference_svd.main(["--mode", "flow", "--image",
                                                    str(tmp_path / "a.png")]),
        "inference_cli": lambda: run_inference_svd.main(["--image", str(tmp_path / "a.png")]),
        "smooth_cli": lambda: run_inference_svd.main(["--mode", "smooth", "--image",
                                                      str(tmp_path / "clip.mp4")]),
        "training_cli": lambda: train_svd_lora.build(train_svd_lora.make_parser().parse_args(
            ["--output-dir", str(tmp_path)])),
        "trans_training_cli": lambda: train_svd_lora.build(
            train_svd_lora.make_parser().parse_args(["--output-dir", str(tmp_path), "--mode",
                                                     "trans", "--use-8bit-adam"])),
        "matmul_microbench": lambda: matmul_microbench.main([]),
        "flash_variant_microbench": lambda: flash_variant_microbench.main([]),
        "flash_bwd_ab": lambda: flash_bwd_ab.main([]),
        "kernel_ab": lambda: kernel_ab.main([]),
        "group_norm_ab": lambda: group_norm_ab.main([]),
        "cogvideox_i2v_pipeline": lambda: cog.CogVideoXImageToVideoPipeline(
            transformer_config=tcfg.CogVideoXConfig.tiny()),
        "cogvideox_t2v_pipeline": lambda: cog.CogVideoXTextToVideoPipeline(
            transformer_config=tcfg.CogVideoXConfig.cogvideox_2b()),
        "cogvideox_v2v_pipeline": lambda: cog.CogVideoXVideoToVideoPipeline(
            transformer_config=tcfg.CogVideoXConfig.cogvideox_2b()),
        "cogvideox_cli": lambda: run_inference_cogvideox.main(["--image",
                                                              str(tmp_path / "a.png")]),
        "unimatch": lambda: build_unimatch(UniMatchConfig.tiny()),
        "train_cogvideox_lora": lambda: train_cogvideox_lora.build(
            train_cogvideox_lora.make_parser().parse_args(["--tiny", "--output-dir",
                                                           str(tmp_path)])),
        "embed_text": lambda: embed_text.main(["--tiny", "--prompt", "a", "--output",
                                               str(tmp_path / "e.npy")]),
        "t5_encoder": lambda: build_t5_encoder(tcfg.T5Config.tiny()),
        "sd2d_inpaint_pipeline": lambda: sd2d.StableDiffusionInpaintPipeline(),
        "sd2d_joint_control_pipeline": lambda: sd2d.StableDiffusionJointControlPipeline(),
        "sd2d_condition_pipeline": lambda: sd2d.StableDiffusionConditionPipeline(),
        "sd2d_cli": lambda: run_inference_sd2d.main(["--image", str(tmp_path / "a.png")]),
        "sd2d_training": lambda: build_sd2d_training(tcfg.UNet2DConfig()),
        "precompute_cache_cli": lambda: precompute_cache.main(
            ["--video-folder", str(tmp_path), "--output", str(tmp_path / "c.lkgd")]),
        "compute_metrics_cli": lambda: compute_metrics.main(
            ["--generated", str(tmp_path), "--reference", str(tmp_path)]),
        "inception": lambda: build_inception(),
        "i3d": lambda: build_i3d(),
        "annotate_cli": lambda: annotate.main(["--input", str(tmp_path), "--output",
                                               str(tmp_path / "labels")]),
        "raft": lambda: build_raft(RAFTConfig.tiny()),
        "rife": lambda: build_rife(),
        "dpt": lambda: build_dpt("hybrid", MidasConfig.tiny()),
        "depth_anything": lambda: build_depth_anything(DepthAnythingConfig.tiny()),
        "hed": lambda: hed.build_hed(),
        "pidinet": lambda: pidinet.build_pidinet(),
        "lineart": lambda: lineart.build_lineart(),
        "lineart_anime": lambda: lineart_anime.build_lineart_anime(),
        "openpose": lambda: openpose.build_openpose(),
        "segformer": lambda: segformer.build_segformer(segformer.SegformerConfig.tiny()),
        "blip": lambda: blip.build_blip(),
        "cogvlm": lambda: cogvlm.build_cogvlm(cogvlm.CogVLMConfig.tiny()),
        "caption_cli": lambda: caption.main(["--input", str(tmp_path), "--output",
                                             str(tmp_path / "c.json"), "--weights", "w.pth"]),
        "cogvideox_sp_cli": lambda: run_inference_cogvideox.main(
            ["--image", str(tmp_path / "a.png"), "--mesh", "context=2", "--sequence-parallel",
             "ring"]),
        "verify_parity_cli": lambda: verify_parity.main(
            ["check", "--record", str(tmp_path / "r.npz"), "--checkpoint", str(tmp_path)]),
        "collect_env_cli": lambda: collect_env.main([]),
        "web_demo_cli": lambda: web_demo.main(["--port", "0"]),
        "web_demo_cogvideox": lambda: web_demo.main(["--mode", "cogvideox", "--tiny"]),
        "gradio_demo_cli": lambda: gradio_demo.main([]),
    }
    with pytest.raises(RuntimeError, match="--device cpu"):
        calls[entry]()


@pytest.mark.parametrize("field,value,ported", [
    pytest.param("knowledge_fusion", True, True, id="knowledge_fusion-True"),
    pytest.param("joint", tcfg.JointAttentionConfig(mask=(0, 1, 0, 1)), True, id="joint-value1"),
    pytest.param("lora", tcfg.LoraRouter((tcfg.LoraRule("*attn1.*", "x"),)), True,
                 id="lora-value2"),
    pytest.param("dual_cond_conv_in", True, True, id="dual_cond_conv_in-True"),
    pytest.param("y_input_head_mask", (0, 1), True, id="y_input_head_mask-value4")])
def test_unported_unet_options_raise(field, value, ported):
    """Knowledge fusion, LoRA routing, joint attention, the flow variant's second input
    convolution and the y input head, each once refused or absent here, are ported now:
    the config takes them and the UNet builds with their parameters."""
    if not ported:
        with pytest.raises(NotImplementedError):
            tcfg.SVDUNetConfig(**{field: value})
        return
    config = tcfg.SVDUNetConfig(**TINY_UNET, **{field: value})
    assert getattr(config, field) == value
    with torch.device("meta"):
        names = [n for n, _ in UNetSpatioTemporalCondition(config).named_parameters()]
    marker = {"knowledge_fusion": "knowledge_fusion.", "lora": "lora_x_A",
              "joint": "transformer_blocks.0.attn1n.to_k.weight",
              "dual_cond_conv_in": "conv_in2_alpha", "y_input_head_mask": "conv_in_y.weight"}[field]
    assert any(marker in n for n in names)


@pytest.mark.parametrize("field,value,ported", [
    pytest.param("sequential_cfg", True, True, id="sequential_cfg-True-True"),
    pytest.param("deep_cache_interval", 2, True, id="deep_cache_interval-2-False")])
def test_unported_pipeline_options_raise(field, value, ported):
    """``sequential_cfg`` and DeepCache, once refused here, are ported: with the first the
    pipeline builds a second UNet on the first one's very parameters; the second runs in
    the base pipeline alone, and a pipeline with a loop of its own refuses it."""
    if not ported:
        with pytest.raises(NotImplementedError):
            SVDPipelineConfig(**{field: value})
        return
    kw = dict(config=SVDPipelineConfig(**TINY_PIPE, **{field: value}),
              unet_config=tcfg.SVDUNetConfig(**TINY_UNET),
              vae_config=tcfg.TemporalVAEConfig(**TINY_VAE),
              clip_config=tcfg.CLIPVisionConfig(**TINY_CLIP), dtype=torch.float32, device="cpu")
    pipe = StableVideoDiffusionPipeline(**kw)
    if field == "deep_cache_interval":
        from lkgd_torch.pipelines.svd_trans import StableVideoDiffusionTransPipeline

        assert pipe.config.deep_cache_interval == 2 and pipe.unet_seq is None
        with pytest.raises(ValueError, match="deep_cache_interval"):
            StableVideoDiffusionTransPipeline(**kw)
        return
    shared = dict(pipe.unet_seq.named_parameters())
    assert shared and all(p is shared[n] for n, p in pipe.unet.named_parameters())
