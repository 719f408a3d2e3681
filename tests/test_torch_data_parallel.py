"""The ``data`` and ``context`` axes and data-parallel training on ``torch.distributed``:
the SVD pipeline's ``mesh=``, CogVideoX's CFG rows over ``data``, the SVD CLI's three
parallel flags, ``train_svd_lora`` over every rank and ZeRO (``training/trainer.py``).

One launch of 4 gloo ranks (``tests/test_torch_tensor_parallel.py`` ``launch``) runs:

* the tiny SVD pipeline at ``data=2,context=2`` (the CFG rows over ``data``, the frames
  over ``context``, the decode's two chunks one a rank), with JAX's noise: against the
  port's unsharded pipeline at rtol/atol 2e-5 (the bound ``tests/test_pipeline.py:95-125``
  holds JAX's sharded pipeline to) and against the JAX package at the unsharded parity's
  rtol 1e-4 / atol 2e-4 (``tests/test_torch_pipeline.py``);
* the SVD pipeline with FSDP over ``model=4`` (``min_size=1``, more than 50 leaves split):
  the port's unsharded frames bit for bit, and JAX's at the same parity tolerance;
* the tiny CogVideoX I2V pipeline at ``data=2,context=2`` (Ulysses) against the port's
  unsharded one;
* the tiny trans, smooth, ControlNet and flow pipelines at ``data=2,context=2`` (each loop
  whole on every rank, the decode's chunks spread over ``context``), on JAX's weights and
  draws: against the JAX pipeline of the same class built with ``mesh=`` over 4 CPU devices
  (run in the test process while the ranks run) at the unsharded parity's rtol 1e-4 /
  atol 2e-4;
* the SVD CLI with ``--data-parallel 2 --context-parallel 2`` and with
  ``--model-parallel 4``: rank 0 writes the frames one process writes (FSDP bit for bit,
  the split rows and frames at rtol/atol 1e-4: the CLI's random weights at their fan-in
  scales); and in ``--mode`` trans, smooth, controlnet and flow with
  ``--data-parallel 2 --context-parallel 2``: rank 0 alone writes, the frames one process
  writes bit for bit (one thread a rank), the pipeline's loop split nowhere and its decode
  spread over ``context`` (smooth at 5 frames: 5 chunks, decoded whole on every rank);
* ``train_svd_lora``'s step over the 4 ranks (one row each) against one process on the
  whole 4-row batch: the averaged gradients at a 1% floor of each tensor's largest, the
  loss at rtol 1e-5;
* ZeRO over ``data=4`` on the tiny UNet of ``tests/test_zero.py``: two updates bit for bit
  those of the replicated moments on the same ranks, the moment bytes a rank about a
  quarter, and the loss and parameters of one process on the whole batch at the bounds
  ``tests/test_zero.py`` uses.

The ZeRO specs are held against ``lkgd_tpu.training.trainer.zero_shardings`` in the test
process. This module imports no JAX at import time.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_tensor_parallel import launch

WORLD = 4
H = W = 48
T = 4
TINY_UNET = dict(
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
    up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
    layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=64)
TINY_CLIP = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=2,
                 intermediate_size=128, projection_dim=64)
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1)
TINY_PIPE = dict(height=H, width=W, num_frames=T, num_inference_steps=3, decode_chunk_size=2)
SHARD_TOL = dict(rtol=2e-5, atol=2e-5)
JAX_TOL = dict(rtol=1e-4, atol=2e-4)
COG_PIPE = dict(height=32, width=32, num_frames=29, num_inference_steps=2)
CLI_ARGS = ["--height", str(H), "--width", str(W), "--num-frames", str(T),
            "--num-inference-steps", "2", "--decode-chunk-size", "2", "--device", "cpu",
            "--dtype", "fp32", "--seed", "3"]
LR = 1e-3
# the subclass pipelines at data=2,context=2: every loop whole on each rank, the decode's
# chunks spread over context
SUB_MODES = ("trans", "smooth", "controlnet", "flow")
SUB_CLASSES = {"trans": "StableVideoDiffusionTransPipeline",
               "smooth": "StableVideoDiffusionSmoothPipeline",
               "controlnet": "StableVideoDiffusionControlNetPipeline",
               "flow": "StableVideoDiffusionFlowPipeline"}
SUB_PIPE = dict(TINY_PIPE, num_inference_steps=2)
SMOOTH = dict(start_step=1, total_frames=4)  # 2 decode chunks of 2 frames
CN_EMBEDDING = (16, 32)  # one stride-2 convolution: TINY_VAE's factor of 2
# the joint UNet of trans and smooth: tests/test_pipelines_variants.py:18-28
JOINT = dict(post="conv", flip=True, mask=(0, 1, 0, 1), spatial=True, temporal=True)
RULES = (dict(pattern="*attn1n*", name="yx", rank=2, streams=(0, 1, 0, 1)),
         dict(pattern="*temporal*attn1.*", name="xy", rank=2, streams=(1, 0, 1, 0)))
# the CLI in each mode but base at --data-parallel 2 --context-parallel 2: name -> (flags,
# frames out, decode chunks in all); smooth at 5 frames makes 5 chunks of 1, which context=2
# does not divide
JOINT_FLAGS = ["--flip", "--temporal", "--lora-rank", "2"]
SMOOTH_FLAGS = ["--mode", "smooth", "--smooth-start-step", "1", *JOINT_FLAGS]
CLI_MODES = {"trans": (["--mode", "trans", *JOINT_FLAGS], T, 4),
             "smooth": (SMOOTH_FLAGS + ["--smooth-total-frames", "4"], 4, 2),
             "smooth_whole_decode": (SMOOTH_FLAGS + ["--smooth-total-frames", "5"], 5, 5),
             "controlnet": (["--mode", "controlnet"], T, 2),
             "flow": (["--mode", "flow"], T, 2)}
DATA_CONTEXT = ["--data-parallel", "2", "--context-parallel", "2"]


# ------------------------------------------------------------------ the ranks' side
def svd_pipeline(mesh=None):
    from lkgd_torch.models import configs as tcfg
    from lkgd_torch.pipelines.svd import SVDPipelineConfig, StableVideoDiffusionPipeline

    return StableVideoDiffusionPipeline(
        config=SVDPipelineConfig(**TINY_PIPE), unet_config=tcfg.SVDUNetConfig(**TINY_UNET),
        vae_config=tcfg.TemporalVAEConfig(**TINY_VAE),
        clip_config=tcfg.CLIPVisionConfig(**TINY_CLIP), dtype=torch.float32, device="cpu",
        mesh=mesh)


def subclass_pipeline(pkg: str, mode: str, **kw):
    """The tiny ``mode`` pipeline of ``pkg`` (``lkgd_torch``, or ``lkgd_tpu`` in the test
    process) at fp32; ``kw``: ``dtype``, ``mesh`` and the port's ``device``."""
    import importlib

    def of(module):
        return importlib.import_module(f"{pkg}.{module}")

    c = of("models.configs")
    joint = {}
    if mode in ("trans", "smooth"):
        joint = dict(joint=c.JointAttentionConfig(**JOINT),
                     lora=c.LoraRouter(tuple(c.LoraRule(**r) for r in RULES)))
    unet = c.SVDUNetConfig(**TINY_UNET, **joint)
    extra = {"smooth": SMOOTH, "controlnet": dict(
        controlnet_config=of("models.controlnet_svd").ControlNetSDVConfig(
            unet=unet, conditioning_embedding_out_channels=CN_EMBEDDING))}.get(mode, {})
    cls = getattr(of(f"pipelines.svd_{mode}"), SUB_CLASSES[mode])
    return cls(config=of("pipelines.svd").SVDPipelineConfig(**SUB_PIPE), unet_config=unet,
               vae_config=of("models.vae_temporal").TemporalVAEConfig(**TINY_VAE),
               clip_config=of("models.clip_vision").CLIPVisionConfig(**TINY_CLIP), **extra, **kw)


def _subclass_cases(work) -> dict:
    """Each subclass pipeline at ``data=2,context=2`` on JAX's weights and draws: its
    frames."""
    from lkgd_torch.parallel import mesh

    grid = mesh.make_mesh("data=2,context=2", "cpu")
    out = {}
    for mode in SUB_MODES:
        case = work["sub"][mode]
        pipe = subclass_pipeline("lkgd_torch", mode, dtype=torch.float32, device="cpu",
                                 mesh=grid)
        for name, sd in case["weights"].items():
            getattr(pipe, name).load_state_dict(sd, strict=True)
        out[f"sub_{mode}"] = pipe(*case["args"], output_type="pt", **case["kw"])
    return out


def _svd_run(pipe, work, fsdp_group=None) -> dict:
    """The pipeline's frames on the work's weights and noise; with ``fsdp_group`` its
    models are sharded over it (``min_size=1``) after the weights are loaded."""
    from lkgd_torch.parallel import tp

    for model, sd in zip(pipe.models, work["svd"]):
        model.load_state_dict(sd, strict=True)
    split = 0
    if fsdp_group is not None:
        params = [p for m in pipe.models for p in m.parameters()]
        numels = [p.numel() for p in params]
        for m in pipe.models:
            tp.fully_shard(m, fsdp_group, min_size=1)
        split = sum(p.numel() < n for p, n in zip(params, numels))
    return {"frames": pipe(work["image"], output_type="pt", noise_aug=work["noise_aug"],
                           initial_noise=work["initial_noise"]), "split": split}


def _svd_cases(work) -> dict:
    from lkgd_torch.parallel import mesh

    out = {"svd_whole": _svd_run(svd_pipeline(), work)}
    out["svd_data2_context2"] = _svd_run(svd_pipeline(mesh.make_mesh("data=2,context=2",
                                                                     "cpu")), work)
    grid = mesh.make_mesh(f"model={WORLD}", "cpu")
    out["svd_fsdp4"] = _svd_run(svd_pipeline(), work, grid.groups["model"])
    return out


def _cogvideox_cases(work) -> dict:
    from lkgd_torch.parallel import mesh
    from lkgd_torch.pipelines import cogvideox_i2v as cog
    from tests.test_torch_tensor_parallel import port_config

    out = {}
    for name, spec, sp in (("cog_whole", None, "none"),
                           ("cog_data2_context2", "data=2,context=2", "ulysses")):
        grid = mesh.make_mesh(spec, "cpu") if spec else None
        pipe = cog.CogVideoXImageToVideoPipeline(
            cog.CogVideoXPipelineConfig(**COG_PIPE), port_config(sequence_parallel=sp),
            dtype=torch.float32, device="cpu", mesh=grid)
        pipe.transformer.load_state_dict(work["cog"], strict=True)
        with torch.inference_mode():
            out[name] = pipe(work["prompt"], work["cog_image"],
                             initial_noise=work["cog_noise"])
    return out


def _save_frames(path, frames, fps):
    np.save(path + ".npy", frames)


def _cli_cases(rank, work_dir) -> dict:
    """The CLI over the ranks: base mode with rows and frames split and with FSDP, then
    every other mode at ``DATA_CONTEXT``, each mode's pipeline and decode calls recorded.
    Every rank that writes leaves a ``<output>.rank<r>`` mark."""
    import torch.distributed as dist

    from lkgd_torch.cli import run_inference_svd as cli
    from lkgd_torch.data import video_io
    from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder as VAE

    def write(path, frames, fps):
        _save_frames(path, frames, fps)
        Path(f"{path}.rank{rank}").touch()

    video_io.write_video = write
    for name, flags in (("dc", DATA_CONTEXT), ("mp", ["--model-parallel", str(WORLD)])):
        cli.main(CLI_ARGS + ["--image", str(work_dir / "frame.png"), "--output",
                             str(work_dir / f"{name}.gif"), *flags], widths())
    built, decodes = [], []
    build, decode = cli.build_pipeline, VAE.decode

    def recorded_build(args, w):
        built.append(build(args, w))
        return built[-1]

    def counted_decode(self, *args, **kw):
        decodes.append(1)
        return decode(self, *args, **kw)

    cli.build_pipeline, VAE.decode = recorded_build, counted_decode
    out = {}
    for name, (flags, *_) in CLI_MODES.items():
        decodes.clear()
        cli.main(cli_mode_argv(work_dir, name, flags, DATA_CONTEXT), widths())
        pipe = built[-1]
        out[name] = {"class": type(pipe).__name__, "decodes": len(decodes),
                     "loop_split": pipe.data_group is not None or pipe.context_group is not None,
                     "decode_ranks": dist.get_world_size(pipe.decode_group),
                     "frame_groups": sum(getattr(m, "frame_group", None) is not None
                                         for m in pipe.unet.modules())}
    return {"cli": out}


def cli_mode_argv(work_dir, name, flags, extra=()) -> list:
    """The CLI's arguments for ``CLI_MODES[name]``: smooth reads the clip's frames, the
    other modes the one frame."""
    image = work_dir / ("clip" if name.startswith("smooth") else "frame.png")
    return CLI_ARGS + ["--image", str(image), "--output", str(work_dir / f"{name}.gif"),
                       *flags, *extra]


def widths():
    from lkgd_torch.cli import run_inference_svd as cli
    from lkgd_torch.models import configs as tcfg

    return cli.Widths(unet=TINY_UNET, vae=tcfg.TemporalVAEConfig(**TINY_VAE),
                      clip=tcfg.CLIPVisionConfig(**TINY_CLIP),
                      controlnet_embedding=CN_EMBEDDING)


def train_widths():
    from lkgd_torch.cli import train_svd_lora as cli
    from lkgd_torch.models import configs as tcfg
    from lkgd_torch.models.vit_mae import ViTConfig

    return cli.Widths(unet=TINY_UNET, vae=tcfg.TemporalVAEConfig(**TINY_VAE),
                      clip=tcfg.CLIPVisionConfig(**TINY_CLIP), vit=ViTConfig.tiny())


def train_args(out_dir):
    from lkgd_torch.cli import train_svd_lora as cli

    return cli.make_parser().parse_args(
        ["--output-dir", str(out_dir), "--height", str(H), "--width", str(W), "--num-frames",
         str(T), "--dtype", "fp32", "--device", "cpu", "--rank", "2", "--seed", "4"])


def train_cli_step(run, pixel_values) -> dict:
    """One step of the CLI's trainer on ``pixel_values``: the gradients the optimizer clips
    (averaged over the ranks under data parallelism), the loss, the trained parameters."""
    opt = run.trainer.state.optimizer
    grads = {}
    clip = opt.clip_grads

    def record():
        grads.update({n: p.grad.detach().clone() for n, p in opt.params.items()})
        return clip()

    opt.clip_grads = record
    state, loss = run.trainer.train_step(run.trainer.state, {"pixel_values": pixel_values},
                                         run.trainer.generator)
    return {"grads": grads, "loss": float(loss),
            "params": {n: p.detach().clone() for n, p in opt.params.items()}}


def _train_cases(rank, work, work_dir) -> dict:
    from lkgd_torch.cli import train_svd_lora as cli

    run = cli.build(train_args(work_dir / f"train{rank}"), train_widths())
    assert run.trainer.state.optimizer.group is not None
    return {"train": train_cli_step(run, work["pixels"][rank:rank + 1])}


def zero_unet():
    from lkgd_torch.models.configs import SVDUNetConfig
    from lkgd_torch.models.layers import init_params, materialize
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition

    unet = materialize(lambda: UNetSpatioTemporalCondition(SVDUNetConfig(**TINY_UNET)), "cpu",
                       torch.float32)
    init_params(unet, torch.Generator().manual_seed(0))
    return unet


def zero_batch() -> dict:
    rng = np.random.default_rng(0)
    return {"latents": torch.from_numpy(rng.standard_normal((WORLD, 2, 8, 8, 4)).astype(np.float32)),
            "cond_latents": torch.full((WORLD, 8, 8, 4), 0.1),
            "image_embeddings": torch.ones((WORLD, 1, 64))}


def zero_steps(state, rows=slice(None), steps: int = 2) -> list:
    """``steps`` train steps on the rows ``rows`` of ``zero_batch()``, their draws made at
    the whole batch's shape; returns the losses of the whole batch."""
    import torch.distributed as dist

    from lkgd_torch.parallel.sequence import all_reduce
    from lkgd_torch.training.train_state import SVDTrainConfig, make_svd_train_step, svd_draws

    config = SVDTrainConfig()
    step = make_svd_train_step(config)
    batch, gen = zero_batch(), torch.Generator().manual_seed(7)
    losses = []
    for _ in range(steps):
        draws = svd_draws(config, batch["latents"].shape, gen, "cpu")
        sigmas, noise, dropout_u = (x[rows] for x in draws)
        state, loss = step(state, {k: v[rows] for k, v in batch.items()}, None, sigmas=sigmas,
                           noise=noise, dropout_u=dropout_u)
        if state.optimizer.group is not None:
            loss = all_reduce(loss, state.optimizer.group) / dist.get_world_size()
        losses.append(float(loss))
    return losses


def _zero_cases(rank) -> dict:
    from lkgd_torch.parallel import mesh
    from lkgd_torch.training.optim8bit import opt_state_bytes
    from lkgd_torch.training.train_state import init_train_state, make_optimizer
    from lkgd_torch.training.trainer import zero_shard_opt_state

    grid = mesh.make_mesh(f"data={WORLD}", "cpu")
    rows = slice(rank, rank + 1)
    out = {}
    for name in ("replicated", "zero"):
        state = init_train_state(zero_unet(), make_optimizer(LR))
        if name == "zero":
            zero_shard_opt_state(state, grid.groups["data"])
        else:
            state.optimizer.group = grid.groups["data"]
        losses = zero_steps(state, rows)
        out[name] = {"losses": losses, "bytes": opt_state_bytes(state.optimizer.adamw.state_dict()),
                     "params": {n: p.detach().clone() for n, p in state.trainables.items()},
                     "split": sum(d is not None for d, _ in state.optimizer.shards.values())}
    return {"zero": out}


def _rank_cases(rank, world, work_dir) -> dict:
    work = torch.load(work_dir / "work.pt", weights_only=False)
    out = {**_svd_cases(work), **_subclass_cases(work), **_cogvideox_cases(work)}
    out.update(_cli_cases(rank, work_dir))
    out.update(_train_cases(rank, work, work_dir))
    out.update(_zero_cases(rank))
    return out


# ------------------------------------------------------------------ the test process
def _inputs(work_dir: Path) -> tuple:
    """The ranks' inputs, and JAX's unsharded SVD frames on the same weights and noise."""
    import jax
    import jax.numpy as jnp

    from lkgd_torch.utils.porting import cogvideox_key_map
    from lkgd_torch.data import video_io
    from tests.test_torch_porting import (KEY_MAPS, port_state_dict, randomize,
                                          tiny_jax_params, tiny_jax_pipeline)
    from tests.test_torch_tensor_parallel import _jax_pipeline

    jpipe = tiny_jax_pipeline()
    params = tiny_jax_params(jpipe)
    rng = np.random.default_rng(5)
    image = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
    noise_aug = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    init_noise = rng.standard_normal((1, T, H // 2, W // 2, 4)).astype(np.float32)
    want = np.asarray(jpipe(params, image, noise_aug=jnp.asarray(noise_aug),
                            initial_noise=jnp.asarray(init_noise)), np.float32)
    cog = randomize(jax.eval_shape(_jax_pipeline().init_params, jax.random.PRNGKey(0)),
                    seed=43, scale=0.1)
    work = {"svd": [port_state_dict(params[k], KEY_MAPS[k])
                    for k in ("unet", "vae", "image_encoder")],
            "image": torch.from_numpy(image), "noise_aug": torch.from_numpy(noise_aug),
            "initial_noise": torch.from_numpy(init_noise),
            "cog": port_state_dict(cog["transformer"], cogvideox_key_map),
            "prompt": torch.full((1, 8, 64), 0.3), "cog_image": torch.full((1, 4, 4, 4), 0.5),
            "cog_noise": torch.from_numpy(rng.standard_normal((1, 8, 4, 4, 4)).astype(np.float32)),
            "pixels": torch.rand(WORLD, T + 1, H, W, 3, generator=torch.Generator().manual_seed(2))
            * 2 - 1}
    frame = rng.uniform(size=(1, 40, 56, 3)).astype(np.float32)
    video_io.write_video(str(work_dir / "frame.png"), frame, fps=8)
    (work_dir / "clip").mkdir()
    for i, f in enumerate(rng.uniform(size=(5, 40, 56, 3))):  # CLI_MODES' longest smooth
        video_io.write_video(str(work_dir / "clip" / f"{i:03d}.png"), f[None], fps=8)
    return work, want


def _subclass_inputs() -> tuple:
    """The subclass pipelines' weights (every leaf random) and inputs with JAX's draws, for
    the ranks; and the JAX pipelines of the same classes built with ``mesh=`` over
    ``data=2,context=2`` on 4 CPU devices, with a function that returns their frames."""
    import jax
    import jax.numpy as jnp

    from lkgd_tpu.parallel import mesh as meshlib
    from tests.test_torch_porting import KEY_MAPS, port_state_dict, randomize

    grid = meshlib.make_mesh({"data": 2, "context": 2}, jax.devices()[:WORLD])
    rng = np.random.default_rng(12)

    def uniform(*shape):
        return rng.uniform(size=shape).astype(np.float32)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def jax_normal(key, *shape):
        return np.array(jax.random.normal(key, shape, jnp.float32))

    h, w, total = H // 2, W // 2, SMOOTH["total_frames"]
    sub, runs, shapes = {}, {}, {}
    for i, mode in enumerate(SUB_MODES):
        jpipe = subclass_pipeline("lkgd_tpu", mode, dtype=jnp.float32, mesh=grid)
        models = {"smooth": "trans", "flow": "controlnet"}.get(mode, mode)  # the same shapes
        if models not in shapes:
            shapes[models] = jax.eval_shape(jpipe.init_params, jax.random.PRNGKey(0))
        params = randomize({k: v for k, v in shapes[models].items()
                            if k != "controlnet" or mode == "controlnet"}, seed=60 + i)
        weights = {k: port_state_dict(params[k], KEY_MAPS[k]) for k in KEY_MAPS}
        if mode == "controlnet":
            weights["controlnet"] = port_state_dict(params["controlnet"])
        key = jax.random.PRNGKey(20 + i)
        if mode == "trans":
            kw = dict(noise_aug=normal(2, H, W, 3), initial_noise=normal(2, T, h, w, 4))
            args, jkw = (uniform(2, H, W, 3),), kw
        elif mode == "smooth":  # the JAX pipeline's own draws: svd_smooth.py:53, 58, 67, 82
            rng_aug, rng_noise, rng_offsets = jax.random.split(key, 3)
            steps = jpipe.schedule.num_steps - SMOOTH["start_step"]
            kw = dict(noise_aug=jax_normal(rng_aug, total, H, W, 3),
                      initial_noise=jax_normal(rng_noise, 1, total, h, w, 4),
                      offsets=np.asarray(jax.random.randint(rng_offsets, (steps,), 0, T)).tolist())
            args, jkw = (uniform(total, H, W, 3),), dict(rng=key)
        elif mode == "controlnet":
            kw = dict(control=uniform(T, H, W, 3), noise_aug=normal(1, H, W, 3),
                      initial_noise=normal(1, T, h, w, 4))
            args, jkw = (uniform(1, H, W, 3),), kw
        else:  # the JAX pipeline's own draws: svd_flow.py:40, 70
            rng_aug, _, rng_lat = jax.random.split(key, 3)
            kw = dict(flow_cond=uniform(1, H, W, 3), noise_aug=jax_normal(rng_aug, 1, H, W, 3),
                      initial_noise=jax_normal(rng_lat, 1, T, h, w, 4))
            args, jkw = (uniform(1, H, W, 3),), dict(flow_cond=kw["flow_cond"], rng=key)
        sub[mode] = {"weights": weights, "args": tuple(map(torch.from_numpy, args)),
                     "kw": {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                            for k, v in kw.items()}}
        runs[mode] = (jpipe, params, args, jkw)

    def frames() -> dict:
        out = {}
        with jax.set_mesh(grid):
            for mode, (jpipe, params, args, jkw) in runs.items():
                replicated = jax.device_put(params, meshlib.replicated(grid))
                out[mode] = np.asarray(jpipe(replicated, *args, **jkw), np.float32)
        return out

    return sub, frames


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work_dir = tmp_path_factory.mktemp("dp")
    work, want = _inputs(work_dir)
    work["sub"], jax_frames = _subclass_inputs()
    torch.save(work, work_dir / "work.pt")
    sub_want = {}
    outs = launch("tests.test_torch_data_parallel", WORLD, work_dir,
                  meanwhile=lambda: sub_want.update(jax_frames()))
    work["sub_want"] = sub_want
    return work_dir, work, want, outs


def _same_on_every_rank(outs, *keys):
    def get(o):
        for k in keys:
            o = o[k]
        return o

    for o in outs[1:]:
        torch.testing.assert_close(get(o), get(outs[0]), rtol=0, atol=0)
    return get(outs[0])


def test_svd_data_context_matches_unsharded_and_jax(runs):
    *_, want, outs = runs
    got = _same_on_every_rank(outs, "svd_data2_context2", "frames").numpy()
    whole = outs[0]["svd_whole"]["frames"].numpy()
    assert got.shape == (1, T, H, W, 3)
    np.testing.assert_allclose(got, whole, **SHARD_TOL)
    np.testing.assert_allclose(got, want, **JAX_TOL)


def test_svd_fsdp_is_the_unsharded_port_and_matches_jax(runs):
    *_, want, outs = runs
    assert all(o["svd_fsdp4"]["split"] > 50 for o in outs), [o["svd_fsdp4"]["split"] for o in outs]
    got = _same_on_every_rank(outs, "svd_fsdp4", "frames")
    torch.testing.assert_close(got, outs[0]["svd_whole"]["frames"], rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


def test_cogvideox_data_context_matches_unsharded(runs):
    *_, outs = runs
    got = _same_on_every_rank(outs, "cog_data2_context2")
    assert got.abs().max() > 0.1
    torch.testing.assert_close(got, outs[0]["cog_whole"], **SHARD_TOL)


@pytest.mark.parametrize("name,flags", [
    ("dc", ["--data-parallel", "2", "--context-parallel", "2"]),
    ("mp", ["--model-parallel", str(WORLD)])], ids=["data_context", "model"])
def test_svd_cli_flags_equal_one_process(runs, name, flags, monkeypatch):
    """Rank 0 alone writes; its frames are those of the CLI in one process."""
    from lkgd_torch.cli import run_inference_svd as cli
    from lkgd_torch.data import video_io

    work_dir, *_ = runs
    monkeypatch.setattr(video_io, "write_video", _save_frames)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' threading: the same reductions
    try:
        cli.main(CLI_ARGS + ["--image", str(work_dir / "frame.png"), "--output",
                             str(work_dir / f"one_{name}.gif")], widths())
    finally:
        torch.set_num_threads(threads)
    got, want = np.load(work_dir / f"{name}.gif.npy"), np.load(work_dir / f"one_{name}.gif.npy")
    assert got.shape == want.shape == (T, H, W, 3)
    if name == "mp":  # FSDP: the same arithmetic
        np.testing.assert_array_equal(got, want)
    # the CLI's weights are drawn at their fan-in scales: its activations are larger than
    # the parity weights', and so is fp32's rounding of 1 row and 2 frames against 2 and 4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", SUB_MODES)
def test_subclass_pipeline_over_data_context_matches_jax(runs, mode):
    """Every rank's frames equal, and within the unsharded parity's tolerance of the JAX
    pipeline of the same class built with ``mesh=`` over 4 CPU devices."""
    _, work, _, outs = runs
    got = _same_on_every_rank(outs, f"sub_{mode}").numpy()
    want = work["sub_want"][mode]
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **JAX_TOL)


@pytest.mark.parametrize("mode", SUB_MODES)
def test_svd_cli_accepts_data_and_context_in_every_mode(runs, mode):
    """``--data-parallel 2 --context-parallel 2`` builds the mode's pipeline on every rank:
    no row or frame group on its loop, no UNet module gathering frames, the decode over the
    2 ranks of context with half of the chunks a rank."""
    *_, outs = runs
    chunks = CLI_MODES[mode][2]
    for o in outs:
        got = o["cli"][mode]
        assert got == {"class": SUB_CLASSES[mode], "decodes": chunks // 2, "loop_split": False,
                       "decode_ranks": 2, "frame_groups": 0}, got


def test_svd_cli_decodes_whole_where_context_does_not_divide_the_chunks(runs):
    """Smooth at 5 frames makes 5 decode chunks: every rank decodes all of them."""
    *_, outs = runs
    assert [o["cli"]["smooth_whole_decode"]["decodes"] for o in outs] == [5] * WORLD


@pytest.mark.parametrize("name", list(CLI_MODES))
def test_svd_cli_mode_over_data_context_equals_one_process(runs, name, monkeypatch):
    """Rank 0 alone writes, and its frames are those of the CLI in one process bit for bit:
    the loop runs whole on every rank and each decode chunk is one process's chunk (the
    ranks' ``check_replicated`` held every rank's frames equal)."""
    from lkgd_torch.cli import run_inference_svd as cli
    from lkgd_torch.data import video_io

    work_dir, *_ = runs
    monkeypatch.setattr(video_io, "write_video", _save_frames)
    flags, frames, _ = CLI_MODES[name]
    one = cli_mode_argv(work_dir, name, flags)
    one[one.index("--output") + 1] = str(work_dir / f"one_{name}.gif")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' threading: the same reductions
    try:
        cli.main(one, widths())
    finally:
        torch.set_num_threads(threads)
    assert [p.name for p in work_dir.glob(f"{name}.gif.rank*")] == [f"{name}.gif.rank0"]
    got, want = np.load(work_dir / f"{name}.gif.npy"), np.load(work_dir / f"one_{name}.gif.npy")
    assert got.shape == want.shape == (frames, H, 2 * W if name == "trans" else W, 3)
    np.testing.assert_array_equal(got, want)


def test_svd_cli_refuses_model_parallel_with_sequential_cfg():
    from lkgd_torch.cli import run_inference_svd as cli

    with pytest.raises(SystemExit, match="--sequential-cfg's second UNet shares them"):
        cli.build_pipeline(cli.make_parser().parse_args(
            ["--image", "a.png", "--mode", "trans", "--device", "cpu", "--model-parallel", "2",
             "--sequential-cfg"]), widths())


def test_train_step_over_ranks_equals_one_process(runs, tmp_path):
    from lkgd_torch.cli import train_svd_lora as cli

    _, work, _, outs = runs
    run = cli.build(train_args(tmp_path), train_widths())
    assert run.trainer.state.optimizer.group is None
    before = {n: p.detach().clone() for n, p in run.trainer.state.optimizer.params.items()}
    one = train_cli_step(run, work["pixels"])
    got = [o["train"] for o in outs]
    for g in got[1:]:
        assert g["loss"] == got[0]["loss"]
        for n in g["params"]:
            torch.testing.assert_close(g["params"][n], got[0]["params"][n], rtol=0, atol=0)
    np.testing.assert_allclose(got[0]["loss"], one["loss"], rtol=1e-5)
    assert sorted(got[0]["grads"]) == sorted(one["grads"])
    # fp32 in one thread a rank: the averaged gradients within 2.3e-5 of each tensor's
    # largest (the knowledge fusion's FFT phase branch), the updated parameters within 4e-8
    for name, want in one["grads"].items():
        floor = 5e-5 * want.abs().max().item()
        np.testing.assert_allclose(got[0]["grads"][name].numpy(), want.numpy(), rtol=1e-5,
                                   atol=floor, err_msg=name)
    for name, want in one["params"].items():
        np.testing.assert_allclose(got[0]["params"][name].numpy(), want.numpy(), rtol=1e-6,
                                   atol=2e-7, err_msg=name)
    assert any(g.abs().max() > 0 for g in one["grads"].values())
    assert any(not torch.equal(p, before[n]) for n, p in one["params"].items())


def test_zero_steps_equal_replicated_moments(runs):
    """Two ZeRO updates are the replicated-moment data-parallel updates bit for bit, every
    rank holds a quarter of the moment bytes, and both match one process on the whole batch
    at ``tests/test_zero.py``'s bounds (the loss at rtol 1e-5, the parameters within two Adam
    steps)."""
    from lkgd_torch.training.train_state import init_train_state, make_optimizer

    *_, outs = runs
    for o in outs:
        z, r = o["zero"]["zero"], o["zero"]["replicated"]
        assert z["losses"] == r["losses"]
        for n in r["params"]:
            torch.testing.assert_close(z["params"][n], r["params"][n], rtol=0, atol=0)
            torch.testing.assert_close(z["params"][n], outs[0]["zero"]["zero"]["params"][n],
                                       rtol=0, atol=0)
        assert z["split"] >= 10
        assert z["bytes"] < 0.3 * r["bytes"], (z["bytes"], r["bytes"])
    state = init_train_state(zero_unet(), make_optimizer(LR))
    losses = zero_steps(state)
    np.testing.assert_allclose(outs[0]["zero"]["zero"]["losses"], losses, rtol=1e-5)
    for n, p in state.trainables.items():
        np.testing.assert_allclose(outs[0]["zero"]["zero"]["params"][n].numpy(),
                                   p.detach().numpy(), rtol=0, atol=2.5 * LR, err_msg=n)


def test_zero_specs_match_jax():
    """Each moment's split dim is the first axis JAX's ``zero_shardings`` shards, in the
    port's layout."""
    import jax
    from jax.sharding import PartitionSpec

    from lkgd_tpu.models.configs import SVDUNetConfig
    from lkgd_tpu.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_tpu.parallel.mesh import make_mesh
    from lkgd_tpu.training.train_state import TrainState
    from lkgd_tpu.training.trainer import zero_shardings as jax_zero

    from lkgd_torch.training.train_state import init_train_state, make_optimizer
    from lkgd_torch.training.trainer import zero_shardings
    from tests.test_torch_tensor_parallel import _flat, _torch_dims

    unet = UNetSpatioTemporalCondition(SVDUNetConfig(**TINY_UNET))
    b, t = WORLD, 2
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct(
        (b, t, 8, 8, 8), np.float32), jax.ShapeDtypeStruct((b,), np.float32),
        jax.ShapeDtypeStruct((b, 1, 64), np.float32), jax.ShapeDtypeStruct((b, 3), np.float32))
    mesh = make_mesh({"data": WORLD}, jax.devices()[:WORLD])
    # the moments mirror the parameters: JAX's rule on a state whose moments are them
    sh = jax_zero(mesh, TrainState(step=0, params=shapes, opt_state=shapes, ema_params=None))
    jspecs = jax.tree.map(lambda s: s.spec, sh.opt_state)
    flat_shapes = {k: v.shape for k, v in _flat(shapes).items()}
    want = _torch_dims(_flat(jspecs, lambda x: isinstance(x, PartitionSpec)), flat_shapes, None)
    got = zero_shardings(init_train_state(zero_unet(), make_optimizer(LR)), WORLD)
    assert got == want
    assert sum(d is not None for d in got.values()) >= 10


def test_zero_refuses_8bit_splits_off_its_blocks():
    """A moment split on another dim than the first, or into pieces off the 256-element
    quantisation blocks, is refused over 8-bit Adam."""
    import torch.distributed as dist

    from lkgd_torch.training.train_state import init_train_state, make_optimizer
    from lkgd_torch.training.trainer import zero_shard_opt_state

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        state = init_train_state(zero_unet(), make_optimizer(LR, use_8bit=True))
        with pytest.raises(ValueError, match="quantisation blocks"):
            zero_shard_opt_state(state, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
