"""Image-to-video inference with the PyTorch port (counterpart of
``lkgd_tpu/cli/run_inference_svd.py``, every mode: ``base``, ``trans``, ``flow``,
``smooth`` and ``controlnet``).

Examples::

  # base image-to-video from one frame
  python -m lkgd_torch.cli.run_inference_svd --image frame.png --output out.gif \
      --height 576 --width 1024 --num-frames 14

  # frame transition between two frames (two streams coupled by joint attention)
  python -m lkgd_torch.cli.run_inference_svd --mode trans --image start.png \
      --end-image end.png --joint-mask 0,1,0,1 --flip --lora-rank 4

  # long-video smoothing: the first 50 frames of a video re-denoised from step 10 in
  # 14-frame joint chunks whose boundaries move from step to step
  python -m lkgd_torch.cli.run_inference_svd --mode smooth --image clip.mp4 \
      --smooth-total-frames 50 --smooth-start-step 10 --flip --temporal --lora-rank 4

  # ControlNet: the first --num-frames frames of a control video (edges, depth, ...;
  # lkgd_torch.utils.control_preprocess makes such maps), zeros without one;
  # --reverse-time conditions on the last frame instead of the first
  python -m lkgd_torch.cli.run_inference_svd --mode controlnet --image frame.png \
      --control-video edges.mp4 --controlnet-cond-scale 1.0 --reverse-time

  # a flow video, conditioned on the frame itself as the flow-condition image
  python -m lkgd_torch.cli.run_inference_svd --mode flow --image frame.png

  # 4 processes, one card each (NCCL; gloo with --device cpu): the CFG rows over 2 of them,
  # the frames over 2; or the weights split over 2 (FSDP, gathered at use)
  torchrun --nproc-per-node 4 -m lkgd_torch.cli.run_inference_svd --image frame.png \
      --data-parallel 2 --context-parallel 2
  torchrun --nproc-per-node 2 -m lkgd_torch.cli.run_inference_svd --image frame.png \
      --model-parallel 2

With ``--data-parallel``, ``--context-parallel`` or ``--model-parallel`` above 1 it runs one
process a rank (``torchrun``, the product of the three the world size, ``parallel/mesh.py``
with the axes data, context and model): every rank builds the same weights and noise from
``--seed`` (checked by a checksum all-reduce), ``data`` and ``context`` split the base
loop's CFG rows and frames and spread the decode's chunks (base mode only), ``model`` splits
the UNet's, VAE's and CLIP's weights (``parallel/tp.py`` ``fully_shard``; the MiB a rank
holds are printed), and rank 0 writes the video.

It runs on the card: ``--device`` defaults to ``cuda`` and a machine without one fails
unless ``--device cpu`` is given. The weights are random, drawn from ``--seed`` at the real
shapes (smoke and benchmark mode): loading a checkpoint (``--weights``) waits until one is
in the repository.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from lkgd_torch.models.controlnet_svd import ControlNetSDVConfig
from lkgd_torch.parallel import mesh
from lkgd_torch.models.configs import (CLIPVisionConfig, JointAttentionConfig, LoraRouter,
                                       LoraRule, SVDUNetConfig, TemporalVAEConfig)
from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline, SVDPipelineConfig
from lkgd_torch.pipelines.svd_controlnet import StableVideoDiffusionControlNetPipeline
from lkgd_torch.pipelines.svd_flow import StableVideoDiffusionFlowPipeline
from lkgd_torch.pipelines.svd_smooth import StableVideoDiffusionSmoothPipeline
from lkgd_torch.pipelines.svd_trans import StableVideoDiffusionTransPipeline

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Widths:
    """The models' widths: the published ones by default (SVD, its VAE, CLIP-H, the
    ControlNet's conditioning embedder); the CPU tests pass tiny ones. ``unet``: overrides
    of ``SVDUNetConfig`` fields; ``controlnet_embedding``: the embedder's channels, one
    stride-2 convolution between each two (as many as the VAE downsamples by 2)."""

    unet: dict = dataclasses.field(default_factory=dict)
    vae: TemporalVAEConfig = TemporalVAEConfig()
    clip: CLIPVisionConfig = CLIPVisionConfig()
    controlnet_embedding: tuple = (16, 32, 96, 256)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["base", "trans", "flow", "smooth", "controlnet"],
                   default="base")
    p.add_argument("--image", required=True,
                   help="the first frame; in smooth mode the video whose first "
                        "--smooth-total-frames frames are smoothed")
    p.add_argument("--end-image", help="trans mode: the end frame (default: --image again)")
    p.add_argument("--control-video",
                   help="controlnet mode: the video whose first --num-frames frames are the "
                        "per-frame control images (zeros without it)")
    p.add_argument("--controlnet-cond-scale", type=float, default=1.0)
    p.add_argument("--reverse-time", action="store_true",
                   help="controlnet mode: condition on the LAST frame (time reversal)")
    p.add_argument("--output", default="output.gif")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--num-frames", type=int, default=14)
    p.add_argument("--num-inference-steps", type=int, default=25)
    p.add_argument("--min-guidance-scale", type=float, default=1.0)
    p.add_argument("--max-guidance-scale", type=float, default=3.0)
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--motion-bucket-id", type=int, default=127)
    p.add_argument("--noise-aug-strength", type=float, default=0.02)
    p.add_argument("--decode-chunk-size", type=int, default=2)
    p.add_argument("--seed", type=int, default=23123134)  # reference default seed
    # trans / joint options
    p.add_argument("--joint-mask", default="0,1,0,1")
    p.add_argument("--post-joint", choices=["conv", "scale", "conv_fuse"], default="conv")
    p.add_argument("--flip", action="store_true")
    p.add_argument("--temporal", action="store_true")
    p.add_argument("--nospatial", action="store_true")
    p.add_argument("--lora-rank", type=int, default=0)
    p.add_argument("--knowledge-fusion", action="store_true")
    p.add_argument("--smooth-start-step", type=int, default=10,
                   help="smooth mode: the step the video is noised to and denoised from")
    p.add_argument("--smooth-total-frames", type=int, default=50,
                   help="smooth mode: how many frames of --image are smoothed")
    p.add_argument("--sequential-cfg", action="store_true",
                   help="run the two CFG halves one after the other: a lower peak of "
                        "activation memory in the denoising loop")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="mesh 'data' axis size: the CFG rows split over the ranks")
    p.add_argument("--context-parallel", type=int, default=1,
                   help="mesh 'context' axis size: the frames split over the ranks")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="mesh 'model' axis size: FSDP of the weights, each rank holding "
                        "~1/N of them")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16")
    return p


def build_mesh(args):
    """The mesh of the three parallel flags (the axes above 1, in the order data, context,
    model), or None when all are 1; ``args.device`` becomes this rank's device."""
    axes = {"data": args.data_parallel, "context": args.context_parallel,
            "model": args.model_parallel}
    axes = {a: n for a, n in axes.items() if n > 1}
    if not axes:
        return None
    if args.mode != "base" and set(axes) - {"model"}:
        raise SystemExit(f"--data-parallel and --context-parallel split the base loop's "
                         f"rows and frames: --mode {args.mode} takes --model-parallel only")
    if args.model_parallel > 1 and args.sequential_cfg:
        raise SystemExit("--model-parallel gathers the UNet's weights at use: "
                         "--sequential-cfg's second UNet shares them ungathered")
    grid = mesh.make_mesh(axes, args.device)
    args.device = str(mesh.rank_device(args.device))
    return grid


def unet_config(args, widths: Widths = Widths()) -> SVDUNetConfig:
    """The UNet of ``--mode``: in trans and smooth mode the joint topology and, with
    ``--lora-rank``, the two stream-masked adapters (``yx_lora`` on the joint branch's
    ``attn1n`` for the mask's streams, ``xy_lora`` on the temporal self-attention for the
    others)."""
    joint, lora = None, LoraRouter()
    if args.mode in ("trans", "smooth"):
        mask = tuple(int(x) for x in args.joint_mask.split(","))
        joint = JointAttentionConfig(post=args.post_joint, flip=args.flip, mask=mask,
                                     spatial=not args.nospatial, temporal=args.temporal)
        if args.lora_rank:
            inv = tuple(1 - m for m in mask)
            lora = LoraRouter(rules=(
                LoraRule("*attn1n*", "yx_lora", args.lora_rank, args.lora_rank, mask),
                LoraRule("*temporal_transformer_blocks*attn1.*", "xy_lora", args.lora_rank,
                         args.lora_rank, inv)))
    return SVDUNetConfig(**{**widths.unet, "num_frames": args.num_frames, "joint": joint,
                            "lora": lora, "knowledge_fusion": args.knowledge_fusion})


def build_pipeline(args, widths: Widths = Widths()) -> StableVideoDiffusionPipeline:
    config = SVDPipelineConfig(
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        min_guidance_scale=args.min_guidance_scale,
        max_guidance_scale=args.max_guidance_scale, fps=args.fps,
        motion_bucket_id=args.motion_bucket_id, noise_aug_strength=args.noise_aug_strength,
        decode_chunk_size=args.decode_chunk_size, sequential_cfg=args.sequential_cfg)
    grid = build_mesh(args)
    kw = dict(config=config, unet_config=unet_config(args, widths), vae_config=widths.vae,
              clip_config=widths.clip, dtype=_DTYPES[args.dtype], device=args.device)
    if grid is not None and args.mode == "base":
        kw["mesh"] = grid
    if args.mode == "smooth":
        pipe = StableVideoDiffusionSmoothPipeline(
            **kw, start_step=args.smooth_start_step, total_frames=args.smooth_total_frames)
    elif args.mode == "trans":
        pipe = StableVideoDiffusionTransPipeline(**kw)
    elif args.mode == "flow":
        pipe = StableVideoDiffusionFlowPipeline(**kw)
    elif args.mode == "controlnet":
        controlnet = ControlNetSDVConfig(
            unet=kw["unet_config"],
            conditioning_embedding_out_channels=widths.controlnet_embedding)
        pipe = StableVideoDiffusionControlNetPipeline(
            **kw, controlnet_config=controlnet, reverse_time=args.reverse_time,
            controlnet_cond_scale=args.controlnet_cond_scale)
    else:
        pipe = StableVideoDiffusionPipeline(**kw)
    print("random weights from --seed (no checkpoint is loaded)")
    pipe.init_params(torch.Generator(device=pipe.device).manual_seed(args.seed))
    if grid is not None:
        from lkgd_torch.parallel import tp
        from lkgd_torch.parallel.mesh import check_replicated

        models = [m for m in vars(pipe).values() if isinstance(m, torch.nn.Module)]
        check_replicated([p for m in models for p in m.parameters()])
        if "model" in grid.axes:
            for m in pipe.models:
                tp.fully_shard(m, grid.groups["model"])
            mib = sum(tp.per_device_param_bytes(m) for m in pipe.models) / 2**20
            print(f"FSDP weight sharding over model={grid.axes['model']}: {mib:.0f} MiB/rank")
    return pipe


def main(argv=None, widths: Widths = Widths()) -> None:
    args = make_parser().parse_args(argv)

    from lkgd_torch.data.video_io import load_input, process_frames, write_video

    pipe = build_pipeline(args, widths)
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    if args.mode == "smooth":
        video = load_input(args.image)[:args.smooth_total_frames]
        out = pipe(process_frames(video, args.height, args.width), generator=generator)[0]
        write_video(args.output, out, fps=args.fps)
        print(f"wrote {args.output}: {out.shape}")
        return
    image = process_frames(load_input(args.image)[:1], args.height, args.width)
    if args.mode == "trans":
        end_frames = load_input(args.end_image or args.image)
        end_image = process_frames(end_frames[-1:], args.height, args.width)[0]
        video = pipe(image[0], end_image, generator=generator)
        out = np.concatenate([video[0], video[1]], axis=2)  # the two streams side by side
    elif args.mode == "flow":  # the frame itself is the flow-condition image
        out = pipe(image, flow_cond=image, generator=generator)[0]
    elif args.mode == "controlnet":
        if args.control_video:
            control = process_frames(load_input(args.control_video)[:args.num_frames],
                                     args.height, args.width)
        else:
            control = np.zeros((args.num_frames, args.height, args.width, 3), np.float32)
        out = pipe(image, control=control[None], generator=generator)[0]
    else:
        out = pipe(image, generator=generator)[0]
    if args.data_parallel * args.context_parallel * args.model_parallel > 1:
        mesh.check_replicated([torch.from_numpy(np.ascontiguousarray(out))], None, "frames")
        if torch.distributed.get_rank() != 0:  # every rank holds the same video
            return
    write_video(args.output, out, fps=args.fps)
    print(f"wrote {args.output}: {out.shape}")


if __name__ == "__main__":
    main()
