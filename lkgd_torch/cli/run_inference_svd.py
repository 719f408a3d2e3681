"""Image-to-video inference with the PyTorch port, base mode (counterpart of
``lkgd_tpu/cli/run_inference_svd.py`` ``--mode base``).

Example::

  python -m lkgd_torch.cli.run_inference_svd --image frame.png --output out.gif \
      --height 576 --width 1024 --num-frames 14 --device cuda

The weights are random, drawn from ``--seed`` at the real shapes (smoke and benchmark
mode): loading a checkpoint (``--weights``) waits until one is in the repository.
"""

from __future__ import annotations

import argparse

import torch

from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline, SVDPipelineConfig

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def build_pipeline(args) -> StableVideoDiffusionPipeline:
    config = SVDPipelineConfig(
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        min_guidance_scale=args.min_guidance_scale,
        max_guidance_scale=args.max_guidance_scale, fps=args.fps,
        motion_bucket_id=args.motion_bucket_id, noise_aug_strength=args.noise_aug_strength,
        decode_chunk_size=args.decode_chunk_size)
    pipe = StableVideoDiffusionPipeline(config=config, dtype=_DTYPES[args.dtype],
                                        device=args.device)
    print("random weights from --seed (no checkpoint is loaded)")
    pipe.init_params(torch.Generator(device=pipe.device).manual_seed(args.seed))
    return pipe


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image", required=True)
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
    p.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16")
    args = p.parse_args(argv)

    # numpy-only host IO shared with the JAX package (imports no jax)
    from lkgd_tpu.data.video_io import load_input, process_frames, write_video

    pipe = build_pipeline(args)
    image = process_frames(load_input(args.image)[:1], args.height, args.width)
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    video = pipe(image, generator=generator)[0]
    write_video(args.output, video, fps=args.fps)
    print(f"wrote {args.output}: {video.shape}")


if __name__ == "__main__":
    main()
