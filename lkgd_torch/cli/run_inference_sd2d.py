"""2D joint-image inference with the PyTorch port (counterpart of
``lkgd_tpu/cli/run_inference_sd2d.py``): the SD2 inpaint and joint-control pipelines at
512x512, 50 DDIM steps, guidance 7.5, bf16.

Examples::

  # inpaint an image region (white in the mask = regenerate)
  python -m lkgd_torch.cli.run_inference_sd2d --mode inpaint --image img.png --mask mask.png

  # joint condition -> image generation (x stream conditioned, y generated)
  python -m lkgd_torch.cli.run_inference_sd2d --mode joint_control --image depth.png

Prompts are embeddings from ``--prompt-embeds`` (a ``.npy`` of (L, 1024) or (B, L, 1024)),
or zeros without it (smoke mode). It runs on the card: ``--device`` defaults to ``cuda``
and a machine without one fails unless ``--device cpu`` is given. The weights are random,
drawn from ``--seed`` at SD2's shapes. ``--weights`` (SD2 ``unet``, ``vae`` and
``text_encoder`` safetensors) and ``--prompt`` with ``--tokenizer`` (a CLIP BPE
tokenizer) are refused: neither files nor tokenizer are in the repository (ROADMAP.md
Queue 1, item 13).

As the JAX CLI does, the image goes to the pipelines already scaled to [-1, 1], which
scale it again (``x * 2 - 1``): the VAE sees [-3, 1]. As there, ``joint_control`` builds
the pipeline's default UNet, which has no joint attention: its two streams are coupled by
the clamping alone (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lkgd_torch.models.configs import UNet2DConfig, VAE2DConfig
from lkgd_torch.pipelines.sd2d import (SD2DPipelineConfig, StableDiffusionInpaintPipeline,
                                       StableDiffusionJointControlPipeline)

ITEM = "ROADMAP.md Queue 1, item 13"
# tiny widths for tests (the JAX package's tests/test_sd2d.py TINY_UNET and TINY_VAE)
TINY_UNET = dict(block_out_channels=(32, 64),
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                 layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=32)
TINY_VAE = dict(block_out_channels=(32, 64, 64), layers_per_block=1)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["inpaint", "joint_control"], default="inpaint")
    p.add_argument("--image", required=True)
    p.add_argument("--mask", help="inpaint mode: white = regenerate")
    p.add_argument("--output", default="output_sd2d.png")
    p.add_argument("--prompt-embeds", help=".npy prompt embeddings (L, D) or (B, L, D)")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--cond-y", action="store_true",
                   help="joint_control: condition the y stream instead of x")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="tiny widths (tests)")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    # not ported: refused with the ROADMAP item that holds them
    p.add_argument("--weights", help=argparse.SUPPRESS)
    p.add_argument("--prompt", help=argparse.SUPPRESS)
    p.add_argument("--tokenizer", help=argparse.SUPPRESS)
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    if args.weights:
        p.error(f"--weights is not ported to lkgd_torch: no SD2 unet, vae or text_encoder "
                f"safetensors are in the repository ({ITEM}); weights are random from --seed")
    if args.prompt or args.tokenizer:
        p.error(f"--prompt and --tokenizer are not ported to lkgd_torch: no CLIP tokenizer "
                f"files are in the repository ({ITEM}); pass --prompt-embeds")


def build(args):
    """The pipeline of ``--mode`` in bf16, random weights from ``--seed``."""
    kw = dict(config=SD2DPipelineConfig(height=args.height, width=args.width,
                                        num_inference_steps=args.num_inference_steps,
                                        guidance_scale=args.guidance_scale),
              dtype=torch.bfloat16, device=args.device)
    if args.tiny:
        kw["vae_config"] = VAE2DConfig(**TINY_VAE)
    if args.mode == "inpaint":
        if args.tiny:
            kw["unet_config"] = UNet2DConfig(in_channels=9, **TINY_UNET)
        pipe = StableDiffusionInpaintPipeline(**kw)
    else:
        if args.tiny:
            kw["unet_config"] = UNet2DConfig(in_channels=4, **TINY_UNET)
        pipe = StableDiffusionJointControlPipeline(cond_x=not args.cond_y, **kw)
    print("random weights from --seed (no checkpoint is loaded)")
    pipe.init_params(torch.Generator(device=pipe.device).manual_seed(args.seed))
    return pipe


def prompt_embeds(args, ctx_dim: int) -> torch.Tensor:
    if args.prompt_embeds:
        emb = np.load(args.prompt_embeds).astype(np.float32)
        return torch.from_numpy(emb if emb.ndim == 3 else emb[None])
    print("no prompt source: zero prompt embeddings (smoke mode)")
    return torch.zeros((1, 77, ctx_dim))


def load_inputs(args):
    """The image (H, W, 3) in [0, 1] and, for inpaint, the mask (H, W, 1) in {0, 1}."""
    from lkgd_torch.data.video_io import load_input, process_frames

    image = process_frames(load_input(args.image)[:1], args.height, args.width)[0]
    mask = None
    if args.mode == "inpaint":
        if args.mask:
            mask = process_frames(load_input(args.mask)[:1], args.height, args.width)[0]
            mask = (mask.mean(-1, keepdims=True) > 0.5).astype(np.float32)
        else:
            mask = np.ones((args.height, args.width, 1), np.float32)
    return image, mask


def denoise(pipe, args, emb: torch.Tensor, image: np.ndarray, mask=None) -> torch.Tensor:
    """The latents of ``--mode`` for one image, with the JAX CLI's inputs: the image scaled
    to [-1, 1] before the pipeline scales it again."""
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    scaled = image[None] * 2.0 - 1.0
    if args.mode == "inpaint":
        return pipe.denoise(emb, scaled, mask[None], generator=gen)
    return pipe.denoise(emb, scaled, generator=gen)


def main(argv=None) -> None:
    p = make_parser()
    args = p.parse_args(argv)
    check_args(p, args)
    pipe = build(args)
    image, mask = load_inputs(args)
    emb = prompt_embeds(args, pipe.unet.config.cross_attention_dim)

    def now() -> float:
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        return time.perf_counter()

    t0 = now()
    latents = denoise(pipe, args, emb, image, mask)
    t1 = now()
    out = pipe.decode(latents)
    t2 = now()
    print(f"{t2 - t0:.3f} s/image = encode and denoise ({args.num_inference_steps} steps) "
          f"{t1 - t0:.3f} s + decode {t2 - t1:.3f} s")

    from PIL import Image

    img = out[0].cpu().numpy()
    Image.fromarray((img * 255).astype(np.uint8)).save(args.output)
    print(f"wrote {args.output}: {img.shape}")


if __name__ == "__main__":
    main()
