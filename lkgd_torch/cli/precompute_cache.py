"""Precompute the VAE latents, the first frame's latents and the CLIP image embedding of
every clip of a folder into a tensor cache (counterpart of
``lkgd_tpu/cli/precompute_cache.py``): the cache that ``train_cogvideox_lora`` and the
JAX package's ``PrecomputedLatentDataset`` read.

  python -m lkgd_torch.cli.precompute_cache --video-folder clips/ --output cache.lkgd \
      --height 512 --width 512 --num-frames 14 [--weights ckpts/]

For each ``<name>.mp4`` (sorted) the first ``--num-frames`` frames, resized and centre-cropped
to ``--height`` x ``--width`` and taken to [-1, 1], go through the temporal VAE's encoder and
CLIP-H, both in fp32 as the JAX CLI builds them. Three tensors are written:

* ``<name>/latents``: the posterior mode times 0.18215, (T, H/8, W/8, 4);
* ``<name>/cond_latents``: the first frame's mode, unscaled, (H/8, W/8, 4);
* ``<name>/image_embeddings``: CLIP-H of the first frame after the antialiased resize to
  224 x 224, (1, 1, 1024).

A clip with fewer frames than ``--num-frames`` is skipped; a name already in the cache is
kept. Without ``--weights`` the weights are random from ``--seed``; with it,
``vae.safetensors`` and ``image_encoder.safetensors`` of that folder (diffusers and
transformers names) load strictly. ``--device`` defaults to the card.

The steps are functions of their own, so that tests run tiny widths (``main(argv,
widths=Widths(...))``) and other code drives the same encode on frames in memory:
``make_parser`` -> ``build`` -> ``encode_clip`` per clip -> ``write_clip``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection, clip_normalize
from lkgd_torch.models.configs import CLIPVisionConfig, TemporalVAEConfig
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from lkgd_torch.ops.resize import resize_with_antialiasing
from lkgd_torch.utils.device import require_device

SCALING_FACTOR = 0.18215  # the latents' scale, as the JAX CLI writes them
KNOWLEDGE = ("--knowledge is not ported: the JAX CLI parses it and computes nothing with it "
             "(ROADMAP.md Queue 3, 'precompute --knowledge')")


@dataclasses.dataclass(frozen=True)
class Widths:
    """The models' widths: the published ones by default; the CPU tests pass tiny ones."""

    vae: TemporalVAEConfig = TemporalVAEConfig()
    clip: CLIPVisionConfig = CLIPVisionConfig()


class Encoders(NamedTuple):
    vae: AutoencoderKLTemporalDecoder
    clip: CLIPVisionModelWithProjection
    device: torch.device


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video-folder", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--weights",
                   help="folder with vae.safetensors and image_encoder.safetensors")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num-frames", type=int, default=14)
    p.add_argument("--seed", type=int, default=0, help="random weights without --weights")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    # not ported: refused with the ROADMAP entry that holds it
    p.add_argument("--knowledge", action="store_true", help=argparse.SUPPRESS)
    return p


def _load(module: torch.nn.Module, path: str) -> None:
    from lkgd_torch.utils.porting import load_safetensors

    if not os.path.exists(path):
        raise FileNotFoundError(f"--weights: {path} is missing")
    module.load_state_dict({k: torch.from_numpy(v) for k, v in load_safetensors(path).items()},
                           strict=True)


def build(args, widths: Widths = Widths()) -> Encoders:
    """The temporal VAE and CLIP-H in fp32 on ``args.device``: random from ``args.seed``, or
    loaded strictly from ``args.weights``."""
    device = require_device(args.device)
    vae = materialize(lambda: AutoencoderKLTemporalDecoder(widths.vae), device, torch.float32)
    clip = materialize(lambda: CLIPVisionModelWithProjection(widths.clip), device,
                       torch.float32)
    if args.weights:
        _load(vae, os.path.join(args.weights, "vae.safetensors"))
        _load(clip, os.path.join(args.weights, "image_encoder.safetensors"))
    else:
        print("random weights from --seed (no checkpoint is loaded)")
        generator = torch.Generator(device=device).manual_seed(args.seed)
        init_params(vae, generator)
        init_params(clip, generator)
    return Encoders(vae.eval(), clip.eval(), device)


@torch.no_grad()
def encode_latents(enc: Encoders, pixels: torch.Tensor):
    """(T, H, W, 3) in [-1, 1] on the device -> (latents * 0.18215 (T, h, w, 4), the first
    frame's latents (h, w, 4))."""
    lat = enc.vae.encode_mode(pixels)
    return lat * SCALING_FACTOR, lat[0]


@torch.no_grad()
def encode_image(enc: Encoders, pixels: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) in [-1, 1] -> CLIP embedding of frame 0, (1, 1, D)."""
    size = enc.clip.config.image_size
    x = resize_with_antialiasing(pixels[:1], (size, size))
    return enc.clip(clip_normalize((x + 1.0) / 2.0))[:, None]


def encode_clip(enc: Encoders, frames: np.ndarray) -> Dict[str, torch.Tensor]:
    """Resized (T, H, W, 3) frames in [0, 1] -> the three tensors of one clip, on the
    device, by their cache field names."""
    pixels = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(enc.device) * 2 - 1
    latents, cond = encode_latents(enc, pixels)
    return {"latents": latents, "cond_latents": cond,
            "image_embeddings": encode_image(enc, pixels)}


def write_clip(cache, name: str, tensors: Dict[str, torch.Tensor]) -> None:
    for field, x in tensors.items():
        cache.put(f"{name}/{field}", x)


def main(argv=None, widths: Widths = Widths()) -> None:
    p = make_parser()
    args = p.parse_args(argv)
    if args.knowledge:
        p.error(KNOWLEDGE)

    from lkgd_torch.data.tensor_cache import TensorCache
    from lkgd_torch.data.video_io import process_frames, read_video_frames

    enc = build(args, widths)
    cache = TensorCache(args.output)
    try:
        for f in sorted(glob.glob(os.path.join(args.video_folder, "*.mp4"))):
            name = os.path.splitext(os.path.basename(f))[0]
            if f"{name}/latents" in cache:
                continue
            frames, _ = read_video_frames(f, max_frames=args.num_frames)
            if len(frames) < args.num_frames:
                print(f"skip {name}: only {len(frames)} frames")
                continue
            out = encode_clip(enc, process_frames(frames[:args.num_frames], args.height,
                                                  args.width))
            write_clip(cache, name, out)
            print(f"cached {name}: latents {tuple(out['latents'].shape)}")
        print(f"done: {len(cache)} tensors in {args.output}")
    finally:
        cache.close()


if __name__ == "__main__":
    main()
