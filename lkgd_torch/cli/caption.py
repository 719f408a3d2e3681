"""Image and video captions (counterpart of ``lkgd_tpu/cli/caption.py``):

* ``--model blip``: BLIP (``Salesforce/blip-image-captioning-large``, ``--model-size base``
  for ``-base``) on frame ``--frame`` of each input, greedy at ``--max-length``;
* ``--model cogvlm``: CogVLM2-Caption (``THUDM/cogvlm2-llama3-caption``, bf16) on
  ``--num-frames`` frames sampled evenly over each video and resized to 224 x 224 by JAX's
  antialiased bilinear (``ops/resize.resize_bilinear``), CLIP-normalised, after the prompt
  ``--prompt-ids`` (a JSON list of LLaMA3 ids), ``--max-length`` new tokens greedy.

  python -m lkgd_torch.cli.caption --input data/videos --weights blip_large.safetensors \\
      --output captions.json
  python -m lkgd_torch.cli.caption --model cogvlm --input data/videos \\
      --weights cogvlm2_caption.safetensors --prompt-ids prompt.json --output captions.json

``--weights`` (HF's or THUDM's state dict) is loaded strictly. The output maps each file's
name to its caption's token ids, as the JAX CLI writes them without a tokenizer: the BERT and
LLaMA3 tokenizers are not in the repository, so ``--tokenizer``, and a text ``--prompt``
for CogVLM, are refused (ROADMAP.md Queue 1, item 14e).

It runs on the card: ``--device`` defaults to ``cuda`` and a machine without one fails unless
``--device cpu`` is given. BLIP computes in fp32, CogVLM in ``COGVLM_DTYPE`` (bf16, as the
JAX CLI builds it), both with TF32 off (``annotate.precision``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from lkgd_torch.cli.annotate import precision
from lkgd_torch.models.blip import BlipConfig
from lkgd_torch.models.cogvlm import CogVLMConfig
from lkgd_torch.utils.device import require_device
from lkgd_torch.utils.porting import load_state_dict

REFUSED = "the tokenizers are not ported (ROADMAP.md Queue 1, item 14e)"
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
COGVLM_DTYPE = torch.bfloat16


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--weights", required=True,
                   help="the model's state dict (.safetensors, .pth, .bin), loaded strictly")
    p.add_argument("--model", default="blip", choices=("blip", "cogvlm"))
    p.add_argument("--model-size", default="large", choices=("base", "large"))
    p.add_argument("--tokenizer", default=None, help="refused: " + REFUSED)
    p.add_argument("--max-length", type=int, default=20)
    p.add_argument("--frame", type=int, default=0,
                   help="blip: which frame of each video to caption")
    p.add_argument("--num-frames", type=int, default=24,
                   help="cogvlm: frames sampled a video")
    p.add_argument("--prompt", default=None, help="cogvlm: refused: " + REFUSED)
    p.add_argument("--prompt-ids", default=None,
                   help="cogvlm: JSON list of the prompt's token ids")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    return p


def _files(folder: str) -> list:
    return sorted(sum([glob.glob(os.path.join(folder, e))
                       for e in ("*.mp4", "*.gif", "*.png", "*.jpg")], []))


def build_blip_captioner(args):
    """BLIP-large (``--model-size base``: -base) in fp32 on ``args.device``, loaded strictly
    from ``args.weights``."""
    from lkgd_torch.models.blip import build_blip

    cfg = BlipConfig.large() if args.model_size == "large" else BlipConfig.base()
    model = build_blip(cfg, args.device)
    model.load_state_dict(load_state_dict(args.weights), strict=True)
    return model


def build_cogvlm_captioner(args):
    """CogVLM2-Caption (``caption_8b``) in ``COGVLM_DTYPE`` on ``args.device``, loaded strictly
    from ``args.weights`` (the rotary buffers dropped, ``port_cogvlm``)."""
    from lkgd_torch.models.cogvlm import build_cogvlm, port_cogvlm

    model = build_cogvlm(CogVLMConfig.caption_8b(), args.device, dtype=COGVLM_DTYPE)
    model.load_state_dict(port_cogvlm(load_state_dict(args.weights)), strict=True)
    return model


def caption_blip(model, args, path: str) -> list:
    """One file's caption ids: frame ``args.frame`` (or the last), BOS, PAD and everything
    from the first SEP on dropped."""
    from lkgd_torch.data.video_io import load_input
    from lkgd_torch.models.blip import greedy_caption, preprocess_images

    cfg = model.cfg
    frames = load_input(path, max_frames=args.frame + 1)
    pixels = preprocess_images(frames[min(args.frame, len(frames) - 1)][None], cfg.image_size)
    device = next(model.parameters()).device
    ids = greedy_caption(model, torch.from_numpy(pixels).to(device), args.max_length)[0]
    ids = [int(t) for t in ids.tolist() if t != cfg.pad_token_id][1:]
    return ids[:ids.index(cfg.sep_token_id)] if cfg.sep_token_id in ids else ids


def video_clip(frames: np.ndarray, num_frames: int, size: int, device) -> torch.Tensor:
    """(T, H, W, 3) [0, 1] -> (1, n, size, size, 3) CogVLM pixels: ``num_frames`` frames at
    ``linspace`` rounded positions, each resized by JAX's antialiased bilinear in fp32 and
    CLIP-normalised."""
    from lkgd_torch.ops.resize import resize_bilinear

    idx = np.linspace(0, len(frames) - 1, min(num_frames, len(frames)))
    picked = np.stack([frames[int(round(i))] for i in idx]).astype(np.float32)
    clip = resize_bilinear(torch.from_numpy(picked).to(device), (size, size))
    mean, std = (torch.tensor(v, device=device) for v in (CLIP_MEAN, CLIP_STD))
    return ((clip - mean) / std)[None]


def caption_cogvlm(model, args, path: str, prompt: torch.Tensor) -> list:
    """One video's generated ids, PAD and EOS dropped."""
    from lkgd_torch.data.video_io import load_input
    from lkgd_torch.models.cogvlm import greedy_video_caption

    cfg = model.cfg
    device = next(model.parameters()).device
    clip = video_clip(load_input(path), args.num_frames, cfg.image_size, device)
    ids = greedy_video_caption(model, clip, prompt.to(device), args.max_length)[0]
    return [int(t) for t in ids.tolist() if t not in (cfg.pad_token_id, cfg.eos_token_id)]


@precision()
def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    if args.tokenizer:
        raise SystemExit(f"--tokenizer: {REFUSED}; without it the ids are written")
    if args.prompt is not None:
        raise SystemExit(f"--prompt: a text prompt needs the LLaMA3 tokenizer, and {REFUSED}; "
                         f"give its ids as --prompt-ids")
    if args.model == "cogvlm" and not args.prompt_ids:
        raise SystemExit(f"--model cogvlm needs --prompt-ids (a text prompt needs the LLaMA3 "
                         f"tokenizer, and {REFUSED})")
    require_device(args.device)
    results = {}
    if args.model == "blip":
        model = build_blip_captioner(args)
        caption = lambda f: caption_blip(model, args, f)  # noqa: E731
    else:
        with open(args.prompt_ids) as fh:
            prompt = torch.tensor(json.load(fh), dtype=torch.long)[None]
        model = build_cogvlm_captioner(args)
        caption = lambda f: caption_cogvlm(model, args, f, prompt)  # noqa: E731
    for f in _files(args.input):
        results[os.path.basename(f)] = caption(f)
        print(f"{f}: {results[os.path.basename(f)]}")
    with open(args.output, "w") as fh:
        json.dump(results, fh, indent=2)
    print(f"wrote {len(results)} captions -> {args.output}")


if __name__ == "__main__":
    main()
