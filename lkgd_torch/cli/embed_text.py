"""Text -> T5 prompt embeddings (``.npy``) for the CogVideoX CLIs, with the PyTorch port
(counterpart of ``lkgd_tpu/cli/embed_text.py``).

The embeddings are computed once and read by ``run_inference_cogvideox --prompt-embeds``
or packed into a tensor cache for ``train_cogvideox_lora``, so the T5-XXL encoder (4.76 B
parameters, 9.5 GB in bf16) is never resident beside the DiT. Examples::

  python -m lkgd_torch.cli.embed_text --tiny --prompt "a girl riding a horse" \\
      --output prompt.npy
  python -m lkgd_torch.cli.embed_text --tiny --prompts-file prompts.txt --output dir/

``--tiny`` runs a tiny T5 with random weights (seed 0) behind a whitespace hash
tokenizer (Python's ``hash`` of each word modulo the vocabulary, as the JAX CLI: salted per
process unless ``PYTHONHASHSEED`` is set), padded or cut to ``min(--max-length, 8)``
tokens. It runs on the card unless ``--device cpu`` is given. ``--t5`` (a tokenizer and a
T5-XXL checkpoint) is refused: neither is in the repository (ROADMAP.md Queue 1, item 11).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from lkgd_torch.models.configs import T5Config
from lkgd_torch.models.t5_text import build_t5_encoder
from lkgd_torch.utils.device import require_device


def hash_tokens(prompts, vocab_size: int, max_length: int):
    """The tiny path's tokenizer: ``hash(word) % vocab_size`` per whitespace word, cut to
    ``max_length`` and zero-padded; returns int64 ids and the 0/1 mask, (B, max_length)."""
    ids = np.zeros((len(prompts), max_length), np.int64)
    mask = np.zeros((len(prompts), max_length), np.int64)
    for i, text in enumerate(prompts):
        toks = [hash(w) % vocab_size for w in text.split()][:max_length]
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return ids, mask


def tiny_encode(prompts, max_length: int, device="cuda", seed: int = 0) -> np.ndarray:
    """The hash tokenizer and a random tiny T5 (fp32): (B, max_length, 32) float32."""
    config = T5Config.tiny()
    dev = torch.device(device)
    model = build_t5_encoder(config, torch.float32, dev,
                             torch.Generator(device=dev).manual_seed(seed))
    ids, mask = hash_tokens(prompts, config.vocab_size, max_length)
    with torch.inference_mode():
        out = model(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
    return out.float().cpu().numpy()


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--t5", help="T5 checkpoint dir (tokenizer + weights): not ported")
    p.add_argument("--prompt", action="append", default=[], help="prompt text (repeatable)")
    p.add_argument("--prompts-file", help="one prompt per line")
    p.add_argument("--output", required=True,
                   help=".npy path (one batch) or a directory (prompt_0000.npy, ...)")
    p.add_argument("--max-length", type=int, default=226)
    p.add_argument("--tiny", action="store_true", help="random-init tiny T5 (tests)")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    return p


def main(argv=None) -> None:
    p = make_parser()
    args = p.parse_args(argv)
    if args.t5:
        p.error("--t5 is not ported to lkgd_torch: no T5 tokenizer or checkpoint is in the "
                "repository (ROADMAP.md Queue 1, item 11); use --tiny")
    prompts = list(args.prompt)
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts += [line.strip() for line in f if line.strip()]
    if not prompts:
        p.error("no prompts given (--prompt / --prompts-file)")
    if not args.tiny:
        p.error("--t5 checkpoint dir required (not ported), or use --tiny")
    emb = tiny_encode(prompts, min(args.max_length, 8), require_device(args.device))

    if args.output.endswith(".npy"):
        np.save(args.output, emb)
        print(f"wrote {args.output}: {emb.shape}")
    else:
        os.makedirs(args.output, exist_ok=True)
        for i, (text, e) in enumerate(zip(prompts, emb)):
            path = os.path.join(args.output, f"prompt_{i:04d}.npy")
            np.save(path, e[None])
            print(f"wrote {path}: {e[None].shape}  # {text[:50]}")


if __name__ == "__main__":
    main()
