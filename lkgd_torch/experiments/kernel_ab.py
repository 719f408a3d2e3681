"""Time the microbenchmark kernels, 11 (blocked matmul) and 12 (flash variants), against
their library calls, in turns across checkouts of this repository.

    python -m lkgd_torch.experiments.kernel_ab [ROOT ...] [--reps 20]

Each ROOT (default: this checkout) runs in a process of its own, in the order given, with
its own build of the kernels and its own ``lkgd_torch``: name a parent and a change as
``parent change change parent`` to see the drift under load beside the difference. One
JSON line a root, at the microbenchmarks' default shapes: ``blocked_matmul`` at
(258048, 320) x (320, 320 | 1280) against ``x @ w``, and ``flash_variant`` ``base`` at
(140, 9216, 64) in every tile and ``bf16exp`` and ``noexp`` at the production tile
(128 x 128), against the production forward (``flash_attention``) on the same inputs; each
in ms (mean over ``--reps`` launches after a warm-up, between CUDA events; the flash times
over ``max(--reps // 5, 2)``). The card's name and power limit come first. The card only:
the kernels have no CPU form.

``run_roots`` is the tree loop that ``flash_bwd_ab`` shares.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

MATMUL_SHAPES = ((258048, 320, 320), (258048, 320, 1280))
VARIANT_SHAPE = (140, 9216, 64)
VARIANT_TILES = ((64, 64), (128, 64), (64, 128), (128, 128))


def _time_here(reps: int) -> dict:
    """Times of the ``lkgd_torch`` on ``sys.path`` (the root's), on the current card: only
    entry points that every tree since kernels 11 and 12 were ported has."""
    from lkgd_torch.experiments._timing import time_ms
    from lkgd_torch.ops import flash_attention as fa
    from lkgd_torch.ops import flash_variants as fv
    from lkgd_torch.ops import matmul as mm

    out, dev = {}, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in MATMUL_SHAPES:
        x = torch.randn((m, k), device="cuda", generator=gen).bfloat16()
        w = torch.randn((k, n), device="cuda", generator=gen).bfloat16()
        ms = time_ms(lambda: mm.blocked_matmul(x, w), dev, reps)
        lib = time_ms(lambda: x @ w, dev, reps)
        out[f"matmul_{m}x{k}x{n}"] = {"ms": ms, "library_ms": lib, "over_library": ms / lib}
        del x, w
    q, k, v = (torch.randn(VARIANT_SHAPE, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    t, flash_reps = fv.bound_t(q, k), max(reps // 5, 2)
    prod = time_ms(lambda: fa.flash_attention(q[:, :, None], k[:, :, None], v[:, :, None]),
                   dev, flash_reps)
    out["flash_production"] = {"ms": prod}
    for mode, tiles in (("base", VARIANT_TILES), ("bf16exp", ((128, 128),)),
                        ("noexp", ((128, 128),))):
        for tile in tiles:
            ms = time_ms(lambda: fv.flash_variant(q, k, v, t, mode, tile), dev, flash_reps)
            out[f"variant_{mode}_{tile[0]}x{tile[1]}"] = {"ms": ms, "over_production": ms / prod}
    return out


def run_roots(script: str, roots: list, child_args: list) -> list:
    """Run ``script --child CHILD_ARGS`` once in each root, in turn, with that root alone on
    ``PYTHONPATH``; each child prints one JSON object as its last line. Prints and returns
    ``{"root": ..., **object}`` a root."""
    rows = []
    for root in roots or [str(Path(__file__).resolve().parents[2])]:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(script), "--child", *child_args],
                              cwd=root, env={**os.environ, "PYTHONPATH": root},
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{Path(script).stem}: {root} failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        rows.append({"root": root, **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="*", help="checkouts to time, in turn (default: this one)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:  # inside a root: its own lkgd_torch, no other module of this checkout
        print(json.dumps(_time_here(args.reps)), flush=True)
        return []

    from lkgd_torch.experiments._timing import device_line
    from lkgd_torch.utils.device import require_device

    print(device_line(require_device("cuda")), flush=True)
    return run_roots(__file__, args.roots, ["--reps", str(args.reps)])


if __name__ == "__main__":
    main()
