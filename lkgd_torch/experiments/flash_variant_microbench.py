"""Microbenchmark: the levers inside the bound-softmax flash forward, one at a time, at the
UNet's dominant attention shape (counterpart of
``experiments/flash_variant_microbench.py``).

    python -m lkgd_torch.experiments.flash_variant_microbench

Rows printed: the card's name and power limit; ``wrapper``, the production path
(``flash_attention``: the key-norm kernel, the wgmma bound kernel, the guarded max-tracking
launch); ``library``, ``scaled_dot_product_attention`` on the same inputs, with the bound
(``4*S^2*D*B*H`` operations at 989 TFLOP/s, or the inputs and output over 3.35 TB/s); then
each mode of ``flash_variant`` (``base``, ``prescale``, ``bf16exp``, ``prescale_bf16exp``,
``noexp``) at each tile shape, with its time, its rate, its share of the bound, its
multiple of the library's time and of ``base`` at the same tile, and ``max|d-base|``
against the ``base`` result of the first tile (``noexp`` is no softmax: nan). Defaults are
UNet level 0 of a CFG-doubled 14-frame clip, ``(B*H, S, D) = (140, 9216, 64)``; ``--bh``,
``--s``, ``--d``, ``--tiles`` and ``--reps`` set other sizes. The bound ``t`` is computed
once, outside the timed calls, as the kernel takes it as an input. Each time is the mean
over ``--reps`` launches after a warm-up, between CUDA events.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from lkgd_torch.experiments._timing import device_line, time_ms
from lkgd_torch.ops.flash_attention import flash_attention
from lkgd_torch.ops.flash_variants import MODES, TILES, bound_t, flash_variant
from lkgd_torch.utils.device import require_device

# the card's published peaks (H100 SXM): device memory and bf16 tensor cores
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--bh", type=int, default=140)
    p.add_argument("--s", type=int, default=9216)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--tiles", nargs="+", default=[f"{q}x{k}" for q, k in TILES],
                   help="query x key rows of a block, e.g. 64x64 128x64")
    p.add_argument("--reps", type=int, default=8)
    args = p.parse_args(argv)
    device = require_device(args.device)
    tiles = [tuple(int(v) for v in t.split("x")) for t in args.tiles]
    print(device_line(device), flush=True)
    generator = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((args.bh, args.s, args.d), generator=generator,
                           device=device).bfloat16() for _ in range(3))
    t = bound_t(q, k)
    flops = 4 * args.s * args.s * args.d * args.bh
    # q, k, v read and the output written once in bf16, t read once in fp32
    least = max(flops / PEAK_BF16, (8 * args.s * args.d + 4 * args.s) * args.bh / PEAK_BYTES) * 1e3

    ms = time_ms(lambda: flash_attention(q[:, :, None], k[:, :, None], v[:, :, None]), device,
                 args.reps)
    print(f"wrapper      : {ms:8.2f} ms {flops / ms / 1e9:6.1f} TF/s", flush=True)
    lib = time_ms(lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None]),
                  device, args.reps)
    print(f"library      : {lib:8.2f} ms {flops / lib / 1e9:6.1f} TF/s (sdpa); bound "
          f"{least:.3f} ms", flush=True)
    ref = flash_variant(q, k, v, t, "base", tiles[0]).float()
    rows, base_ms = [], {}
    for mode in MODES:
        for tile in tiles:
            ms = time_ms(lambda: flash_variant(q, k, v, t, mode, tile), device, args.reps)
            base_ms.setdefault(tile, ms)  # "base" comes first
            got = flash_variant(q, k, v, t, mode, tile).float()
            err = (got - ref).abs().max().item() if mode != "noexp" else float("nan")
            print(f"{mode:16s} ({tile[0]},{tile[1]}): {ms:8.2f} ms {flops / ms / 1e9:6.1f} "
                  f"TF/s {100 * least / ms:5.1f}% of bound {ms / lib:5.2f}x library "
                  f"{ms / base_ms[tile]:5.3f}x base max|d-base|={err:.2e}", flush=True)
            rows.append({"mode": mode, "tile": tile, "ms": ms, "max_abs_diff": err,
                         "bound_ms": least, "over_library": ms / lib,
                         "over_base": ms / base_ms[tile]})
    return rows


if __name__ == "__main__":
    main()
