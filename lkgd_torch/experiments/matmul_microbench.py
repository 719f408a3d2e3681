"""Microbenchmark: the UNet's narrow-channel matrix products, the library against the
hand-written blocked kernel, and three packings of the q/k/v projections (counterpart of
``experiments/matmul_microbench.py``).

    python -m lkgd_torch.experiments.matmul_microbench

Rows printed: the card's name and power limit; the three qkv packings in plain PyTorch at
``(M/64, 64, C) x (C, 3, C)`` (separate products, one wide ``(C, 3C)`` product then a
split, a middle-axis einsum); then for each shape ``(M, K) x (K, N)`` the library's
``x @ w`` and ``blocked_matmul`` with OK or WRONG against the fp32 product, its share of
the bound (the larger of each input read and the output written once over 3.35 TB/s and
the products over 989 TFLOP/s), its multiple of the library's time, its tiling
(``matmul_plan``) and the bytes of its inputs it reads from L2 or device memory. Defaults are the UNet level-0
shapes, M = 2*14*9216 = 258048 tokens of 320 channels; ``--m``, ``--k``, ``--n`` and
``--reps`` set other sizes. Each time is the mean over ``--reps`` launches after a
warm-up, between CUDA events; the qkv packings' outputs are reduced to a scalar as in the
JAX file so that they are compared on equal terms, and the two products are timed alone.
"""

from __future__ import annotations

import argparse

import torch

from lkgd_torch.experiments._timing import device_line, time_ms
from lkgd_torch.ops.matmul import blocked_matmul, blocked_matmul_plain, l2_bytes, matmul_plan
from lkgd_torch.utils.device import require_device


# the card's published peaks (H100 SXM): device memory and bf16 tensor cores
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def _consume(out: torch.Tensor) -> torch.Tensor:
    return out.sum(dtype=torch.float32)


def bound_ms(m: int, k: int, n: int) -> float:
    """The least time of the product on the card: x and w read once and the bf16 output
    written once, or the products at the bf16 tensor-core rate, whichever is longer."""
    return max(2 * (m * k + k * n + m * n) / PEAK_BYTES, 2 * m * k * n / PEAK_BF16) * 1e3


def qkv_variants(m: int, c: int, device: torch.device, dtype: torch.dtype, reps: int,
                 generator: torch.Generator) -> dict:
    """ms of each packing of the three projections; prints one row each."""
    x = torch.randn((m // 64, 64, c), generator=generator, device=device).to(dtype)
    w3 = torch.randn((c, 3, c), generator=generator, device=device).to(dtype)
    flops = 2 * (m // 64) * 64 * c * 3 * c

    def separate():
        return sum(_consume(x @ w3[:, i]) for i in range(3))

    def wide():
        q, k, v = (x @ w3.reshape(c, 3 * c)).chunk(3, dim=-1)
        return _consume(q) + _consume(k) + _consume(v)

    def middle():
        y = torch.einsum("bsc,cpn->bspn", x, w3)
        return _consume(y[:, :, 0]) + _consume(y[:, :, 1]) + _consume(y[:, :, 2])

    out = {}
    for name, fn in (("separate", separate), ("wide+split", wide), ("middle-axis", middle)):
        out[name] = ms = time_ms(fn, device, reps)
        print(f"  qkv {name:12s}: {ms:7.3f} ms  {flops / ms / 1e9:6.1f} TF/s", flush=True)
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--m", type=int, default=258048)
    p.add_argument("--k", type=int, default=320)
    p.add_argument("--n", type=int, nargs="+", default=[320, 1280])
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args(argv)
    device = require_device(args.device)
    dtype = torch.bfloat16
    print(device_line(device), flush=True)
    generator = torch.Generator(device=device).manual_seed(0)
    qkv_variants(args.m, args.k, device, dtype, args.reps, generator)
    rows = []
    for n in args.n:
        m, k = args.m, args.k
        x = torch.randn((m, k), generator=generator, device=device).to(dtype)
        w = torch.randn((k, n), generator=generator, device=device).to(dtype)
        flops, least = 2 * m * k * n, bound_ms(m, k, n)
        lib = time_ms(lambda: x @ w, device, args.reps)
        print(f"({m},{k})x({k},{n})  library x @ w: {lib:7.3f} ms  "
              f"{flops / lib / 1e9:6.1f} TF/s  bound {least:.3f} ms", flush=True)
        ok = torch.allclose(blocked_matmul(x, w).float(),
                            blocked_matmul_plain(x.float(), w.float()), rtol=0.1, atol=1.0)
        ms = time_ms(lambda: blocked_matmul(x, w), device, args.reps)
        plan = matmul_plan(m, k, n)
        print(f"    blocked_matmul: {ms:7.3f} ms  {flops / ms / 1e9:6.1f} TF/s  "
              f"{100 * least / ms:5.1f}% of bound  {ms / lib:5.2f}x library  "
              f"{'OK' if ok else 'WRONG'}  | tile {plan.tile_rows}x{plan.tile_cols}, "
              f"{plan.blocks} blocks, x {'resident' if plan.x_resident else 'streamed'}, "
              f"{l2_bytes(m, k, n) / 1e9:.3f} GB of input reads", flush=True)
        rows.append({"shape": (m, k, n), "library_ms": lib, "kernel_ms": ms, "bound_ms": least,
                     "over_library": ms / lib, "ok": bool(ok)})
    return rows


if __name__ == "__main__":
    main()
