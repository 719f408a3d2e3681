"""Microbenchmark: the UNet's narrow-channel matrix products, the library against the
hand-written blocked kernel, and three packings of the q/k/v projections (counterpart of
``experiments/matmul_microbench.py``).

    python -m lkgd_torch.experiments.matmul_microbench

Rows printed: the card's name and power limit; the three qkv packings in plain PyTorch at
``(M/64, 64, C) x (C, 3, C)`` (separate products, one wide ``(C, 3C)`` product then a
split, a middle-axis einsum); then for each shape ``(M, K) x (K, N)`` the library's
``x @ w`` and ``blocked_matmul`` with OK or WRONG against the fp32 product. Defaults are
the UNet level-0 shapes, M = 2*14*9216 = 258048 tokens of 320 channels; ``--m``, ``--k``,
``--n`` and ``--reps`` set other sizes. Each time is the mean over ``--reps`` launches
after a warm-up, between CUDA events; every output is reduced to a scalar as in the JAX
file so that the packings are compared on equal terms.
"""

from __future__ import annotations

import argparse

import torch

from lkgd_torch.experiments._timing import device_line, time_ms
from lkgd_torch.ops.matmul import blocked_matmul, blocked_matmul_plain
from lkgd_torch.utils.device import require_device


def _consume(out: torch.Tensor) -> torch.Tensor:
    return out.sum(dtype=torch.float32)


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
        flops = 2 * m * k * n
        lib = time_ms(lambda: _consume(x @ w), device, args.reps)
        print(f"({m},{k})x({k},{n})  library x @ w: {lib:7.3f} ms  "
              f"{flops / lib / 1e9:6.1f} TF/s", flush=True)
        ok = torch.allclose(blocked_matmul(x, w).float(),
                            blocked_matmul_plain(x.float(), w.float()), rtol=0.1, atol=1.0)
        ms = time_ms(lambda: _consume(blocked_matmul(x, w)), device, args.reps)
        print(f"    blocked_matmul: {ms:7.3f} ms  {flops / ms / 1e9:6.1f} TF/s  "
              f"{'OK' if ok else 'WRONG'}", flush=True)
        rows.append({"shape": (m, k, n), "library_ms": lib, "kernel_ms": ms, "ok": bool(ok)})
    return rows


if __name__ == "__main__":
    main()
