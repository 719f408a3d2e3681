"""Time the flash backward (kernels 9 and 10) against the library's backward, in turns
across checkouts of this repository.

    python -m lkgd_torch.experiments.flash_bwd_ab [ROOT ...] [--reps 20] [--shapes fp32]

Each ROOT (default: this checkout) runs in a process of its own, in the order given, with
its own build of the kernels and its own ``lkgd_torch``: name a parent and a change as
``parent change change parent`` to see the drift under load beside the difference. bf16 at
the fine-tune's level-0 and level-1 shapes and at D=128 (``--shapes bf16``, the default),
the fp32 forms at D=128, (1,1024,4,128) and (8,4096,2,128) (``fp32``), or the wide kernels
at the VAE mid block's (8,4096,1,512) and at (8,4096,2,256) in bf16 (``bf16-wide``) and at
(8,4096,1,512) in fp32 (``fp32-wide``); one JSON line a root: ``flash_bwd_dq``,
``flash_bwd_dkv`` and their sum in ms (mean over ``--reps`` launches after a warm-up,
between CUDA events; at fp32 each with its own pre-pass), the pair from one ``flash_bwd``
call (``call_ms``), the library's backward on the same inputs (autograd through
``scaled_dot_product_attention``: dq, dk and dv together; TF32 off) and the pair's ratio to
it. The card's name and power limit come first. The card only: the kernels have no CPU
form.
(``kernel_ab`` times kernels 11 and 12 the same way, with the same tree loop.)
"""

from __future__ import annotations

import argparse
import json

import torch

SHAPES = {"bf16": ((8, 4096, 5, 64), (8, 1024, 10, 64), (2, 2048, 4, 128)),
          "fp32": ((1, 1024, 4, 128), (8, 4096, 2, 128)),
          "bf16-wide": ((8, 4096, 1, 512), (8, 4096, 2, 256)),
          "fp32-wide": ((8, 4096, 1, 512),)}


def _time_here(reps: int, shapes: str) -> dict:
    """Times of the ``lkgd_torch`` on ``sys.path`` (the root's), on the current card."""
    import torch.nn.functional as F

    from lkgd_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.float32 if shapes.startswith("fp32") else torch.bfloat16

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {}
    for shape in SHAPES[shapes]:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dt)
                       for _ in range(4))
        o, lse = fa.flash_fwd_lse(q, k, v)
        args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous())
        dq, dkv = ms(lambda: fa.flash_bwd_dq(*args)), ms(lambda: fa.flash_bwd_dkv(*args))
        call = ms(lambda: fa.flash_bwd(*args))
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves)
        lib = ms(lambda: torch.autograd.grad(lib_out, leaves, do.transpose(1, 2),
                                             retain_graph=True))
        out["x".join(map(str, shape))] = {"dq_ms": dq, "dkv_ms": dkv, "pair_ms": dq + dkv,
                                          "call_ms": call, "library_ms": lib,
                                          "pair_over_library": (dq + dkv) / lib}
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="*", help="checkouts to time, in turn (default: this one)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--shapes", choices=sorted(SHAPES), default="bf16")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:  # inside a root: its own lkgd_torch, no other module of this checkout
        print(json.dumps(_time_here(args.reps, args.shapes)), flush=True)
        return []

    from lkgd_torch.experiments._timing import device_line
    from lkgd_torch.experiments.kernel_ab import run_roots
    from lkgd_torch.utils.device import require_device

    print(device_line(require_device("cuda")), flush=True)
    return run_roots(__file__, args.roots, ["--reps", str(args.reps), "--shapes", args.shapes])


if __name__ == "__main__":
    main()
