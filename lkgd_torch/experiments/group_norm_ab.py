"""Device and host time of the GroupNorm kernels (kernels 3 and 4), across checkouts of this
repository.

    python -m lkgd_torch.experiments.group_norm_ab [ROOT ...] [--reps 20]

Each ROOT (default: this checkout) runs in a process of its own, in the order given, with
its own build and its own ``lkgd_torch`` (``parent change change parent`` shows the drift
beside the difference), and prints one JSON line. At every ``SHAPES`` entry, bf16 with SiLU
(the resblocks' form), keyed by the shape:

* ``stats_ms``: ``group_norm_affine`` (kernel 3 and the fold into ``a, b``), mean of
  ``--reps`` calls between CUDA events after a warm-up; ``stats_device_ms``: the device time
  of everything one call enqueues, under ``torch.profiler`` (mean of 10 calls), and
  ``stats_kernel_ms`` of the launch named ``gn_stats_kernel`` alone;
* ``apply_ms`` and ``apply_device_ms``: ``group_norm_apply`` (kernel 4) the same ways;
* ``forward_ms``: ``group_norm`` (one whole forward), ``forward_device_ops``: the device
  operations one forward enqueues (kernels, memsets and copies under the profiler);
* ``library_ms``: ``F.silu(F.group_norm(...))`` on the same memory, both passes;
* ``stats_bound_ms`` and ``apply_bound_ms``: x read once (and y written once) at 3.35 TB/s;
* ``bits_repeat``: whether three calls of ``group_norm_affine`` give the same bits.

And ``host_us``: host microseconds a ``group_norm`` call at ``HOST_SHAPE``, where the
device's time is far below the host's (``relayout_ab._host_us``: the least of five rounds).
The card's name and power limit come first. The card only: the kernels have no CPU form.
"""

from __future__ import annotations

import argparse
import json

import torch

SHAPES = ((28, 9216, 320), (56, 9216, 320), (4, 129024, 320), (7, 589824, 128))
HOST_SHAPE = (2, 64, 320)
PEAK_BYTES = 3.35e12


def inputs(shape, dtype=torch.bfloat16, seed=0):
    """x (N, M, C) ~ 2 N(0, 1) + 0.5, weight ~ 1 + 0.1 N, bias ~ 0.1 N on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, device="cuda", generator=gen) * 2.0 + 0.5).to(dtype)
    w = (torch.randn(shape[-1:], device="cuda", generator=gen) * 0.1 + 1.0).to(dtype)
    b = (torch.randn(shape[-1:], device="cuda", generator=gen) * 0.1).to(dtype)
    return x, w, b


def profiled(fn, calls: int = 10) -> dict:
    """Device ms a call of ``fn`` by kernel name, and device operations a call, under
    ``torch.profiler`` (``calls`` calls after a warm-up)."""
    from torch.autograd import DeviceType

    from lkgd_torch.experiments._timing import traced

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    prof, _ = traced(run)
    ms, ops = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms[e.key] = ms.get(e.key, 0.0) + e.self_device_time_total / 1e3 / calls
            ops += e.count
    return {"ms": ms, "ops": ops / calls}


def named_ms(prof: dict, name: str) -> float:
    return sum(v for k, v in prof["ms"].items() if name in k)


def device_times(x, w, b, act="silu") -> dict:
    """Kernels 3 and 4 under the profiler on these inputs: the stats call's whole device
    time and its kernel's, the apply kernel's, and the device operations of one forward."""
    from lkgd_torch.ops import group_norm as gn

    kw = dict(num_groups=32, eps=1e-5)
    stats = profiled(lambda: gn.group_norm_affine(x, w, b, **kw))
    a, b_ = gn.group_norm_affine(x, w, b, **kw)
    apply = profiled(lambda: gn.group_norm_apply(x, a, b_, act))
    forward = profiled(lambda: gn.group_norm(x, w, b, act=act, **kw), calls=1)
    return {"stats_device_ms": sum(stats["ms"].values()),
            "stats_kernel_ms": named_ms(stats, "gn_stats_kernel"),
            "stats_device_ops": stats["ops"],
            "apply_device_ms": named_ms(apply, "gn_apply_kernel"),
            "forward_device_ops": forward["ops"]}


def _shape_row(shape, reps: int) -> dict:
    import torch.nn.functional as F

    from lkgd_torch.experiments._timing import time_ms
    from lkgd_torch.ops import group_norm as gn

    dev = torch.device("cuda")
    x, w, b = inputs(shape)
    kw = dict(num_groups=32, eps=1e-5)
    a, b_ = gn.group_norm_affine(x, w, b, **kw)
    repeats = [torch.cat(gn.group_norm_affine(x, w, b, **kw)) for _ in range(3)]
    x_nchw = x.view(shape[0], shape[1], 1, shape[2]).permute(0, 3, 1, 2)
    nbytes = x.numel() * x.element_size()
    row = {"stats_ms": time_ms(lambda: gn.group_norm_affine(x, w, b, **kw), dev, reps),
           "apply_ms": time_ms(lambda: gn.group_norm_apply(x, a, b_, "silu"), dev, reps),
           "forward_ms": time_ms(lambda: gn.group_norm(x, w, b, act="silu", **kw), dev, reps),
           "library_ms": time_ms(lambda: F.silu(F.group_norm(x_nchw, 32, w, b, 1e-5)), dev,
                                 reps),
           "stats_bound_ms": nbytes / PEAK_BYTES * 1e3,
           "apply_bound_ms": 2 * nbytes / PEAK_BYTES * 1e3,
           "bits_repeat": all(torch.equal(r, repeats[0]) for r in repeats),
           **device_times(x, w, b)}
    del x, a, b_, repeats
    torch.cuda.empty_cache()
    return row


def host_us(calls: int = 1000) -> float:
    """Host us a ``group_norm`` call at ``HOST_SHAPE`` (bf16, SiLU)."""
    from lkgd_torch.experiments.relayout_ab import _host_us
    from lkgd_torch.ops import group_norm as gn

    x, w, b = inputs(HOST_SHAPE)
    return _host_us(lambda: gn.group_norm(x, w, b, num_groups=32, eps=1e-5, act="silu"),
                    calls)[0]


def _time_here(reps: int) -> dict:
    out = {"x".join(map(str, s)): _shape_row(s, reps) for s in SHAPES}
    out["host_us"] = host_us()
    return out


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
    from lkgd_torch.experiments.kernel_ab import run_roots
    from lkgd_torch.utils.device import require_device

    print(device_line(require_device("cuda")), flush=True)
    return run_roots(__file__, args.roots, ["--reps", str(args.reps)])


if __name__ == "__main__":
    main()
