"""Device and host time of the GroupNorm forward and its kernels (kernels 3 and 4, and the
one-pass form where a tree has it), across checkouts of this repository.

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
* ``forward_ms``: ``group_norm`` (one whole forward, whichever form the tree picks);
  ``forward_device_ms``: the device time of everything one forward enqueues under the
  profiler (mean of 10), ``forward_device_ops``: the device operations it enqueues (kernels,
  memsets and copies), ``form``: the launch counters one forward moved (``gn_one_pass``, or
  ``gn_stats`` and ``gn_apply``), read from the tree's own ``launches``;
* ``library_ms``: ``F.silu(F.group_norm(...))`` on the same memory, both passes;
* ``stats_bound_ms``: x read once; ``apply_bound_ms``, also the whole forward's bound: x
  read once and y written once, at 3.35 TB/s;
* ``bits_repeat``: whether three calls of ``group_norm_affine`` give the same bits.

At every ``FP32_SHAPES`` entry, fp32 with and without SiLU, keyed by the shape, the act and
``fp32``: ``forward_ms``, ``forward_device_ms``, ``forward_device_ops`` and ``form``, as
above.

And ``host_us``: host microseconds a ``group_norm`` call at ``HOST_SHAPE``, where the
device's time is far below the host's (``relayout_ab._host_us``: the least of five rounds);
``silu_ulps``: ``silu_ulps()``, the bf16 SiLU's largest error in bf16 ulps. The card's name
and power limit come first. The card only: the kernels have no CPU form.

With ``--lost-traces N`` a root prints instead ``lost_traces``: of N traces of 10 calls each
(``_timing.traced``), how many lost some calls' operations (an operation's count not a
multiple of 10, the trace ``profiled`` takes again), for the forward and the statistics at
each ``LOST_SHAPES`` entry, in a process that runs nothing else.
"""

from __future__ import annotations

import argparse
import json

import torch

# the UNet's level-0 spatial norm (base and trans clips), level 1 spatial and temporal, level
# 2, the level-0 temporal norms, the VAE's full resolution and SD-2D's level 0
SHAPES = ((28, 9216, 320), (56, 9216, 320), (28, 2304, 640), (2, 32256, 640),
          (28, 576, 1280), (2, 129024, 320), (4, 129024, 320), (7, 589824, 128),
          (2, 4096, 320))
# the fp32 fine-tune's level-0 spatial norm and the UNet's level 0 at fp32
FP32_SHAPES = ((14, 4096, 320), (28, 9216, 320))
HOST_SHAPE = (2, 64, 320)
# chip_smoke.py phase 3c's (COG_GN): the CogVideoX decoder's full resolution and level 2
LOST_SHAPES = ((1, 49 * 480 * 720, 128), (1, 25 * 240 * 360, 256))
PEAK_BYTES = 3.35e12


def inputs(shape, dtype=torch.bfloat16, seed=0):
    """x (N, M, C) ~ 2 N(0, 1) + 0.5, weight ~ 1 + 0.1 N, bias ~ 0.1 N on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, device="cuda", generator=gen) * 2.0 + 0.5).to(dtype)
    w = (torch.randn(shape[-1:], device="cuda", generator=gen) * 0.1 + 1.0).to(dtype)
    b = (torch.randn(shape[-1:], device="cuda", generator=gen) * 0.1).to(dtype)
    return x, w, b


def profiled(fn, calls: int = 10, tries: int = 4) -> dict:
    """Device ms a call of ``fn`` by kernel name, and device operations a call, under
    ``torch.profiler`` (``calls`` calls after a warm-up). Every call enqueues the same
    operations, so each one's count is a multiple of ``calls``; a trace where one is not has
    lost events (the card's tracer has dropped one call's operations) and is taken again, up
    to ``tries`` times (each one counted in ``_timing.trace_counts["lost"]``), then this
    raises."""
    import sys

    from torch.autograd import DeviceType

    from lkgd_torch.experiments._timing import trace_counts, traced

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for k in range(tries):
        prof, _ = traced(run)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if all(e.count % calls == 0 for e in events):
            break
        trace_counts["lost"] += 1
        print(f"[profiler] trace {k + 1} of {tries} lost operations ("
              + ", ".join(f"{e.key[:60]} x{e.count}" for e in events) + f" over {calls} "
              f"calls); tracing again", file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"torch.profiler lost operations in {tries} traces of {calls} calls")
    ms, ops = {}, 0
    for e in events:
        ms[e.key] = ms.get(e.key, 0.0) + e.self_device_time_total / 1e3 / calls
        ops += e.count
    return {"ms": ms, "ops": ops / calls}


def named_ms(prof: dict, name: str) -> float:
    return sum(v for k, v in prof["ms"].items() if name in k)


def device_times(x, w, b, act="silu") -> dict:
    """Kernels 3 and 4 alone under the profiler on these inputs (the stats call's whole
    device time and its kernel's, the apply kernel's), and one whole forward: its device
    time, its device operations and the launch counters it moved (its form)."""
    from lkgd_torch.ops import group_norm as gn

    kw = dict(num_groups=32, eps=1e-5)
    stats = profiled(lambda: gn.group_norm_affine(x, w, b, **kw))
    a, b_ = gn.group_norm_affine(x, w, b, **kw)
    apply = profiled(lambda: gn.group_norm_apply(x, a, b_, act))
    forward = profiled(lambda: gn.group_norm(x, w, b, act=act, **kw))
    before = dict(gn.launches)
    gn.group_norm(x, w, b, act=act, **kw)
    return {"stats_device_ms": sum(stats["ms"].values()),
            "stats_kernel_ms": named_ms(stats, "gn_stats_kernel"),
            "stats_device_ops": stats["ops"],
            "apply_device_ms": named_ms(apply, "gn_apply_kernel"),
            "forward_device_ms": sum(forward["ms"].values()),
            "forward_device_ops": forward["ops"],
            "form": "+".join(k for k in gn.launches if gn.launches[k] != before[k])}


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


def _fp32_row(shape, act, reps: int) -> dict:
    from lkgd_torch.experiments._timing import time_ms
    from lkgd_torch.ops import group_norm as gn

    x, w, b = inputs(shape, torch.float32)
    kw = dict(num_groups=32, eps=1e-5)
    forward = profiled(lambda: gn.group_norm(x, w, b, act=act, **kw))
    before = dict(gn.launches)
    gn.group_norm(x, w, b, act=act, **kw)
    row = {"forward_ms": time_ms(lambda: gn.group_norm(x, w, b, act=act, **kw),
                                 torch.device("cuda"), reps),
           "forward_device_ms": sum(forward["ms"].values()),
           "forward_device_ops": forward["ops"],
           "form": "+".join(k for k in gn.launches if gn.launches[k] != before[k])}
    del x
    torch.cuda.empty_cache()
    return row


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in units of the last place of ``want`` rounded to bf16 (8 significant
    bits: 2^(e - 8) for ``want`` in [2^(e-1), 2^e))."""
    _, e = torch.frexp(want.double())
    return (got.double() - want.double()).abs() / torch.ldexp(torch.ones_like(want.double()),
                                                              e - 8)


def silu_ulps(device: str = "cuda") -> dict:
    """The bf16 SiLU of both kernels against ``t * sigmoid(t)`` in fp64 on the exact
    ``t``, in bf16 ulps (largest, and the ``t`` where it is): kernel 4 (``apply``) on every
    bf16 value in [-20, 20] with a = 1, b = 0 (but those under 2^-100 in magnitude, whose
    SiLU is near the bottom of the fp32 range); the one-pass kernel (``one_pass``, where the
    tree has it) on rows spread evenly over [-1, 1] with weight 11.5 (t over about
    [-20, 20]), its t from its own a and b."""
    from lkgd_torch.ops import group_norm as gn

    def worst(got, t):
        t = t.double()
        err = bf16_ulps(got, t * torch.sigmoid(t))
        i = int(err.argmax())
        return {"max_ulps": err.max().item(), "at_t": t.flatten()[i].item()}

    bits = torch.arange(0x0D80, 0x41A1, dtype=torch.int32)  # bf16 2^-100 .. 20
    pos = bits.to(torch.int16).view(torch.bfloat16)
    vals = torch.cat([pos.new_zeros(1), pos, -pos])
    c = 256
    x = torch.zeros(-(-vals.numel() // c) * c, dtype=torch.bfloat16)
    x[:vals.numel()] = vals
    x = x.view(1, -1, c).to(device)
    ones = torch.ones((1, c), device=device)
    out = {"apply": worst(gn.group_norm_apply(x, ones, ones * 0, "silu"), x.float())}
    if hasattr(gn, "group_norm_one_pass"):
        shape = (2, 4096, 320)
        rows = torch.linspace(-1.0, 1.0, shape[1], device=device)
        x = rows[None, :, None].expand(shape).to(torch.bfloat16).contiguous()
        w = torch.full((shape[2],), 11.5, device=device, dtype=torch.bfloat16)
        y, a, b = gn.group_norm_one_pass(x, w, w * 0, num_groups=32, eps=1e-5, act="silu")
        t = x.double() * a.double()[:, None, :] + b.double()[:, None, :]
        out["one_pass"] = {**worst(y, t), "t_min": t.min().item(), "t_max": t.max().item()}
    return out


def host_us(calls: int = 1000) -> float:
    """Host us a ``group_norm`` call at ``HOST_SHAPE`` (bf16, SiLU)."""
    from lkgd_torch.experiments.relayout_ab import _host_us
    from lkgd_torch.ops import group_norm as gn

    x, w, b = inputs(HOST_SHAPE)
    return _host_us(lambda: gn.group_norm(x, w, b, num_groups=32, eps=1e-5, act="silu"),
                    calls)[0]


def lost_traces(n: int, calls: int = 10) -> dict:
    """Of ``n`` traces of ``calls`` calls, how many lost operations, by shape and call."""
    from torch.autograd import DeviceType

    from lkgd_torch.experiments._timing import traced
    from lkgd_torch.ops import group_norm as gn

    kw, out = dict(num_groups=32, eps=1e-6), {}
    for shape in LOST_SHAPES:
        x, w, b = inputs(shape)
        for name, fn in (("forward", lambda: gn.group_norm(x, w, b, act="silu", **kw)),
                         ("stats", lambda: gn.group_norm_affine(x, w, b, **kw))):
            def run():
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()

            run()
            out[f"{'x'.join(map(str, shape))} {name}"] = sum(
                any(e.count % calls for e in traced(run)[0].key_averages()
                    if e.device_type == DeviceType.CUDA) for _ in range(n))
        del x
        torch.cuda.empty_cache()
    return {"lost_traces": out, "traces_each": n}


def _time_here(reps: int) -> dict:
    out = {"x".join(map(str, s)): _shape_row(s, reps) for s in SHAPES}
    for shape in FP32_SHAPES:
        for act in ("silu", None):
            out[f"{'x'.join(map(str, shape))} fp32 {act}"] = _fp32_row(shape, act, reps)
    out["host_us"] = host_us()
    out["silu_ulps"] = silu_ulps()
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="*", help="checkouts to time, in turn (default: this one)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--lost-traces", type=int, default=0, metavar="N",
                   help="count lost traces in N traces a call instead of timing")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:  # inside a root: its own lkgd_torch, no other module of this checkout
        print(json.dumps(lost_traces(args.lost_traces) if args.lost_traces
                         else _time_here(args.reps)), flush=True)
        return []

    from lkgd_torch.experiments._timing import device_line
    from lkgd_torch.experiments.kernel_ab import run_roots
    from lkgd_torch.utils.device import require_device

    print(device_line(require_device("cuda")), flush=True)
    return run_roots(__file__, args.roots, ["--reps", str(args.reps),
                                            "--lost-traces", str(args.lost_traces)])


if __name__ == "__main__":
    main()
