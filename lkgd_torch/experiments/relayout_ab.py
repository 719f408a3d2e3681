"""Host and device time of the head relayouts (kernels 5 and 6), across checkouts of this
repository.

    python -m lkgd_torch.experiments.relayout_ab [ROOT ...] [--calls 1000] [--reps 50]

Each ROOT (default: this checkout) runs in a process of its own, in the order given, with
its own build and its own ``lkgd_torch`` (``parent change change parent`` shows the drift
beside the difference), and prints one JSON line:

* ``host_us``: host microseconds a call, the least of five rounds of ``--calls``
  back-to-back enqueues between two ``time.perf_counter_ns`` readings with one
  ``torch.cuda.synchronize()`` after each round, at (1, 128, 5, 64) bf16 where the
  device's time (``device_us``: 100 of the calls run back to back between CUDA events) is
  far below the host's: the single ``split_heads``, ``split_heads_many`` of one and of
  three views where the root has it, one and three ``transpose(1, 2).contiguous()``, a bare
  ``torch.empty`` and ``new_empty``, the parts of a wrapper call (the ctypes strides array
  of the single-tensor entry before the grouped one, ``torch.cuda.current_stream(...)
  .cuda_stream`` and the raw handle the grouped wrappers take instead, the device index,
  ``data_ptr``, ``stride``, ``_build.library()``, the bare C call with its arguments made
  beforehand, ``_build.check``), what ctypes charges for the arguments of a call alone
  (``rig_*``: scalars, one packed bytes, a ctypes array), and the training flash forward
  ``flash_fwd_lse`` (the key norms' fill and kernel, the bound kernel and its guard);
* ``device``, where the root has the grouped wrappers: at 3 x (8, 4096, 5, 64) and
  3 x (8, 1024, 10, 64), the grouped split of three projection views and the grouped merge
  back in ms (mean of ``--reps`` calls between CUDA events after a warm-up), the device
  ms of one launch of each under ``torch.profiler``, three ``transpose(1, 2).contiguous()``
  calls beside them, the bound (each byte read once and written once at 3.35 TB/s), and
  whether the copies give the plain version's bits.

The card's name and power limit come first. The card only: the kernels have no CPU form.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import struct
import time

import torch

HOST_SHAPE = (1, 128, 5, 64)
DEVICE_SHAPES = ((8, 4096, 5, 64), (8, 1024, 10, 64))
PEAK_BYTES = 3.35e12


def _host_us(fn, calls: int, rounds: int = 5) -> tuple[float, float]:
    """(host us, device us) a call of ``fn``: the least over ``rounds`` of ``calls``
    enqueues after a warm-up between two host clock readings (the host is shared: the least
    is the call's own cost), then up to 100 calls run back to back on the card (queued
    behind a spin of the card's own, so the host's pace does not show) between CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    host = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        host = min(host, (time.perf_counter_ns() - t0) / 1e3 / calls)
        torch.cuda.synchronize()
    n = min(calls, 100)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) * 1e3 / n


def _views(shape, seed=0):
    """Three (B, S_i, H, D) bf16 views: q from a fused qkv projection, k and v from a
    fused kv projection, as the attention layers hand them over."""
    b, s, h, d = shape
    c = h * d
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * c), device="cuda", generator=gen).bfloat16()
    kv = torch.randn((b, s, 2 * c), device="cuda", generator=gen).bfloat16()
    return (qkv[..., :c].unflatten(-1, (h, d)), kv[..., :c].unflatten(-1, (h, d)),
            kv[..., c:].unflatten(-1, (h, d)))


def host_parts(calls: int) -> dict:
    """``host_us`` and ``device_us`` of the docstring, on the current card."""
    from lkgd_torch.ops import _build
    from lkgd_torch.ops import flash_attention as fa

    xs = _views(HOST_SHAPE)
    x = xs[0]
    b, s, h, d = x.shape
    dev = x.device
    lib = _build.library()
    out = torch.empty((b, h, s, d), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    strides = [st * 2 for st in x.stride()[:3]]
    grouped = len(lib.lkgd_relayout_heads.argtypes) == 9
    if grouped:  # the grouped entry: up to three tensors, their records packed in bytes
        args = (1, 1, struct.pack("5q", x.data_ptr(), *strides, s), out.data_ptr(), b, h,
                d * 2, dev.index, stream)
    else:  # the single-tensor entry: a ctypes array of strides
        args = (x.data_ptr(), out.data_ptr(), (ctypes.c_longlong * 3)(*strides), b, s, h,
                d * 2 // 16, 1, dev.index, stream)
    cases = {
        "split_heads": lambda: fa.split_heads(x),
        "transpose_contiguous": lambda: x.transpose(1, 2).contiguous(),
        "transpose_contiguous_x3": lambda: [y.transpose(1, 2).contiguous() for y in xs],
        "torch_empty": lambda: torch.empty((b, h, s, d), dtype=x.dtype, device=dev),
        "new_empty": lambda: x.new_empty((b, h, s, d)),
        "part_ctypes_array3": lambda: (ctypes.c_longlong * 3)(*strides),
        "part_current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "part_raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "flash_fwd_lse": lambda: fa.flash_fwd_lse(*xs),
        "part_device_index": lambda: (dev.index if dev.index is not None
                                      else torch.cuda.current_device()),
        "part_data_ptr": lambda: x.data_ptr(),
        "part_stride": lambda: x.stride(),
        "part_library": _build.library,
        "part_c_call": lambda: lib.lkgd_relayout_heads(*args),
        "part_check": lambda: _build.check(0),
    }
    cases.update(_ctypes_rig())
    if hasattr(fa, "split_heads_many"):
        cases["split_heads_many_x1"] = lambda: fa.split_heads_many(x)
        cases["split_heads_many_x3"] = lambda: fa.split_heads_many(*xs)
    host, device = {}, {}
    for name, fn in cases.items():
        host[name], device[name] = _host_us(fn, calls)
    return {"host_us": host, "device_us": device, "grouped_entry": grouped}


def _ctypes_rig() -> dict:
    """What ctypes charges for the arguments alone: libc's ``getpid`` (which reads none of
    them) called through prototypes of the relayout entries' shapes: 23 scalars (three
    tensors' records as separate arguments), 9 with the records as one ``struct.pack``
    bytes, 9 with them in a ctypes array built a call; and the packing alone."""
    libc = ctypes.CDLL(None)
    ll, ptr, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int

    def proto(*types):
        return ctypes.CFUNCTYPE(i, *types)(("getpid", libc))

    scalars = proto(i, i, *(ptr, ll, ll, ll, i) * 3, ptr, i, i, i, i, ptr)
    packed = proto(i, i, ctypes.c_char_p, ptr, i, i, i, i, ptr)
    array = proto(i, i, ctypes.POINTER(ll), ptr, i, i, i, i, ptr)
    record, address = (1 << 40, 1280, 640, 128, 4096) * 3, 1 << 40
    array15 = ll * 15
    return {
        "rig_23_scalar_args": lambda: scalars(1, 3, *record, address, 8, 5, 128, 0, address),
        "rig_9_args_packed": lambda: packed(1, 3, struct.pack("15q", *record), address, 8, 5,
                                            128, 0, address),
        "rig_9_args_ctypes_array": lambda: array(1, 3, array15(*record), address, 8, 5, 128,
                                                 0, address),
        "rig_struct_pack_15": lambda: struct.pack("15q", *record),
    }


def _profiled_ms(fn, name: str) -> float:
    """Device ms of one launch of the kernel whose name holds ``name`` under the profiler."""
    from torch.autograd import DeviceType

    from lkgd_torch.experiments._timing import traced

    def run():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    prof, _ = traced(run)
    times = [(e.self_device_time_total, e.count) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key]
    return sum(t for t, _ in times) / max(sum(n for _, n in times), 1) / 1e3


def _device(reps: int) -> dict:
    """The grouped split and merge at the fine-tune's level-0 and level-1 shapes."""
    from lkgd_torch.experiments._timing import time_ms
    from lkgd_torch.ops import flash_attention as fa

    dev, out = torch.device("cuda"), {}
    for shape in DEVICE_SHAPES:
        xs = _views(shape, seed=1)
        split = fa.split_heads_many(*xs)
        merged = fa.merge_heads_many(*split)
        nbytes = sum(x.numel() for x in xs) * 2
        out["x".join(map(str, shape))] = {
            "bound_ms": 2 * nbytes / PEAK_BYTES * 1e3,
            "library_x3_ms": time_ms(lambda: [x.transpose(1, 2).contiguous() for x in xs],
                                     dev, reps),
            "split_ms": time_ms(lambda: fa.split_heads_many(*xs), dev, reps),
            "merge_ms": time_ms(lambda: fa.merge_heads_many(*split), dev, reps),
            "split_profiled_ms": _profiled_ms(lambda: fa.split_heads_many(*xs),
                                              "relayout_heads_kernel<true>"),
            "merge_profiled_ms": _profiled_ms(lambda: fa.merge_heads_many(*split),
                                              "relayout_heads_kernel<false>"),
            "bit_exact": all(torch.equal(g, w) for g, w in zip(
                (*split, *merged), (*fa.split_heads_many_plain(*xs), *xs)))}
        del xs, split, merged
    return out


def _time_here(calls: int, reps: int) -> dict:
    from lkgd_torch.ops import flash_attention as fa

    out = host_parts(calls)
    if hasattr(fa, "split_heads_many"):
        out["device"] = _device(reps)
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="*", help="checkouts to time, in turn (default: this one)")
    p.add_argument("--calls", type=int, default=1000)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:  # inside a root: its own lkgd_torch, no other module of this checkout
        print(json.dumps(_time_here(args.calls, args.reps)), flush=True)
        return []

    from lkgd_torch.experiments._timing import device_line
    from lkgd_torch.experiments.kernel_ab import run_roots
    from lkgd_torch.utils.device import require_device

    print(device_line(require_device("cuda")), flush=True)
    return run_roots(__file__, args.roots,
                     ["--calls", str(args.calls), "--reps", str(args.reps)])


if __name__ == "__main__":
    main()
