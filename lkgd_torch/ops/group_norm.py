"""GroupNorm(+SiLU) over ``(N, M, C)``: the Hopper CUDA kernels and their plain version.

Port of ``lkgd_tpu/ops/group_norm.py``: kernel 3 (``_stats_kernel``, per-(sample,
channel) statistics over the M rows) and kernel 4 (``_apply_kernel``, ``act(x*a + b)`` in
fp32 stored in x.dtype), joined by ``_sums_to_affine``. In JAX the Pallas pair is opt-in
because in-graph it broke XLA's convolution fusions; in eager PyTorch the fused pass is
what saves the extra reads and writes, so here the kernels are the path.

The activations are channels-last, so a ``(N, H, W, C)`` or ``(B, T, H*W, C)`` tensor is
physically ``(N, M, C)`` and reaches the kernels as a view.

The stats kernel splits M into chunks across blocks and writes per-chunk (mean, M2) for
every channel; ``fold_chunk_stats`` merges the chunks and the channels of each group in
plain PyTorch with Chan's formula (deterministic, no atomics) and folds in the affine.
On a CPU tensor the wrapper runs ``group_norm_plain``; on a CUDA tensor it launches the
kernels or raises.

When a gradient is wanted (grad mode on and x, weight or bias requiring one) the call goes
through ``GroupNormFunction``, the JAX package's custom VJP (``_make_op``,
group_norm.py:97-114): the forward is the same kernels, the backward recomputes the plain
formula and takes its VJP, as JAX's backward does with ``group_norm_xla``. JAX has no
GroupNorm backward kernel, so the port has none either.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# launches of each kernel since the last reset; read by chip_smoke.py
launches = {"gn_stats": 0, "gn_apply": 0}

_TILE = 64             # channels a stats block covers (kTile in csrc/group_norm.cu)
_THREADS = 256         # threads a block (kThreads)
_TARGET_BLOCKS = 1056  # 8 blocks for each of the H100's 132 SMs


def _affine_from_stats(mean_g: torch.Tensor, inv_g: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor):
    """Per-group mean and inverse std (N, G) + the learned affine -> per-(sample, channel)
    ``a, b`` (fp32) so the normalise pass is one ``act(x*a + b)``."""
    c = weight.shape[0]
    rep = c // mean_g.shape[-1]
    inv_c = inv_g.repeat_interleave(rep, dim=-1)
    mean_c = mean_g.repeat_interleave(rep, dim=-1)
    a = inv_c * weight.float()[None, :]
    return a, bias.float()[None, :] - mean_c * a


def group_norm_affine_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                            num_groups: int, eps: float):
    """Plain version of kernel 3 and the fold: per-(sample, channel) ``a, b`` (N, C) fp32.
    fp32 input: the exact centred two-pass statistics of ``group_norm_xla``; other dtypes:
    one-pass fp32 sum and sum of squares."""
    n, m, c = x.shape
    g = num_groups
    n_elem = m * (c // g)
    if x.dtype == torch.float32:
        xg = x.reshape(n, m, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        xc = xg - mean
        inv = torch.rsqrt(torch.einsum("nmgk,nmgk->ng", xc, xc) / n_elem + eps)
        return _affine_from_stats(mean.reshape(n, g), inv, weight, bias)
    xf = x.float()
    s1 = xf.sum(dim=1).reshape(n, g, c // g).sum(dim=-1)
    s2 = (xf * xf).sum(dim=1).reshape(n, g, c // g).sum(dim=-1)
    mean = s1 / n_elem
    var = torch.clamp(s2 / n_elem - mean * mean, min=0.0)
    return _affine_from_stats(mean, torch.rsqrt(var + eps), weight, bias)


def group_norm_apply_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                           act: Optional[str] = None) -> torch.Tensor:
    """Plain version of kernel 4: ``act(x*a + b)`` in fp32, stored in x.dtype."""
    y = x.float() * a[:, None, :] + b[:, None, :]
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                     num_groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """Plain version of kernels 3 and 4 together."""
    a, b = group_norm_affine_plain(x, weight, bias, num_groups=num_groups, eps=eps)
    return group_norm_apply_plain(x, a, b, act)


def fold_chunk_stats(mean: torch.Tensor, m2: torch.Tensor, rows_per_chunk: int, m: int,
                     weight: torch.Tensor, bias: torch.Tensor, *, num_groups: int,
                     eps: float):
    """Merge per-chunk, per-channel (mean, M2) of shape (N, K, C) over the K chunks of
    ``rows_per_chunk`` rows (the last one short) and the channels of each group, with
    Chan's formula, into the affine ``a, b`` (N, C) fp32."""
    n, k, c = mean.shape
    g = num_groups
    cg = c // g
    counts = torch.clamp(m - rows_per_chunk * torch.arange(k, device=mean.device),
                         max=rows_per_chunk).to(torch.float32).view(1, k, 1, 1)
    mean_g = mean.view(n, k, g, cg)
    total = float(m * cg)
    gmean = (mean_g * counts).sum(dim=(1, 3)) / total
    dev = mean_g - gmean[:, None, :, None]
    gm2 = m2.view(n, k, g, cg).sum(dim=(1, 3)) + (counts * dev * dev).sum(dim=(1, 3))
    return _affine_from_stats(gmean, torch.rsqrt(gm2 / total + eps), weight, bias)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over ``(N, M, C)`` with an optional fused SiLU, in x.dtype."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm: unknown activation {act!r}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GroupNormFunction.apply(x, weight, bias, num_groups, eps, act)
    a, b = group_norm_affine(x, weight, bias, num_groups=num_groups, eps=eps)
    return group_norm_apply(x, a, b, act)


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm with a gradient: kernels 3/4 forward, the VJP of ``group_norm_plain``
    recomputed from the saved inputs backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.options = dict(num_groups=num_groups, eps=eps, act=act)
        a, b = group_norm_affine(x, weight, bias, num_groups=num_groups, eps=eps)
        return group_norm_apply(x, a, b, act)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = group_norm_plain(*inputs, **ctx.options)
        grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def chunk_plan(n: int, m: int, c: int):
    """(rows_per_chunk, n_chunks) for the stats pass: enough blocks to fill the card,
    at least 32 rows a chunk."""
    want = max(1, math.ceil(_TARGET_BLOCKS / (n * math.ceil(c / _TILE))))
    rows = max(32, math.ceil(m / want))
    return rows, math.ceil(m / rows)


def _check_cuda(x: torch.Tensor, num_groups: int = 1) -> int:
    """Validate a CUDA (N, M, C) activation for the kernels; returns the vector width."""
    if x.device.type != "cuda" or x.dim() != 3:
        raise ValueError(f"group_norm: expected a CUDA (N, M, C) tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm: the CUDA kernels take bfloat16 or float32, got {x.dtype}")
    c = x.shape[2]
    vec = 16 // x.element_size()
    if not x.is_contiguous() or x.data_ptr() % 16 or c % vec or c % num_groups:
        raise ValueError(f"group_norm: needs a contiguous 16-byte aligned (N, M, C) tensor "
                         f"with C % {vec} == 0 and C % groups == 0, got {tuple(x.shape)} "
                         f"strides {x.stride()}")
    return vec


def _device_and_stream(x: torch.Tensor):
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return device, torch.cuda.current_stream(x.device).cuda_stream


def group_norm_affine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                      num_groups: int, eps: float):
    """Per-(sample, channel) affine ``a, b`` (N, C) fp32 of GroupNorm over ``(N, M, C)``:
    kernel 3 on per-chunk statistics, then ``fold_chunk_stats``."""
    if x.device.type == "cpu":
        return group_norm_affine_plain(x, weight, bias, num_groups=num_groups, eps=eps)
    from lkgd_torch.ops import _build

    _check_cuda(x, num_groups)
    n, m, c = x.shape
    if weight.shape != (c,) or bias.shape != (c,) or weight.device != x.device:
        raise ValueError("group_norm: weight and bias must be (C,) on x's device")
    lib = _build.library()
    device, stream = _device_and_stream(x)
    rows, n_chunks = chunk_plan(n, m, c)
    mean = torch.empty((n, n_chunks, c), dtype=torch.float32, device=x.device)
    m2 = torch.empty_like(mean)
    _build.check(lib.lkgd_gn_stats(x.data_ptr(), mean.data_ptr(), m2.data_ptr(), n, m, c,
                                   rows, n_chunks, int(x.dtype == torch.bfloat16), device,
                                   stream))
    launches["gn_stats"] += 1
    return fold_chunk_stats(mean, m2, rows, m, weight, bias, num_groups=num_groups, eps=eps)


def group_norm_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     act: Optional[str] = None) -> torch.Tensor:
    """``act(x*a + b)`` over ``(N, M, C)`` with (N, C) fp32 ``a, b``: kernel 4."""
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, a, b, act)
    from lkgd_torch.ops import _build

    vec = _check_cuda(x)
    n, m, c = x.shape
    a, b = a.contiguous(), b.contiguous()
    if a.shape != (n, c) or b.shape != (n, c) or a.dtype != torch.float32 or \
            b.dtype != torch.float32 or a.device != x.device or b.device != x.device:
        raise ValueError("group_norm_apply: a and b must be (N, C) float32 on x's device")
    lib = _build.library()
    device, stream = _device_and_stream(x)
    y = torch.empty_like(x)
    blocks_x = max(1, min(math.ceil(m * c / (vec * _THREADS)),
                          math.ceil(4 * _TARGET_BLOCKS / n)))
    _build.check(lib.lkgd_gn_apply(x.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(), n,
                                   m * c, c, int(act == "silu"),
                                   int(x.dtype == torch.bfloat16), blocks_x, device, stream))
    launches["gn_apply"] += 1
    return y
