"""GroupNorm(+SiLU) over ``(N, M, C)``: the Hopper CUDA kernels and their plain versions.

Port of ``lkgd_tpu/ops/group_norm.py``: kernel 3 (``_stats_kernel``, per-(sample,
group) statistics over the M rows) and kernel 4 (``_apply_kernel``, ``act(x*a + b)`` in
fp32 stored in x.dtype), joined by ``_sums_to_affine``. In JAX the Pallas pair is opt-in
because in-graph it broke XLA's convolution fusions; in eager PyTorch the fused pass is
what saves the extra reads and writes, so here the kernels are the path.

The activations are channels-last, so a ``(N, H, W, C)`` or ``(B, T, H*W, C)`` tensor is
physically ``(N, M, C)`` and reaches the kernels as a view.

A forward on a CUDA tensor is one call into C, in one of two forms that ``fused_plan``
picks by shape before any launch:

* **one pass** (``lkgd_gn_one_pass``, launches counted as ``gn_one_pass``) where a
  sample's groups fit on chip: a thread-block cluster of up to 16 blocks holds one
  (sample, slab of whole groups in whole 32-byte sectors) in shared memory, its blocks'
  per-group (mean, M2) are merged through distributed shared memory with Chan's formula,
  and y is written from shared memory: x read once, y written once, one device
  operation. The clusters are persistent and each block double-buffered: TMA loads the
  next item while the block normalises and stores this one.
  ``group_norm_affine_slabs_plain`` is its statistics' plain version, merged in its order;
  ``group_norm_one_pass`` runs it alone on ``fused_plan``'s plan and returns its ``a, b``
  too;
* **two passes** (``lkgd_group_norm``: ``gn_stats`` then ``gn_apply``) for what does not
  fit: the stats kernel splits M into chunks and the channels into tiles of whole groups
  (``chunk_plan``) across blocks; each block writes its chunk's (mean, M2) for each of its
  groups, and the last block of a sample folds them on the device with Chan's formula in a
  fixed order (deterministic) and folds in the affine, writing ``a, b`` (N, C)
  (``fold_chunk_stats`` is that fold's plain version); the normalise pass walks the same
  grid. A memset, the statistics, the normalise pass.

Both are deterministic. There is no fallback between them: a refused launch raises. On a
CPU tensor the wrapper runs ``group_norm_plain``; on a CUDA tensor it launches the kernels
or raises.

When a gradient is wanted (grad mode on and x, weight or bias requiring one) the call goes
through ``GroupNormFunction``, the JAX package's custom VJP (``_make_op``,
group_norm.py:97-114): the forward is the same kernels, the backward recomputes the plain
formula and takes its VJP, as JAX's backward does with ``group_norm_xla``. JAX has no
GroupNorm backward kernel, so the port has none either.
"""

from __future__ import annotations

import functools
import math
import struct
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

# launches of each kernel since the last reset; read by chip_smoke.py
launches = {"gn_one_pass": 0, "gn_stats": 0, "gn_apply": 0}

_THREADS = 256       # threads a block (kThreads in csrc/group_norm.cu)
_UNROLL = 8          # rows a thread has in flight (kUnroll)
_STATS_BLOCKS = 396  # one wave of the stats kernel: 3 blocks on each of the H100's 132 SMs
# the one-pass form (csrc/group_norm.cu): groups a slab at most (kMaxSlabGroups), threads a
# block (kFusedThreads), rows of a TMA load box (kBoxRows: a block holds whole boxes),
# elements of a TMA box along a dimension (kMaxBoxDim: a slab's channels at most), shared
# memory a block (kSmemMax), blocks a cluster (kMaxCluster; above 8 non-portable), and the
# bytes a slab's rows are a multiple of (a 32-byte sector: no two clusters write one)
_MAX_SLAB_GROUPS = 128
_FUSED_THREADS = 512
_BOX_ROWS = 64
_BOX_MAX = 256
_SMEM_MAX = 232448
_MAX_CLUSTER = 16
_SECTOR = 32
_FILL = 132          # blocks that give each of the H100's 132 SMs one


def _fused_extra(slab_ch: int) -> int:
    """The one-pass form's shared memory beside a block's buffers (csrc fused_extra)."""
    return (2 * (_FUSED_THREADS // 32 + 1) * slab_ch + 7 * _MAX_SLAB_GROUPS) * 4 + 16


def _buffer_bytes(slab_ch: int) -> int:
    """The largest share of a slab a block holds: twice over (one buffer loading while the
    other is normalised) beside the form's own shared memory."""
    return (_SMEM_MAX - _fused_extra(slab_ch)) // 2


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


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


def group_norm_affine_slabs_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                  *, num_groups: int, eps: float, plan: "FusedPlan"):
    """Plain version of the one-pass kernel's statistics and fold, in its merge order: each
    of the ``plan.cluster`` blocks takes the (mean, M2) of its ``plan.rows_per_block`` rows
    of a group (the last block short), and the blocks' are merged in rank order with
    Chan's formula (``fold_chunk_stats``: the weighted mean first, the M2 about it second);
    ``a, b`` (N, C) fp32. The slab does not enter: a group's statistics are its own."""
    n, m, c = x.shape
    g, rows = num_groups, plan.rows_per_block
    xg = x.float().reshape(n, m, g, c // g)
    means, m2s = [], []
    for r in range(0, plan.cluster * rows, rows):
        block = xg[:, r:r + rows]
        mean = block.mean(dim=(1, 3))
        means.append(mean)
        m2s.append((block - mean[:, None, :, None]).square().sum(dim=(1, 3)))
    return fold_chunk_stats(torch.stack(means, dim=1), torch.stack(m2s, dim=1), rows, m,
                            weight, bias, eps=eps)


def fold_chunk_stats(mean: torch.Tensor, m2: torch.Tensor, rows_per_chunk: int, m: int,
                     weight: torch.Tensor, bias: torch.Tensor, *, eps: float):
    """Plain version of the stats kernel's fold: merge per-chunk, per-group (mean, M2) of
    shape (N, K, G) over the K chunks of ``rows_per_chunk`` rows (the last one short), each
    chunk counting its rows times the C / G channels of a group, with Chan's formula (the
    weighted mean first, the M2 about it second), into the affine ``a, b`` (N, C) fp32."""
    k = mean.shape[1]
    cg = weight.shape[0] // mean.shape[2]
    counts = torch.clamp(m - rows_per_chunk * torch.arange(k, device=mean.device),
                         max=rows_per_chunk).to(torch.float32).view(1, k, 1) * cg
    total = float(m * cg)
    gmean = (mean * counts).sum(dim=1) / total
    dev = mean - gmean[:, None, :]
    gm2 = (m2 + counts * dev * dev).sum(dim=1)
    return _affine_from_stats(gmean, torch.rsqrt(gm2 / total + eps), weight, bias)


class StatsPlan(NamedTuple):
    """The stats kernel's grid: ``tile`` channels a block (whole groups, whole 16-byte
    vectors), M in ``n_chunks`` chunks of ``rows_per_chunk`` rows, the last one short."""
    tile: int
    rows_per_chunk: int
    n_chunks: int


@functools.lru_cache(maxsize=1024)
def chunk_plan(n: int, m: int, c: int, num_groups: int, element_size: int) -> StatsPlan:
    """The stats kernel's grid for (N, M, C) with ``num_groups`` groups: the widest tile
    that divides C, holds whole groups and whole vectors and has at most one vector a
    thread (whole rows at the models' widths in bf16: one contiguous stream a block,
    measured faster than 80 or 160 channels at C=320), and as many chunks of M as fill one
    wave of the card with each thread reading at least ``_UNROLL`` rows. A group wider than
    one block's 256 vectors fits no tile: refused."""
    vec = 16 // element_size
    step = math.lcm(c // num_groups, vec)
    fits = [t for t in range(step, c + 1, step) if c % t == 0 and t // vec <= _THREADS]
    if not fits:
        raise ValueError(f"group_norm: a group of {c // num_groups} channels fits no tile "
                         f"of the stats kernel ({_THREADS} vectors of {vec} a block)")
    tile = fits[-1]
    tiles, rows_in_flight = c // tile, _THREADS // (tile // vec)
    want = max(1, _STATS_BLOCKS // (n * tiles))
    rows = max(_UNROLL * rows_in_flight, math.ceil(m / want))
    return StatsPlan(tile, rows, math.ceil(m / rows))


class FusedPlan(NamedTuple):
    """The one-pass kernel's grid: slabs of ``slab_groups`` whole groups, a cluster of
    ``cluster`` blocks a (sample, slab), each holding ``rows_per_block`` rows of it (the
    last short) in each of two buffers, ``smem_bytes`` of shared memory in all. The kernel
    launches as many clusters as the card holds at once, each walking its share of the
    items."""
    slab_groups: int
    cluster: int
    rows_per_block: int
    smem_bytes: int


@functools.lru_cache(maxsize=1024)
def fused_plan(n: int, m: int, c: int, num_groups: int, element_size: int) -> Optional[FusedPlan]:
    """The one-pass kernel's grid for (N, M, C) with ``num_groups`` groups, or None where a
    slab does not fit a cluster of 16 blocks (then the forward is two-pass).

    The slab is the fewest whole groups whose channels make rows of whole 32-byte sectors
    (so that no two clusters write one sector); the cluster the fewest blocks, a power of
    two (whole GPCs hold more such clusters), whose share of the slab's rows, in whole TMA
    boxes of ``_BOX_ROWS`` rows, fits a block twice over, raised towards one block for each
    of ``_FILL`` SMs where the items (sample, slab) alone would leave SMs idle (within a
    portable cluster, each block keeping a box of rows). A slab wider than a TMA box (256
    channels) gets no plan."""
    cg = c // num_groups
    for s in range(1, num_groups + 1):
        row = s * cg * element_size
        if num_groups % s or row % _SECTOR:
            continue
        lanes = row // 16
        if lanes > 32 or s * cg > _BOX_MAX or s > _MAX_SLAB_GROUPS or n > 65535:
            return None
        k = _pow2(math.ceil(m / (_buffer_bytes(s * cg) // row // _BOX_ROWS * _BOX_ROWS)))
        if k > _MAX_CLUSTER:
            return None
        items = n * (num_groups // s)
        k = max(k, min(8, _pow2(math.ceil(_FILL / items)), m // _BOX_ROWS))
        rows = math.ceil(m / k / _BOX_ROWS) * _BOX_ROWS
        return FusedPlan(s, math.ceil(m / rows), rows, 2 * rows * row + _fused_extra(s * cg))
    return None


def _pow2(k: int) -> int:
    return 1 << max(0, k - 1).bit_length()


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over ``(N, M, C)`` with an optional fused SiLU, in x.dtype."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm: unknown activation {act!r}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GroupNormFunction.apply(x, weight, bias, num_groups, eps, act)
    return _forward(x, weight, bias, num_groups, eps, act)


def _forward(x, weight, bias, num_groups, eps, act):
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups=num_groups, eps=eps, act=act)
    _check(x, weight, bias, num_groups)
    y = torch.empty_like(x)
    plan = fused_plan(*x.shape, num_groups, x.element_size())
    if plan is None:
        _launch(x, weight, bias, num_groups, eps, act, y)
    else:
        _launch_one_pass(x, weight, bias, num_groups, eps, act, y, plan, None)
    return y


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm with a gradient: kernels 3/4 forward, the VJP of ``group_norm_plain``
    recomputed from the saved inputs backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.options = dict(num_groups=num_groups, eps=eps, act=act)
        return _forward(x, weight, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = group_norm_plain(*inputs, **ctx.options)
        grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def _check_x(x: torch.Tensor) -> None:
    """Validate a CUDA (N, M, C) activation for the kernels."""
    if x.device.type != "cuda" or x.dim() != 3:
        raise ValueError(f"group_norm: expected a CUDA (N, M, C) tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"group_norm: the CUDA kernels take bfloat16 or float32, got {x.dtype}")
    vec = 16 // x.element_size()
    if not x.is_contiguous() or x.data_ptr() % 16 or x.shape[2] % vec:
        raise ValueError(f"group_norm: needs a contiguous 16-byte aligned (N, M, C) tensor "
                         f"with C % {vec} == 0, got {tuple(x.shape)} strides {x.stride()}")


def _check(x, weight, bias, num_groups) -> None:
    """Validate x, weight and bias of a forward for the kernels."""
    _check_x(x)
    c = x.shape[2]
    if c % num_groups:
        raise ValueError(f"group_norm: C = {c} is not a multiple of {num_groups} groups")
    if (weight.shape != (c,) or bias.shape != (c,) or weight.device != x.device
            or bias.device != x.device or weight.dtype != bias.dtype
            or weight.dtype not in _KERNEL_DTYPES or weight.stride() != (1,)
            or bias.stride() != (1,)):
        raise ValueError("group_norm: weight and bias must be contiguous (C,) tensors of one "
                         "type, bfloat16 or float32, on x's device")


def _flags(x, weight, act) -> int:
    return (int(x.dtype == torch.bfloat16) | int(weight.dtype == torch.bfloat16) << 1
            | int(act == "silu") << 2)


def _launch(x, weight, bias, num_groups, eps, act, y) -> torch.Tensor:
    """The two-pass form, one call into C: the statistics and their fold into ``a, b``,
    then, with ``y`` given, the normalise pass into it. Returns the scratch, ``a, b`` (N, C)
    at its head. The caller has checked the inputs."""
    from lkgd_torch.ops import _build
    from lkgd_torch.ops.flash_attention import stream_of

    n, m, c = x.shape
    plan = chunk_plan(n, m, c, num_groups, x.element_size())
    scratch = torch.empty(2 * n * c + 2 * n * plan.n_chunks * num_groups + n,
                          dtype=torch.float32, device=x.device)
    _build.check(_build.library().lkgd_group_norm(
        x.data_ptr(), None if y is None else y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        scratch.data_ptr(), struct.pack("8q", n, m, c, num_groups, *plan,
                                        _flags(x, weight, act)), eps, *stream_of(x.device)))
    launches["gn_stats"] += 1
    if y is not None:
        launches["gn_apply"] += 1
    return scratch


def _launch_one_pass(x, weight, bias, num_groups, eps, act, y, plan, ab) -> None:
    """The one-pass form, one launch: y, and ``a, b`` into ``ab`` (2, N, C) where given.
    The caller has checked the inputs."""
    from lkgd_torch.ops import _build
    from lkgd_torch.ops.flash_attention import stream_of

    _build.check(_build.library().lkgd_gn_one_pass(
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if ab is None else ab.data_ptr(),
        struct.pack("8q", *x.shape, num_groups, plan.slab_groups, plan.cluster,
                    plan.rows_per_block, _flags(x, weight, act)), eps, *stream_of(x.device)))
    launches["gn_one_pass"] += 1


def group_norm_one_pass(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                        num_groups: int, eps: float, act: Optional[str] = None):
    """The one-pass form alone, on ``fused_plan``'s plan (a shape with none raises):
    ``(y, a, b)``, with the affine ``a, b`` (N, C) fp32 its statistics gave. On the CPU its
    plain version."""
    if x.device.type != "cpu":
        _check(x, weight, bias, num_groups)
    n, m, c = x.shape
    plan = fused_plan(n, m, c, num_groups, x.element_size())
    if plan is None:
        raise ValueError(f"group_norm_one_pass: {tuple(x.shape)} with {num_groups} groups "
                         f"fits no cluster")
    if x.device.type == "cpu":
        a, b = group_norm_affine_slabs_plain(x, weight, bias, num_groups=num_groups, eps=eps,
                                             plan=plan)
        return group_norm_apply_plain(x, a, b, act), a, b
    y = torch.empty_like(x)
    ab = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    _launch_one_pass(x, weight, bias, num_groups, eps, act, y, plan, ab)
    return y, ab[0], ab[1]


def group_norm_affine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                      num_groups: int, eps: float):
    """Per-(sample, channel) affine ``a, b`` (N, C) fp32 of GroupNorm over ``(N, M, C)``:
    kernel 3, statistics and fold on the device (the two-pass form's first pass)."""
    if x.device.type == "cpu":
        return group_norm_affine_plain(x, weight, bias, num_groups=num_groups, eps=eps)
    _check(x, weight, bias, num_groups)
    n, _, c = x.shape
    scratch = _launch(x, weight, bias, num_groups, eps, None, None)
    return scratch[:n * c].view(n, c), scratch[n * c:2 * n * c].view(n, c)


def group_norm_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     act: Optional[str] = None) -> torch.Tensor:
    """``act(x*a + b)`` over ``(N, M, C)`` with (N, C) fp32 ``a, b``: kernel 4, on the stats
    kernel's grid (``chunk_plan`` with one 16-byte vector a group)."""
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, a, b, act)
    from lkgd_torch.ops import _build
    from lkgd_torch.ops.flash_attention import stream_of

    _check_x(x)
    n, m, c = x.shape
    a, b = a.contiguous(), b.contiguous()
    if a.shape != (n, c) or b.shape != (n, c) or a.dtype != torch.float32 or \
            b.dtype != torch.float32 or a.device != x.device or b.device != x.device:
        raise ValueError("group_norm_apply: a and b must be (N, C) float32 on x's device")
    vec = 16 // x.element_size()
    plan = chunk_plan(n, m, c, c // vec, x.element_size())
    y = torch.empty_like(x)
    _build.check(_build.library().lkgd_gn_apply(
        x.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(),
        struct.pack("8q", n, m, c, *plan, int(x.dtype == torch.bfloat16) | int(act == "silu") << 2,
                    0), *stream_of(x.device)))
    launches["gn_apply"] += 1
    return y
