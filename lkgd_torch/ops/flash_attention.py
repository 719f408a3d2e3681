"""Flash attention: the Hopper CUDA kernels and their plain PyTorch versions.

Port of the kernels of ``lkgd_tpu/ops/flash_attention.py``. The inference forward:

* kernel 1, the bound kernel (``_flash_bound_kernel`` via ``_flash_bhsd``): softmax with a
  per-row Cauchy-Schwarz upper bound ``t_i = -scale*log2e*|q_i|*max_j|k_j|`` subtracted in
  the exp2 domain instead of a running max;
* kernel 2, the max-tracking kernel (``_flash_kernel`` via ``_flash_maxtrack_bhsd``): the
  online-max form. It is the bound kernel's fallback and, with ``LKGD_FLASH_MAXTRACK=1``,
  the kernel used outright.

The training path, ``flash_attention_differentiable``, a ``torch.autograd.Function`` in the
place of the JAX custom VJP ``_flash_core``:

* kernel 7, the bound LSE forward (``_flash_bound_lse_kernel`` via ``_flash_fwd_lse_bhsd``)
  and kernel 8, the max-tracking LSE forward (``_flash_fwd_lse_kernel`` via
  ``_flash_fwd_lse_maxtrack_bhsd``): the forwards above that also write the log2-domain
  logsumexp ``lse`` (B, H, S_q) fp32; kernel 8 is kernel 7's guard as kernel 2 is kernel
  1's. ``flash_fwd_lse`` (the port's ``flash_attention_with_lse``) takes every D the
  inference forward takes;
* kernels 9 and 10 (``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel`` via
  ``_flash_bwd_bhsd``): dq, and dk with dv, from the saved lse and ``delta =
  rowsum(dO * O)`` (fp32, PyTorch, as JAX computes it). On the card they are two
  warp-specialised ``wgmma``/TMA kernels (``csrc/flash_attention_bwd.cu``) with the TPU's
  split and no atomics, tiled as ``flash_bwd_plan`` says, at every D the forward takes: to
  D = 128 dq keeps 128 query rows of Q and dO resident and streams key tiles, dk/dv keeps
  128 keys of K and V and streams query tiles; above (the VAE mid block's D = 512), the
  wide kernel keeps 64 rows and gives its two consumer warpgroups the two halves of the
  score work, P and dS crossing between them in shared memory. All read q, k, v and dO
  through their strides, head-major copies and ``(B, S, H, D)`` projection views alike;
* kernels 5 and 6, the head split and merge copies (``_split_heads_kernel`` /
  ``_merge_heads_kernel``, each the other's VJP): with more than one head the Function
  splits q, k, v and dO into head-major copies and merges out, dq, dk and dv back, as
  ``_flash_attention_local`` does around ``_flash_core``. One launch carries up to three
  tensors (``split_heads_many`` / ``merge_heads_many``): four relayout launches a call,
  a grouped split of q, k, v and the merge of out forward, the split of dO and a grouped
  merge of dq, dk, dv backward.

On the card kernels 1, 2, 7 and 8 are one warp-specialised ``wgmma``/TMA kernel
(``csrc/flash_attention_wgmma.cu``), tiled as ``flash_plan`` says; the bound forms sum
``|q_i|`` themselves from their Q tile and take only ``max_j|k_j|`` per (batch, head) from
outside, from a small kernel of its own (``key_norm_max``; the TPU wrapper computes its
whole bound outside the Pallas kernel too). ``bound_t`` is that arithmetic's plain version.
A forward is one call into C (``lkgd_flash_forward``), which makes all its launches.

At fp32 the forward takes its fp32 form (``csrc/flash_attention_f32.cu``: 3xTF32 products,
hi.hi + hi.lo + lo.hi of each operand split into a tf32 hi and an fp32 lo, on ``wgmma`` fed
by TMA, after a pre-pass that writes the hi and lo planes of q, k and v's transpose into
scratch) from the same one call: kernels 1, 2 and 1a with the same guard, counted as
``flash_bound_fp32``, ``flash_maxtrack_fp32`` and ``flash_key_norm_fp32``, and kernels 7
and 8 (``flash_bound_lse_fp32``, ``flash_maxtrack_lse_fp32``), the same kernel writing the
lse. The fp32 backward (``csrc/flash_attention_bwd_f32.cu``, ``lkgd_flash_bwd_f32``, counted as
``flash_bwd_dq_fp32`` and ``flash_bwd_dkv_fp32``) is kernels 9 and 10 as the same 3xTF32
products on ``wgmma``, in the bf16 backward's structure, after a pre-pass that writes the hi
and lo planes of q, k, v, dO and the transposes the tf32 operands need into scratch: at D <=
64 (the fp32 UNet's heads) the narrow kernels, above the wide ones of the bf16 backward's
design, as ``flash_bwd_plan``'s ``kernel`` says. ``flash_bwd`` is one call
into C that splits each input once and launches both kernels. The JAX kernels take fp32
operands with fp32 accumulation: the temporal VAE and CLIP-H of ``cli/precompute_cache.py``
run in fp32, as the JAX CLI builds them, and so does the UNet of ``cli/train_svd_lora.py
--dtype fp32``, the JAX fine-tune CLI's own precision, whose train step runs kernels 5-10
on fp32 operands at levels 0 and 1. fp16 is taken nowhere.

The JAX wrapper reruns kernel 2 when the smallest row sum of the whole call is <= 2^-110
(``lax.cond`` on the device). Here kernel 2 is always launched after kernel 1 with
kernel 1's per-tile minimum row sums; each of its blocks returns at once unless its own
tile's minimum is <= 2^-110, and only such tiles are recomputed. No host sync is needed,
and the device counter ``recomputed_tiles(device)`` counts the recomputed tiles.

Layout: ``(B, S, H, D)`` in and out. The attention kernels read q, k, v through their
strides and write outputs in q's layout: the inference forward takes a projection's
``view`` as it is, the training Function head-major copies. On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
from typing import NamedTuple

import torch

from lkgd_torch.ops import _build

LOG2E = 1.4426950408889634
GUARD = 2.0 ** -110  # smallest row sum the bound kernel may leave (flash_attention.py:471)

# launches of each kernel since the last reset; read by chip_smoke.py
launches = {"flash_bound": 0, "flash_maxtrack": 0, "flash_key_norm": 0, "flash_bound_lse": 0,
            "flash_maxtrack_lse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "split_heads": 0, "merge_heads": 0, "flash_bound_fp32": 0,
            "flash_maxtrack_fp32": 0, "flash_key_norm_fp32": 0, "flash_bound_lse_fp32": 0,
            "flash_maxtrack_lse_fp32": 0, "flash_bwd_dq_fp32": 0, "flash_bwd_dkv_fp32": 0}
FWD_MAX_D = 512  # head dims every flash kernel (1, 2, 7-10) is built for
_recomputed: dict[torch.device, torch.Tensor] = {}


def maxtrack_selected() -> bool:
    """``LKGD_FLASH_MAXTRACK=1`` selects the max-tracking kernel, as in the JAX package."""
    return bool(os.environ.get("LKGD_FLASH_MAXTRACK"))


def recomputed_tiles(device: torch.device) -> torch.Tensor:
    """Device int32 counter of query tiles the guarded max-tracking launch recomputed."""
    device = torch.device(device)
    if device not in _recomputed:
        _recomputed[device] = torch.zeros((), dtype=torch.int32, device=device)
    return _recomputed[device]


def key_norm_max_plain(k: torch.Tensor) -> torch.Tensor:
    """(B, S_k, H, D) -> (B, H) fp32: the largest key norm of each batch and head, the part
    of the bound that kernel 1 takes from outside (``k_n`` of ``_bound_t``)."""
    return torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=1)


def key_norm_max(k: torch.Tensor) -> torch.Tensor:
    """``key_norm_max_plain`` on a CPU tensor; on a CUDA tensor (bf16, or fp32: the fp32
    form) the key-norm kernel that feeds kernel 1, launched alone (the forward launches it
    from C)."""
    if k.device.type == "cpu":
        return key_norm_max_plain(k)
    _check(k, k, k)
    b, s_k, h, d = k.shape
    _check_pairs(b, h)
    fp32 = k.dtype == torch.float32
    out = torch.empty((b, h), dtype=torch.float32, device=k.device)
    _build.check(_build.library().lkgd_flash_key_sq_max(
        k.data_ptr(), (ctypes.c_longlong * 3)(*k.stride()[:3]), b, h, s_k, d, out.data_ptr(),
        int(fp32), *stream_of(k.device)))
    launches["flash_key_norm_fp32" if fp32 else "flash_key_norm"] += 1
    return out.sqrt()


def _check_pairs(b: int, h: int) -> None:
    if b * h > 65535:  # the key-norm kernel's grid: one row of blocks a (batch, head)
        raise ValueError(f"flash_attention: {b * h} (batch, head) pairs exceed the grid")


def stream_of(device: torch.device) -> tuple[int, int]:
    """(device index, raw handle of its current stream): what a launch into C takes. The
    raw handle comes without the ``torch.cuda.Stream`` object that ``current_stream`` builds
    (several microseconds of host time a call)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


def bound_t(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, S_q, H, D), (B, S_k, H, D) -> (B, H, S_q) fp32: minus the Cauchy-Schwarz logit
    upper bound in the log2 domain (``_bound_t``, flash_attention.py:95-99). Kernels 1 and
    7 compute the same rows themselves, as ``-(|q_i| * key_norm_max) * scale * log2e`` with
    ``|q_i|`` summed in fp32 from their Q tile: this is that arithmetic's plain version,
    for the CPU and for ``ops/flash_variants.py``."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    qn = torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32)  # (B, S_q, H)
    return (-(qn * key_norm_max_plain(k)[:, None, :]) * scale2).transpose(1, 2)


SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100 (227 KB)


F32_ROWS = 128  # query rows a block of the fp32 form at D <= 128 (64 above)
F32_UNIT = 16384  # bytes of a unit of its ring: 64 rows x 32 fp32, hi and lo


def _padded(d: int) -> int:
    return 64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256 else 512


class FlashPlan(NamedTuple):
    """How the forward kernels tile one call (the host side of ``Plan`` in
    ``csrc/flash_attention_wgmma.cu``)."""
    kernel: str        # "wgmma": kernels 1/2 and 7/8 alike; "tf32x3": the fp32 form
    tile_rows: int     # query rows a block: what lkgd_flash_block_rows answers
    key_tile: int      # keys a K or V tile
    stages: int        # ring slots: K/V tiles in flight (the fp32 form: 16 KB units)
    smem_bytes: int    # dynamic shared memory a block asks for
    blocks: int        # the grid
    waves: float       # blocks over the SMs (one block an SM: its registers allow no more)


def flash_plan(b: int, s_q: int, s_k: int, h: int, d: int, lse: bool = False,
               sm_count: int = 132, fp32: bool = False) -> FlashPlan:
    """The tiling of a forward call over (b, s_q | s_k, h, d): a pure function of the
    shapes, static by d. The training forward (``lse``) is the inference kernel with one
    more store a row, so it tiles the same way, in either dtype; ``s_k`` sets only the
    length of a block's loop. ``fp32``: the fp32 form (``Plan`` in
    ``csrc/flash_attention_f32.cu``):
    64-key tiles; a ring of 16 KB units (64 rows x 32 fp32, hi and lo) filling what Q leaves
    of the block's shared memory; D <= 128: 128 query rows a block, Q's hi and lo resident;
    D = 256: 64 rows, Q resident; D = 512: 64 rows, Q streamed through the ring and 64 KB
    for the halves of S the two warpgroups exchange."""
    if d <= 0 or d % 8 or d > FWD_MAX_D:
        raise ValueError(f"flash_plan: head dim {d} (lse={lse}, fp32={fp32}) is not built")
    dp = _padded(d)
    if fp32:
        rows = F32_ROWS if dp <= 128 else 64
        q_bytes = 0 if dp > 256 else rows // 64 * dp // 32 * F32_UNIT
        x_bytes = 4 * 64 * 64 * 4 if dp > 256 else 0  # S's halves exchanged, two tiles' worth
        # 1024 of alignment slack and 512 for the barriers; one Q barrier and a full/empty
        # pair a slot
        stages = (SMEM_LIMIT - 1536 - q_bytes - x_bytes) // F32_UNIT
        smem = 1024 + q_bytes + x_bytes + stages * F32_UNIT + 8 * (1 + 2 * stages)
        blocks = b * h * math.ceil(s_q / rows)
        return FlashPlan("tf32x3", rows, 64, stages, smem, blocks, blocks / sm_count)
    rows = keys = 128 if dp <= 128 else 64
    stages = {64: 6, 128: 4, 256: 4, 512: 2}[dp]
    # 1024 of alignment slack, Q, the ring, one Q barrier and a full/empty pair a slot
    smem = 1024 + rows * dp * 2 + stages * keys * dp * 2 + 8 * (1 + 2 * stages)
    blocks = b * h * math.ceil(s_q / rows)
    return FlashPlan("wgmma", rows, keys, stages, smem, blocks, blocks / sm_count)


class FlashBwdPlan(NamedTuple):
    """How a backward kernel tiles one call (the host side of ``BwdPlan`` and ``WidePlan`` in
    ``csrc/flash_attention_bwd.cu``, or of ``TPlan`` and ``WPlan`` in
    ``flash_attention_bwd_f32.cu``)."""
    kernel: str        # "dq" (kernel 9) or "dkv" (kernel 10) in bf16 at D <= 128, "dq_wide",
                       # "dkv_wide" above; at fp32 "dq_tf32x3", "dkv_tf32x3" (D <= 64),
                       # "dq_tf32x3_wide", "dkv_tf32x3_wide" above
    tile_rows: int     # rows a block keeps resident: queries (dq) or keys (dkv), what
                       # lkgd_flash_bwd_block_rows answers
    stream_rows: int   # rows of a streamed tile: keys (dq) or queries (dkv)
    stages: int        # ring slots: K or V tiles (dq), Q and dO tile pairs (dkv); 16 KB
                       # units at fp32 and in the wide kernels (a ring each warpgroup there)
    smem_bytes: int    # dynamic shared memory a block asks for
    blocks: int        # the grid
    waves: float       # blocks over the SMs (one block an SM: its registers allow no more)
    slices: int        # blocks along the output's columns (the wide kernels; else 1)


WIDE_ROWS = 64  # resident rows a block of the wide backward kernels
BWD_EXCHANGE = 16384  # bytes the wide kernels' two warpgroups pass P and dS through


def flash_bwd_plan(b: int, s_q: int, s_k: int, h: int, d: int, dkv: bool,
                   sm_count: int = 132, fp32: bool = False) -> FlashBwdPlan:
    """The tiling of a backward call over (b, s_q | s_k, h, d): kernel 10 (``dkv``) or
    kernel 9, a pure function of the shapes, static by d padded. Every D % 8 == 0 up to 512,
    in both dtypes.

    bf16 at D <= 128 (``BwdPlan``): 128 resident rows (Q and dO, or K and V), streamed tiles of
    128 keys (dq at D <= 64) or 64 rows through a ring of tiles. fp32 at D <= 64 (``TPlan``):
    3xTF32 on wgmma, 128 resident rows of two tensors' hi and lo (128 KB), 64-row streamed
    tiles through a ring of 16 KB units filling the rest (dk/dv also keeps two tiles' lse and
    delta). Above (bf16 D > 128, fp32 D > 64) the wide kernels (``WidePlan``, ``WPlan``): 64
    rows a block and two consumer warpgroups that share one score tile through a 16 KB
    exchange, each with its own ring of 16 KB units (64 rows x 128 bf16 columns, or 64 x 32
    fp32 columns hi and lo), beside its 64 resident rows in bf16 at D = 256, with those rows
    streamed through it too at D = 512 and at fp32; a block writes up to 512 (bf16 dq), 256
    (bf16 dk/dv, fp32 dq) or 128 (fp32 dk/dv) output columns, and the grid has ``slices``
    blocks across D."""
    if d <= 0 or d % 8 or d > FWD_MAX_D:
        raise ValueError(f"flash_bwd_plan: head dim {d} (dkv={dkv}, fp32={fp32}) is not built")
    dp = _padded(d)
    own = s_k if dkv else s_q  # the block's own rows
    if fp32 and dp == 64:
        rows = F32_ROWS
        resident = 2 * rows // 64 * dp // 32 * F32_UNIT  # two tensors, hi and lo
        lse_rows = 2 * 2 * 64 * 4 if dkv else 0  # two tiles' lse and delta
        # 1024 of alignment slack and 512 for the barriers; one resident barrier and a
        # full/empty pair a unit
        stages = (SMEM_LIMIT - 1536 - resident - lse_rows) // F32_UNIT
        smem = 1024 + resident + lse_rows + stages * F32_UNIT + 8 * (1 + 2 * stages)
        blocks = b * h * math.ceil(own / rows)
        return FlashBwdPlan("dkv_tf32x3" if dkv else "dq_tf32x3", rows, 64, stages, smem, blocks,
                            blocks / sm_count, 1)
    if not fp32 and dp <= 128:
        rows = 128
        stream = 64 if dkv or dp > 64 else 128
        stages = 4 if dkv and dp > 64 else 6
        # 1024 of alignment slack, the two resident tiles, the ring (dkv: a Q and a dO tile a
        # slot, and a slot's lse and delta), one barrier for the resident tiles and a
        # full/empty pair a slot
        tiles = 2 if dkv else 1
        smem = (1024 + 2 * rows * dp * 2 + stages * tiles * stream * dp * 2
                + (stages * 2 * stream * 4 if dkv else 0) + 8 * (1 + 2 * stages))
        blocks = b * h * math.ceil(own / rows)
        return FlashBwdPlan("dkv" if dkv else "dq", rows, stream, stages, smem, blocks,
                            blocks / sm_count, 1)
    if fp32:  # 32 fp32 columns a unit; the block's own rows stream through the ring too
        units, cap = 0, 128
    else:  # 128 bf16 columns a unit, the block's own rows resident at D <= 256
        units, cap = dp // 128 if dp < 512 else 0, 256
    per_wg = min(dp, cap) if dkv else min(dp // 2, cap)  # output columns a warpgroup
    width = per_wg if dkv else 2 * per_wg  # and a block
    resident = units * F32_UNIT
    # a warpgroup's ring: its half of what 1024 of alignment slack, the exchange and 512 for
    # barriers leave; each warpgroup a full/empty pair a unit (and in bf16 the resident rows'
    # barrier)
    stages = ((SMEM_LIMIT - 1024 - BWD_EXCHANGE - 512) // 2 - resident) // F32_UNIT
    smem = (1024 + 2 * (resident + stages * F32_UNIT) + BWD_EXCHANGE
            + 2 * 8 * (int(not fp32) + 2 * stages))
    slices = math.ceil(d / width)
    blocks = b * h * math.ceil(own / WIDE_ROWS) * slices
    kernel = ("dkv" if dkv else "dq") + ("_tf32x3" if fp32 else "") + "_wide"
    return FlashBwdPlan(kernel, WIDE_ROWS, 64, stages, smem, blocks, blocks / sm_count, slices)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    return x.float().transpose(1, 2)  # (B, H, S, D) fp32


def flash_attention_maxtrack_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 2: max-subtracted exp2 softmax in fp32, output in q.dtype."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    s2 = qf @ kf.transpose(-1, -2) * scale2
    p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    out = (p @ vf) / p.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_bound_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 1 with the same guard: exp2(s + t) with the Cauchy-Schwarz
    bound t, fp32 sums; rows whose sum is not > 2^-110 take the max-tracking result."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    p = torch.exp2(qf @ kf.transpose(-1, -2) * scale2 + bound_t(q, k)[..., None])
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vf) / l
    bad = ~(l > GUARD)
    if bad.any():
        out = torch.where(bad, _heads_first(flash_attention_maxtrack_plain(q, k, v)), out)
    return out.transpose(1, 2).to(q.dtype)


def flash_fwd_lse_maxtrack_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version of kernel 8: the max-tracking forward in fp32 and its log2-domain
    logsumexp ``m + log2(l)``. Returns (out in q.dtype (B, S_q, H, D), lse (B, H, S_q))."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    s2 = qf @ kf.transpose(-1, -2) * scale2
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vf) / l
    return out.transpose(1, 2).to(q.dtype), (m + torch.log2(l))[..., 0]


def flash_fwd_lse_bound_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version of kernel 7 with its guard: exp2(s + t) with the Cauchy-Schwarz bound
    t, lse = log2(l) - t; rows whose sum is not > 2^-110 take kernel 8's result."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    t = bound_t(q, k)[..., None]
    p = torch.exp2(qf @ kf.transpose(-1, -2) * scale2 + t)
    l = p.sum(dim=-1, keepdim=True)
    out, lse = (p @ vf) / l, torch.log2(l) - t
    bad = ~(l > GUARD)
    if bad.any():
        out_m, lse_m = flash_fwd_lse_maxtrack_plain(q, k, v)
        out = torch.where(bad, _heads_first(out_m), out)
        lse = torch.where(bad, lse_m[..., None], lse)
    return out.transpose(1, 2).to(q.dtype), lse[..., 0]


def _bwd_probs_plain(q, k, v, do, lse, delta):
    """fp32 (B, H, S, D) q, k, dO and the (B, H, S_q, S_k) P = exp2(s' - lse) and
    dS = P (dO V^T - delta) that both backward kernels recompute."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    qf, kf, vf, dof = (_heads_first(x) for x in (q, k, v, do))
    p = torch.exp2(qf @ kf.transpose(-1, -2) * scale2 - lse[..., None])
    return qf, kf, dof, p, p * (dof @ vf.transpose(-1, -2) - delta[..., None])


def flash_bwd_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                       lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 9 in fp32: dQ = scale dS K, (B, S_q, H, D) in q.dtype.
    ``lse`` and ``delta`` are (B, H, S_q)."""
    _, kf, _, _, ds = _bwd_probs_plain(q, k, v, do, lse, delta)
    return (ds @ kf * q.shape[-1] ** -0.5).transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor, delta: torch.Tensor):
    """Plain version of kernel 10 in fp32: dK = scale dS^T Q and dV = P^T dO, (B, S_k, H, D)
    in k's and v's dtypes."""
    qf, _, dof, p, ds = _bwd_probs_plain(q, k, v, do, lse, delta)
    dk = ds.transpose(-1, -2) @ qf * q.shape[-1] ** -0.5
    return dk.transpose(1, 2).to(k.dtype), (p.transpose(-1, -2) @ dof).transpose(1, 2).to(v.dtype)


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                    lse: torch.Tensor, delta: torch.Tensor):
    """Plain version of kernels 9 and 10: dq, dk, dv as (B, S, H, D)."""
    return (flash_bwd_dq_plain(q, k, v, do, lse, delta),
            *flash_bwd_dkv_plain(q, k, v, do, lse, delta))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal softmax attention over ``(B, S, H, D)`` tensors, no mask.

    CPU tensors: the plain version of the selected kernel. CUDA tensors: the kernels
    (bf16, or fp32 through their fp32 form), or an error."""
    if q.device.type == "cpu":
        plain = (flash_attention_maxtrack_plain if maxtrack_selected()
                 else flash_attention_bound_plain)
        return plain(q, k, v)
    return _flash_cuda(q, k, v)


KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # what every flash kernel takes on the card


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *extra) -> None:
    """Raise on what the kernels do not take; ``extra``: (name, tensor) pairs laid out
    like q (dO in the backward). bf16, or fp32 (the fp32 forms), all of one dtype."""
    index = q.get_device()
    for name, x in (("q", q), ("k", k), ("v", v), *extra):
        if not x.is_cuda or x.get_device() != index:
            raise ValueError(f"flash_attention: {name} is on {x.device}, q on {q.device}")
        if x.dtype not in KERNEL_DTYPES:
            raise TypeError(f"flash_attention: the CUDA kernels take bfloat16 or float32, "
                            f"{name} is {x.dtype}")
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {x.dtype}, q {q.dtype}")
        st = x.stride()
        if len(st) != 4 or st[3] != 1:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, D) with unit D "
                             f"stride, got shape {tuple(x.shape)} strides {st}")
        per_row = 16 // x.element_size()  # elements of 16 bytes
        if st[0] % per_row or st[1] % per_row or st[2] % per_row or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} strides {st} and address must allow "
                             f"16-byte rows")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if d % 8 or d > FWD_MAX_D:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8, <= "
                         f"{FWD_MAX_D}")


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False):
    """The inference forward (kernels 1/2) or, ``with_lse``, the training forward (kernels
    7/8) that also returns lse (B, H, S_q), bf16 or their fp32 form: one call into C for all
    its launches."""
    _check(q, k, v)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    fp32 = q.dtype == torch.float32
    plan = flash_plan(b, s_q, s_k, h, d, with_lse, fp32=fp32)
    if plan.blocks >= 2 ** 31:
        raise ValueError(f"flash_attention: {plan.blocks} blocks exceed the grid")
    bound = not maxtrack_selected()
    out = torch.empty_like(q)  # q's layout when q is dense, else contiguous
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device) if with_lse
           else None)
    scratch = None
    if fp32:
        _check_pairs(b, h)  # the pre-pass's grid too
        # the pre-pass's hi and lo planes of q, k and V^T, |q_i|^2, then the bound's scratch
        scratch = torch.empty(_build.library().lkgd_flash_f32_scratch_floats(b, h, s_q, s_k, d),
                              dtype=torch.float32, device=q.device)
    elif bound:
        _check_pairs(b, h)
        # (B*H) largest squared key norms, then (B*H, query tiles) smallest row sums
        scratch = torch.empty(b * h * (1 + math.ceil(s_q / plan.tile_rows)),
                              dtype=torch.float32, device=q.device)
    strides = struct.pack("12q", *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                          *out.stride()[:3])
    _build.check(_build.library().lkgd_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, s_q, s_k, d,
        d ** -0.5 * LOG2E, None if scratch is None else scratch.data_ptr(),
        recomputed_tiles(q.device).data_ptr(), None if lse is None else lse.data_ptr(),
        int(bound), int(fp32), *stream_of(q.device)))
    suffix = ("_lse" if with_lse else "") + ("_fp32" if fp32 else "")
    if bound:  # the key norms, the bound kernel and its guard
        launches["flash_key_norm" + ("_fp32" if fp32 else "")] += 1
        launches["flash_bound" + suffix] += 1
    launches["flash_maxtrack" + suffix] += 1
    return (out, lse) if with_lse else out


def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The training forward: (out (B, S_q, H, D), lse (B, H, S_q) fp32, log2 domain).

    CPU tensors: the plain version of the selected kernel. CUDA tensors: kernel 7 guarded
    by kernel 8 (kernel 8 alone with ``LKGD_FLASH_MAXTRACK=1``), bf16 or their fp32 form,
    every D the inference forward takes, as the backward does."""
    if q.device.type == "cpu":
        plain = (flash_fwd_lse_maxtrack_plain if maxtrack_selected()
                 else flash_fwd_lse_bound_plain)
        return plain(q, k, v)
    return _flash_cuda(q, k, v, with_lse=True)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor):
    """dq, dk, dv (B, S, H, D) from the forward's lse and delta = rowsum(dO * O), both
    (B, H, S_q) fp32: kernel 9 then kernel 10 (their plain versions on CPU tensors); at fp32
    one call into C, one pre-pass for both."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _flash_bwd_cuda(q, k, v, do, lse, delta, dq, dk, dv)
    return dq, dk, dv


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                 lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """dq in q's layout. CPU tensors: ``flash_bwd_dq_plain``. CUDA tensors: kernel 9, bf16 or
    its fp32 form."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _flash_bwd_cuda(q, k, v, do, lse, delta, dq, None, None)
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  lse: torch.Tensor, delta: torch.Tensor):
    """(dk, dv). CPU tensors: ``flash_bwd_dkv_plain``. CUDA tensors: kernel 10."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_bwd_cuda(q, k, v, do, lse, delta, None, dk, dv)
    return dk, dv


def _flash_bwd_cuda(q, k, v, do, lse, delta, dq, dk, dv) -> None:
    """Launch kernel 9 (``dq`` given) and/or kernel 10 (``dk`` and ``dv`` given): the bf16
    forms, one C call each, or, for fp32 operands, the fp32 ones from one C call."""
    _check(q, k, v, ("dO", do))
    b, s_q, h, d = q.shape
    if do.shape != q.shape:
        raise ValueError(f"flash_bwd: dO {tuple(do.shape)} is not shaped as q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, s_q) or x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != q.device:
            raise ValueError(f"flash_bwd: {name} must be a contiguous (B, H, S_q) float32 "
                             f"tensor on q's device, got {tuple(x.shape)} {x.dtype}")
    s_k = k.shape[1]
    fp32 = q.dtype == torch.float32
    kernels = [dkv for dkv, out in ((False, dq), (True, dk)) if out is not None]
    if any(flash_bwd_plan(b, s_q, s_k, h, d, dkv, fp32=fp32).blocks >= 2 ** 31
           for dkv in kernels):
        raise ValueError(f"flash_bwd: the grid of q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"exceeds 2^31 blocks")
    # strides of the unused slots are not read
    outs = (q if dq is None else dq, k if dk is None else dk, v if dv is None else dv)
    strides = (ctypes.c_longlong * 21)(*(s for x in (q, k, v, do, *outs)
                                         for s in x.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if dq is None else dq.data_ptr(),
            None if dk is None else dk.data_ptr(), None if dv is None else dv.data_ptr(),
            strides, b, h, s_q, s_k, d, d ** -0.5, d ** -0.5 * LOG2E)
    lib = _build.library()
    if fp32:
        _check_pairs(b, h)  # the pre-pass's grid
        scratch = torch.empty(lib.lkgd_flash_bwd_f32_scratch_floats(b, h, s_q, s_k, d),
                              dtype=torch.float32, device=q.device)
        which = sum(2 if dkv else 1 for dkv in kernels)  # 1: dq, 2: dk/dv, 3: both
        _build.check(lib.lkgd_flash_bwd_f32(*args, which, scratch.data_ptr(),
                                            *stream_of(q.device)))
    else:
        for dkv in kernels:
            _build.check(lib.lkgd_flash_bwd(*args, int(dkv), *stream_of(q.device)))
    for dkv in kernels:
        launches[("flash_bwd_dkv" if dkv else "flash_bwd_dq") + ("_fp32" if fp32 else "")] += 1


def split_heads_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 5: (B, S, H, D) -> (B, H, S, D), contiguous."""
    return x.transpose(1, 2).contiguous()


def merge_heads_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 6: (B, H, S, D) -> (B, S, H, D), contiguous."""
    return x.transpose(1, 2).contiguous()


def split_heads_many_plain(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain version of one grouped launch of kernel 5: (B, S_i, H, D) tensors -> copies of
    the same shapes whose ``transpose(1, 2)`` is ``split_heads_plain`` of each."""
    return tuple(split_heads_plain(x).transpose(1, 2) for x in xs)


def merge_heads_many_plain(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain version of one grouped launch of kernel 6: (B, S_i, H, D) tensors -> their
    contiguous copies, ``merge_heads_plain`` of each one's (B, H, S_i, D) view."""
    return tuple(merge_heads_plain(x.transpose(1, 2)) for x in xs)


RELAYOUT_MAX = 3  # tensors one launch of kernel 5 or 6 takes


def split_heads_many(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Up to three (B, S_i, H, D) tensors with one B, H, D and dtype (S_i may differ: q
    and k, v) -> copies of the same shapes laid out head-major: each copy's
    ``transpose(1, 2)`` is a contiguous (B, H, S_i, D) tensor, the bytes of
    ``_split_heads``'s (B*H, S_i, D), and the flash kernels take the copies as they are.

    CPU tensors: ``split_heads_many_plain``. CUDA tensors: one launch of kernel 5, reading
    each tensor through its strides (a projection's view as it is) into one new buffer."""
    if xs[0].device.type == "cpu":
        return split_heads_many_plain(*xs)
    return _relayout_cuda(xs, True)


def merge_heads_many(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Up to three (B, S_i, H, D) tensors (head-major ones from ``split_heads_many``, or
    any with 16-byte rows) -> their contiguous copies, the bytes of ``_merge_heads``'s
    (B, S_i, H*D). CPU tensors: ``merge_heads_many_plain``. CUDA tensors: one launch of
    kernel 6 into one new buffer."""
    if xs[0].device.type == "cpu":
        return merge_heads_many_plain(*xs)
    return _relayout_cuda(xs, False)


def split_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, S, D) contiguous: ``split_heads_many`` of one tensor."""
    return split_heads_many(x)[0].transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H, D) contiguous: ``merge_heads_many`` of one tensor."""
    return merge_heads_many(x.transpose(1, 2))[0]


def _relayout_cuda(xs, split: bool) -> tuple[torch.Tensor, ...]:
    """Kernel 5 (``split``) or 6 over the (B, S_i, H, D) tensors ``xs``, read through their
    strides, in one launch into one new buffer; returns (B, S_i, H, D) views of it laid out
    (B, H, S_i, D) (``split``) or dense."""
    name = "split_heads" if split else "merge_heads"
    n = len(xs)
    if not 0 < n <= RELAYOUT_MAX:
        raise ValueError(f"{name}: takes 1 to {RELAYOUT_MAX} tensors, got {n}")
    x0 = xs[0]
    b, _, h, d = x0.shape
    dtype, index = x0.dtype, x0.get_device()
    size = x0.element_size()
    row = d * size
    args, lengths = [], []
    for x in xs:
        xb, s, xh, xd = x.shape
        sb, ss, sh, sd = x.stride()
        ptr = x.data_ptr()
        if xb != b or xh != h or xd != d or x.dtype != dtype or x.get_device() != index:
            raise ValueError(f"{name}: tensors {[tuple(t.shape) for t in xs]} "
                             f"{[t.dtype for t in xs]} differ in B, H, D, dtype or device")
        # a size-1 dimension's stride is never used: 0, whatever torch says
        sb = sb * size if b > 1 else 0
        ss = ss * size if s > 1 else 0
        sh = sh * size if h > 1 else 0
        if sd != 1 or row % 16 or sb % 16 or ss % 16 or sh % 16 or ptr % 16:
            raise ValueError(f"{name}: rows of D must be 16-byte aligned with a unit D stride, "
                             f"got shape {tuple(x.shape)} strides {x.stride()} {dtype}")
        if b * s * h * row >= 2 ** 35:
            raise ValueError(f"{name}: {b * s * h * row // 16} 16-byte chunks exceed 2^31")
        args += (ptr, sb, ss, sh, s)
        lengths.append(s)
    if lengths.count(s) == n:  # one length (self-attention): one (n, ...) buffer
        out = x0.new_empty((n, b, h, s, d) if split else (n, b, s, h, d))
        views = (out.transpose(2, 3) if split else out).unbind(0)
    else:
        out = x0.new_empty(b * h * d * sum(lengths))
        views, offset = [], 0
        for s in lengths:
            strides = (h * s * d, d, s * d, 1) if split else (s * h * d, h * d, d, 1)
            views.append(out.as_strided((b, s, h, d), strides, offset))
            offset += b * s * h * d
    # the records go in packed: one argument, where separate ones cost host time each
    _build.check(_build.library().lkgd_relayout_heads(
        int(split), n, struct.pack(f"{5 * n}q", *args), out.data_ptr(), b, h, row,
        *stream_of(x0.device)))
    launches[name] += 1
    return tuple(views)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (the JAX custom VJP ``_flash_core`` with the head
    relayouts of ``_flash_attention_local`` around it): the forward splits q, k, v into
    head-major copies (one launch of kernel 5), runs kernels 7/8, saves the copies, out and
    lse, and merges out back (kernel 6); the backward splits dO, computes delta =
    rowsum(dO * O) in fp32, runs kernels 9 and 10 and merges dq, dk, dv (one launch of
    kernel 6). With one head, as in JAX, nothing is split or merged. bf16 or fp32 (the fp32
    forms of 5-10). A dtype the backward kernels do not take is refused here, in the
    forward: a training run fails at its first step's forward and not inside
    ``backward()``. Every head dim the forward takes has its backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.is_cuda and q.dtype not in KERNEL_DTYPES:
            raise TypeError(f"flash_attention with a gradient: q is {q.dtype}; the training "
                            f"kernels (7-10) take bfloat16 or float32")
        ctx.split = q.shape[2] > 1
        if ctx.split:
            q, k, v = split_heads_many(q, k, v)
        out, lse = flash_fwd_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return merge_heads_many(out)[0] if ctx.split else out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        if ctx.split:
            (g,) = split_heads_many(g)
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        grads = flash_bwd(q, k, v, g, lse, delta)
        if ctx.split:
            grads = merge_heads_many(*grads)
        return grads


def flash_attention_differentiable(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """``flash_attention`` with a gradient: kernels 5, 7/8 and 6 forward, 5, 9/10 and 6
    backward (one launch of 5 or 6 for q, k, v or dq, dk, dv)."""
    return FlashAttentionFunction.apply(q, k, v)
