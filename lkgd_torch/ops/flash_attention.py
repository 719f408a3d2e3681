"""Flash-attention forward: the Hopper CUDA kernels and their plain PyTorch versions.

Port of the inference kernels of ``lkgd_tpu/ops/flash_attention.py``:

* kernel 1, the bound kernel (``_flash_bound_kernel`` via ``_flash_bhsd``): softmax with a
  per-row Cauchy-Schwarz upper bound ``t_i = -scale*log2e*|q_i|*max_j|k_j|`` subtracted in
  the exp2 domain instead of a running max;
* kernel 2, the max-tracking kernel (``_flash_kernel`` via ``_flash_maxtrack_bhsd``): the
  online-max form. It is the bound kernel's fallback and, with ``LKGD_FLASH_MAXTRACK=1``,
  the kernel used outright.

The JAX wrapper reruns kernel 2 when the smallest row sum of the whole call is <= 2^-110
(``lax.cond`` on the device). Here kernel 2 is always launched after kernel 1 with
kernel 1's per-tile minimum row sums; each of its blocks returns at once unless its own
tile's minimum is <= 2^-110, and only such tiles are recomputed. No host sync is needed,
and the device counter ``recomputed_tiles(device)`` counts the recomputed tiles.

Layout: ``(B, S, H, D)`` in and out. The kernels read q, k, v through their strides (a
projection's ``view``, no head-split copy) and write ``(B, S, H, D)`` output. On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches the kernels or
raises.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

LOG2E = 1.4426950408889634
GUARD = 2.0 ** -110  # smallest row sum the bound kernel may leave (flash_attention.py:471)

# launches of each kernel since the last reset; read by chip_smoke.py
launches = {"flash_bound": 0, "flash_maxtrack": 0}
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


def bound_t(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, S_q, H, D), (B, S_k, H, D) -> (B, H, S_q) fp32: minus the Cauchy-Schwarz logit
    upper bound in the log2 domain (``_bound_t``, flash_attention.py:95-99)."""
    scale2 = q.shape[-1] ** -0.5 * LOG2E
    qn = torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32)  # (B, S_q, H)
    kn = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=1)  # (B, H)
    return (-(qn * kn[:, None, :]) * scale2).transpose(1, 2)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal softmax attention over ``(B, S, H, D)`` tensors, no mask.

    CPU tensors: the plain version of the selected kernel. CUDA tensors: the kernels
    (bf16 only), or an error."""
    if q.device.type == "cpu":
        plain = (flash_attention_maxtrack_plain if maxtrack_selected()
                 else flash_attention_bound_plain)
        return plain(q, k, v)
    return _flash_cuda(q, k, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: the CUDA kernels take bfloat16, {name} is "
                            f"{x.dtype}")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, D) with unit D "
                             f"stride, got shape {tuple(x.shape)} strides {x.stride()}")
        if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} strides {x.stride()} and address "
                             f"must allow 16-byte rows")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if d % 8 or d > 512:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8, <= 512")


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    from lkgd_torch.ops import _build

    _check(q, k, v)
    lib = _build.library()
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                        *out.stride()[:3])
    n_q_tiles = math.ceil(s_q / lib.lkgd_flash_block_rows(d))
    if b * h * n_q_tiles >= 2 ** 31:
        raise ValueError(f"flash_attention: {b * h * n_q_tiles} blocks exceed the grid")
    scale2 = d ** -0.5 * LOG2E
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counter = recomputed_tiles(q.device)

    def launch(bound: bool, t, tile_min):
        _build.check(lib.lkgd_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, s_q,
            s_k, d, scale2, None if t is None else t.data_ptr(),
            None if tile_min is None else tile_min.data_ptr(), counter.data_ptr(),
            int(bound), device, stream))

    if maxtrack_selected():
        launch(False, None, None)
        launches["flash_maxtrack"] += 1
        return out
    t = bound_t(q, k).contiguous()  # (B*H, S_q) rows
    tile_min = torch.empty((b * h, n_q_tiles), dtype=torch.float32, device=q.device)
    launch(True, t, tile_min)
    launches["flash_bound"] += 1
    launch(False, None, tile_min)  # the guard: recomputes only underflowed tiles
    launches["flash_maxtrack"] += 1
    return out
