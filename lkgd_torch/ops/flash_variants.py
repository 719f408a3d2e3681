"""Variants of the bound-softmax flash forward: the Hopper CUDA kernel and its plain
PyTorch version.

Port of ``_variant_kernel`` / ``run_variant`` of ``experiments/flash_variant_microbench.py``
(kernel 12): the bound kernel's forward given the bound ``t``, with no fallback
and no logsumexp, in five modes that switch one lever each, over several tile shapes:

* ``base``: ``p = exp2(scale*log2e * q.k + t)``, ``out = (p . v) / rowsum(p)``;
* ``prescale``: q is multiplied by ``scale*log2e`` once, outside the kernel (here, in the
  wrapper), and the kernel's per-score multiply is dropped;
* ``bf16exp``: exp2 in bf16 (two scores at a time on the card), row sum in fp32;
* ``prescale_bf16exp``: both;
* ``noexp``: exp2 replaced by the identity, the floor of the products and the bookkeeping
  (arithmetic, but no softmax: for timing only).

Layout as in the JAX file: q, k, v ``(B*H, S, D)``, t ``(B*H, S_q)`` fp32 (``bound_t``
here computes it from q and k as the production path does). On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from lkgd_torch.ops import flash_attention as fa

MODES = {"base": 0, "prescale": 1, "bf16exp": 2, "prescale_bf16exp": 3, "noexp": 4}
TILES = ((64, 64), (128, 64), (64, 128), (128, 128))  # query x key rows of a block
PRODUCTION_TILE = (128, 128)  # the production forward's tiling at D=64
MAX_D = 64  # head dims the kernel is built for
STAGES = 6  # ring slots of K and V tiles

# launches of the kernel since the last reset; read by chip_smoke.py
launches = {"flash_variant": 0}


class VariantPlan(NamedTuple):
    """How kernel 12 tiles one call (the host side of ``VariantPlan`` in
    ``csrc/flash_variant.cu``; ``lkgd_flash_variant_plan`` answers the same)."""
    tile_rows: int     # query rows a block
    key_tile: int      # keys a K or V tile
    warpgroups: int    # consumer warpgroups: one for each 64 query rows
    threads: int       # and one producer warpgroup
    stages: int        # ring slots of K and V tiles
    smem_bytes: int    # dynamic shared memory a block asks for
    blocks: int        # the grid


def variant_plan(bh: int, s_q: int, tile=PRODUCTION_TILE) -> VariantPlan:
    """The tiling of a variant call over ``bh`` x ``s_q`` query rows with a ``tile`` of
    ``TILES``: a pure function of the shapes."""
    if tuple(tile) not in TILES:
        raise ValueError(f"flash_variant: tile {tuple(tile)} is not built, one of {TILES}")
    if bh <= 0 or s_q <= 0:
        raise ValueError(f"variant_plan: {bh} x {s_q} query rows")
    rows, keys = tile
    # 1024 of alignment slack, the Q tile and the ring (rows of 64 bf16), one Q barrier and
    # a full/empty pair a slot
    smem = 1024 + rows * 128 + STAGES * keys * 128 + 8 * (1 + 2 * STAGES)
    return VariantPlan(rows, keys, rows // 64, (rows // 64 + 1) * 128, STAGES, smem,
                       bh * math.ceil(s_q / rows))


def bound_t(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B*H, S_q, D), (B*H, S_k, D) -> (B*H, S_q) fp32: the production bound
    (``flash_attention.bound_t``) in this file's layout."""
    return fa.bound_t(q[:, :, None], k[:, :, None])[:, 0].contiguous()


def prescale_q(q: torch.Tensor) -> torch.Tensor:
    """q times ``scale*log2e``, rounded back to q's dtype (the ``prescale`` modes' q)."""
    return (q.float() * (q.shape[-1] ** -0.5 * fa.LOG2E)).to(q.dtype)


def flash_variant_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                        mode: str = "base") -> torch.Tensor:
    """Plain version of kernel 12, mirroring each mode: fp32 products and row sums, the
    probabilities rounded to v's dtype before ``p . v``; ``bf16exp`` rounds the scores to
    bf16 and takes exp2 in bf16, as the kernel does."""
    if mode not in MODES:
        raise ValueError(f"flash_variant: unknown mode {mode!r}, one of {sorted(MODES)}")
    scale2 = q.shape[-1] ** -0.5 * fa.LOG2E
    if "prescale" in mode:
        s = prescale_q(q).float() @ k.float().transpose(-1, -2)
    else:
        s = q.float() @ k.float().transpose(-1, -2) * scale2
    s = s + t[..., None]
    if mode.endswith("noexp"):
        p = s
    elif "bf16exp" in mode:
        p = torch.exp2(s.bfloat16())
    else:
        p = torch.exp2(s)
    l = p.float().sum(dim=-1, keepdim=True)
    return ((p.to(v.dtype).float() @ v.float()) / l).to(q.dtype)


def flash_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                  mode: str = "base", tile=(64, 64)) -> torch.Tensor:
    """One variant of the bound-softmax forward over ``(B*H, S, D)`` tensors.

    CPU tensors: ``flash_variant_plain`` (``tile`` changes no value). CUDA tensors: the
    kernel (bf16, D <= 64, ``tile`` one of ``TILES``), or an error."""
    if mode not in MODES:
        raise ValueError(f"flash_variant: unknown mode {mode!r}, one of {sorted(MODES)}")
    if tuple(tile) not in TILES:
        raise ValueError(f"flash_variant: tile {tuple(tile)} is not built, one of {TILES}")
    if q.device.type == "cpu":
        return flash_variant_plain(q, k, v, t, mode)
    from lkgd_torch.ops import _build

    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_variant: {name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_variant: the CUDA kernel takes bfloat16, {name} is {x.dtype}")
        if x.dim() != 3 or x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:2]) \
                or x.data_ptr() % 16:
            raise ValueError(f"flash_variant: {name} must be (B*H, S, D) with unit D stride and "
                             f"16-byte rows, got shape {tuple(x.shape)} strides {x.stride()}")
    bh, s_q, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_variant: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not agree")
    if d % 8 or d > MAX_D:
        raise ValueError(f"flash_variant: head dim {d} must be a multiple of 8, <= {MAX_D}")
    if t.shape != (bh, s_q) or t.dtype != torch.float32 or not t.is_contiguous() \
            or t.device != q.device:
        raise ValueError(f"flash_variant: t must be a contiguous (B*H, S_q) float32 tensor on "
                         f"q's device, got {tuple(t.shape)} {t.dtype}")
    if "prescale" in mode:
        q = prescale_q(q)
    out = torch.empty((bh, s_q, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(*(s for x in (q, k, v, out) for s in x.stride()[:2]))
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    _build.check(_build.library().lkgd_flash_variant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), t.data_ptr(), strides, bh,
        s_q, k.shape[1], d, d ** -0.5 * fa.LOG2E, MODES[mode], tile[0], tile[1], device,
        torch.cuda.current_stream(q.device).cuda_stream))
    launches["flash_variant"] += 1
    return out
