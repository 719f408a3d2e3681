"""Blocked matrix product: the Hopper CUDA kernel and its plain PyTorch version.

Port of ``pallas_matmul`` of ``experiments/matmul_microbench.py`` (kernel 11): ``out (M, N)
= x (M, K) . w (K, N)`` with fp32 accumulation, cast to the input type. The TPU kernel
keeps all of ``w`` in fast memory beside a block of ``bm`` rows of ``x``; the CUDA kernel
(``csrc/blocked_matmul.cu``, wgmma and TMA) keeps a 128-row block of ``x`` in shared memory
instead and streams ``w`` through it in 128-wide column tiles, since ``w`` does not fit a
block's shared memory on this card. ``matmul_plan`` is that tiling, computed on the host.

It is a kernel of its own, measured against the library's ``x @ w`` by
``lkgd_torch/experiments/matmul_microbench.py``; the models' linears stay ``nn.Linear``,
as the JAX package left them to XLA. On a CPU tensor the wrapper runs the plain version;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# launches of the kernel since the last reset; read by chip_smoke.py
launches = {"blocked_matmul": 0}

TILE_ROWS, TILE_COLS = 128, 128  # an output tile: 64 rows for each consumer warpgroup
X_STAGES, W_STAGES = 6, 6        # 64-deep x panels and 64 x 128 w chunks in shared memory
H100_SMS = 132


class MatmulPlan(NamedTuple):
    """How kernel 11 tiles one product (the host side of the constants and ``plan_args``
    in ``csrc/blocked_matmul.cu``; ``lkgd_matmul_plan`` answers the same)."""
    tile_rows: int        # output rows of a tile
    tile_cols: int        # output columns of a tile
    x_stages: int         # 64-deep panels of x in shared memory
    w_stages: int         # ring slots of w chunks (64 rows of K x tile_cols)
    smem_bytes: int       # dynamic shared memory a block asks for
    blocks: int           # the persistent grid: at most one block an SM
    tiles_per_block: int  # the most output tiles one block walks
    x_resident: bool      # a row block of x stays for all its column tiles (K <= 384)


def matmul_plan(m: int, k: int, n: int, sm_count: int = H100_SMS) -> MatmulPlan:
    """The tiling of an ``(m, k) x (k, n)`` product on a card of ``sm_count`` SMs: a pure
    function of the shapes."""
    if m <= 0 or k <= 0 or n <= 0 or sm_count <= 0:
        raise ValueError(f"matmul_plan: shapes {(m, k, n)} on {sm_count} SMs")
    # 1024 of alignment slack, the x panels (128 rows x 64 bf16), the w ring, the staged
    # bf16 output tile, and a full/empty barrier pair for every x and w slot
    smem = (1024 + X_STAGES * TILE_ROWS * 128 + W_STAGES * 64 * TILE_COLS * 2
            + TILE_ROWS * TILE_COLS * 2 + 8 * 2 * (X_STAGES + W_STAGES))
    row_blocks = math.ceil(m / TILE_ROWS)
    blocks = min(row_blocks, sm_count)
    return MatmulPlan(TILE_ROWS, TILE_COLS, X_STAGES, W_STAGES, smem, blocks,
                      math.ceil(row_blocks / blocks) * math.ceil(n / TILE_COLS),
                      math.ceil(k / 64) <= X_STAGES)


def l2_bytes(m: int, k: int, n: int) -> int:
    """Bytes of the inputs kernel 11 reads from L2 or device memory: w once for every
    128-row block of x, and x once, or once for every column tile where it is streamed."""
    resident = matmul_plan(m, k, n).x_resident
    return (math.ceil(m / TILE_ROWS) * k * n * 2
            + m * k * 2 * (1 if resident else math.ceil(n / TILE_COLS)))


def blocked_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 11: the product in fp32, cast to x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def blocked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (M, K) . w (K, N)`` -> ``(M, N)`` in x's dtype, accumulated in fp32.

    CPU tensors: ``blocked_matmul_plain``. CUDA tensors: the kernel (dense row-major bf16,
    K and N multiples of 8; a ragged M, K or N is masked in the kernel), or an error."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"blocked_matmul: shapes x {tuple(x.shape)}, w {tuple(w.shape)} do "
                         f"not form (M, K) x (K, N)")
    if x.device.type == "cpu":
        return blocked_matmul_plain(x, w)
    from lkgd_torch.ops import _build

    for name, t in (("x", x), ("w", w)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"blocked_matmul: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"blocked_matmul: the CUDA kernel takes bfloat16, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"blocked_matmul: {name} must be dense row-major and 16-byte "
                             f"aligned, got strides {t.stride()}")
    (m, k), n = x.shape, w.shape[1]
    if k % 8:
        raise ValueError(f"blocked_matmul: K = {k} must be a multiple of 8 (16-byte rows of x)")
    if n % 8:
        raise ValueError(f"blocked_matmul: N = {n} must be a multiple of 8 (16-byte rows of w "
                         f"and of the output)")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"blocked_matmul: a dimension of {(m, k, n)} exceeds 2^31")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    _build.check(_build.library().lkgd_blocked_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, device,
        torch.cuda.current_stream(x.device).cuda_stream))
    launches["blocked_matmul"] += 1
    return out
