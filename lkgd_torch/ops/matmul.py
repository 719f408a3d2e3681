"""Blocked matrix product: the Hopper CUDA kernel and its plain PyTorch version.

Port of ``pallas_matmul`` of ``experiments/matmul_microbench.py`` (kernel 11): ``out (M, N)
= x (M, K) . w (K, N)`` with fp32 accumulation, cast to the input type. The TPU kernel
keeps all of ``w`` in fast memory beside a block of ``bm`` rows of ``x``; the CUDA kernel
(``csrc/blocked_matmul.cu``) tiles N as well and streams K, since ``w`` does not fit a
block's shared memory on this card.

It is a kernel of its own, measured against the library's ``x @ w`` by
``lkgd_torch/experiments/matmul_microbench.py``; the models' linears stay ``nn.Linear``,
as the JAX package left them to XLA. On a CPU tensor the wrapper runs the plain version;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

# launches of the kernel since the last reset; read by chip_smoke.py
launches = {"blocked_matmul": 0}


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
