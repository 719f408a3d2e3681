"""Int8 matmul and convolution, dynamic w8a8 (counterpart of ``lkgd_tpu/ops/quantization.py``).

Weights: symmetric int8 per output channel (scale = max|w| / 127 a column); activations:
symmetric int8 per row (the matmul) or per image (the convolution, whose reduction runs over
patches, so that the epilogue stays rank one). The codes are the JAX package's bit for bit:
the same fp32 division and round half to even (``torch.round`` as ``jnp.round``), clipped to
[-127, 127]. The products sum int8 x int8 in int32, exactly: 127^2 K stays below 2^31 for
K < 133,000, where an fp32 sum of the same codes would already round at K = 9 x 1280
(127^2 K ~ 1.9e8 > 2^24). Then an fp32 rescale, and the output in the input's dtype.

JAX computes the products in XLA (``lax.dot_general`` and ``conv_general_dilated`` with an
int32 accumulator), not in Pallas. Here, on a CUDA tensor: ``torch._int_mm`` (int8 x int8 ->
int32 on the tensor cores); the convolution as that product over its unfolded patches, since
``F.conv2d`` has no int8 form on CUDA. On a CPU tensor the plain version: the same codes
with an int64 product. Nothing in either package calls these yet (the JAX docstring's
deployment question); they are a validated primitive.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]


def _codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8: (..., C) -> (int8 values, (..., 1) fp32 scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return _codes(xf, scale), scale


def quantize_cols(w: torch.Tensor):
    """Symmetric per-output-channel int8 for a (C, F) weight: values + (F,) fp32 scale."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=0) / 127.0, min=1e-8)
    return _codes(wf, scale[None, :]), scale


def int_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, summed in int64 (exact)."""
    return (a.long() @ b.long()).int()


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32. CPU tensors: ``int_matmul_plain``. CUDA
    tensors: ``torch._int_mm``, with K and N padded with zeros to multiples of 8 and M to
    at least 17 (its shape rule), which leaves every sum as it is."""
    if a.device.type == "cpu":
        return int_matmul_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    pk, pn, pm = -k % 8, -n % 8, max(17 - m, 0)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., C) x (C, F) -> (..., F) by dynamic w8a8: an int32 product of the codes, an fp32
    rescale epilogue; the output in ``x.dtype``."""
    shape = x.shape
    xq, xs = quantize_rows(x.reshape(-1, shape[-1]))
    wq, ws = quantize_cols(w)
    y = int_matmul(xq, wq).float() * xs * ws[None, :]
    return y.to(x.dtype).reshape(*shape[:-1], w.shape[-1])


def _pads(padding: Padding, size: Sequence[int], kernel: Sequence[int],
          strides: Sequence[int]) -> list:
    """XLA's (low, high) padding of each spatial axis: "SAME" (output ceil(in / stride),
    the low side the smaller half), "VALID" or explicit pairs."""
    if isinstance(padding, str):
        if padding == "VALID":
            return [(0, 0)] * len(size)
        if padding != "SAME":
            raise ValueError(f"padding {padding!r}: SAME, VALID or (low, high) pairs")
        pads = []
        for n, k, s in zip(size, kernel, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    return [tuple(p) for p in padding]


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
                padding: Padding = "SAME") -> torch.Tensor:
    """NHWC x HWIO int8 convolution with per-output-channel weight scales and a per-image
    activation scale; output NHWC in ``x.dtype``. The patches are unfolded from the padded
    int8 codes in (kh, kw, C) order, the weight's HWIO order, and multiplied as one
    (N OH OW, kh kw C) x (kh kw C, O) int32 product."""
    n, h, wd, c = x.shape
    kh, kw, ci, co = w.shape
    if ci != c:
        raise ValueError(f"int8_conv2d: input has {c} channels, the HWIO weight {ci}")
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0, min=1e-8)
    xq = _codes(xf, xs)
    wf = w.float()
    ws = torch.clamp(wf.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-8)
    wq = _codes(wf, ws[None, None, None, :])
    (pt, pb), (pl, pr) = _pads(padding, (h, wd), (kh, kw), strides)
    xq = F.pad(xq, (0, 0, pl, pr, pt, pb))  # int8 zeros: the codes of the padding
    patches = xq.unfold(1, kh, strides[0]).unfold(2, kw, strides[1])  # (N, OH, OW, C, kh, kw)
    oh, ow = patches.shape[1:3]
    patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, kh * kw * c)
    y = int_matmul(patches, wq.reshape(kh * kw * c, co)).float().reshape(n, oh, ow, co)
    return (y * xs * ws[None, None, None, :]).to(x.dtype)


def min_quant_rows(c: int, f: int, threshold_flops: float = 2.0e8) -> int:
    """Row count above which w8a8 pays off (the JAX package's rule: the quantization passes
    cost ~2 reads of x, against half the bf16 matmul). Below it, callers keep bf16."""
    return max(1024, int(threshold_flops / max(2 * c * f, 1)))
