"""Quaternion linear layer (counterpart of ``lkgd_tpu/ops/quaternion.py``).

Four (in/4, out/4) factors r, i, j, k share one (in, out) kernel in the Hamilton-product
block layout (rows: input groups, columns: output groups), so ``y = x @ W`` is one matmul:

    W = [[ r,  i,  j,  k],
         [-i,  r,  k, -j],
         [-j, -k,  r,  i],
         [-k,  j, -i,  r]]

Parameter names and layouts are the JAX module's (``r_weight`` .. ``k_weight`` as
(in/4, out/4), ``bias``), which are also the names its export writes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn


def assemble_quaternion_kernel(wr: torch.Tensor, wi: torch.Tensor, wj: torch.Tensor,
                               wk: torch.Tensor) -> torch.Tensor:
    """The (in, out) Hamilton-block kernel from four (in/4, out/4) factors."""
    col_r = torch.cat([wr, -wi, -wj, -wk], dim=0)
    col_i = torch.cat([wi, wr, -wk, wj], dim=0)
    col_j = torch.cat([wj, wk, wr, -wi], dim=0)
    col_k = torch.cat([wk, -wj, wi, wr], dim=0)
    return torch.cat([col_r, col_i, col_j, col_k], dim=1)


def quaternion_linear(x: torch.Tensor, wr, wi, wj, wk,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W + bias`` in x.dtype (factors and bias cast to it)."""
    kernel = assemble_quaternion_kernel(wr, wi, wj, wk).to(x.dtype)
    y = x @ kernel
    return y if bias is None else y + bias.to(x.dtype)


@torch.no_grad()
def quaternion_init(in_features: int, out_features: int, generator: torch.Generator,
                    device=None, criterion: str = "glorot"):
    """Quaternion-valued init (``quaternion_init``): chi(4)-distributed modulus with the
    glorot or he scale, a random unit imaginary axis and a uniform phase in [-pi, pi).
    Returns (wr, wi, wj, wk), each (in/4, out/4) fp32."""
    fan_in, fan_out = in_features // 4, out_features // 4
    if criterion == "glorot":
        s = 1.0 / math.sqrt(2.0 * (fan_in + fan_out))
    elif criterion == "he":
        s = 1.0 / math.sqrt(2.0 * fan_in)
    else:
        raise ValueError(criterion)
    shape = (fan_in, fan_out)
    modulus = torch.randn(shape + (4,), generator=generator, device=device).norm(dim=-1) * s
    axis = torch.randn(shape + (3,), generator=generator, device=device)
    axis = axis / (axis.norm(dim=-1, keepdim=True) + 1e-8)
    phase = (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) * math.pi
    sin = modulus * torch.sin(phase)
    return modulus * torch.cos(phase), sin * axis[..., 0], sin * axis[..., 1], sin * axis[..., 2]


class QuaternionLinear(nn.Module):
    """core_qnn's ``QuaternionLinearAutograd(in, out)``. ``dtype``: the compute dtype the
    input and parameters are cast to (None: the input's); the parameters keep their own."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_features % 4 or out_features % 4:
            raise ValueError(f"QuaternionLinear: {in_features}, {out_features} must be "
                             f"multiples of 4")
        self.in_features, self.out_features, self.dtype = in_features, out_features, dtype
        shape = (in_features // 4, out_features // 4)
        self.r_weight = nn.Parameter(torch.empty(shape))
        self.i_weight = nn.Parameter(torch.empty(shape))
        self.j_weight = nn.Parameter(torch.empty(shape))
        self.k_weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        factors = quaternion_init(self.in_features, self.out_features, generator,
                                  self.r_weight.device)
        for p, f in zip((self.r_weight, self.i_weight, self.j_weight, self.k_weight), factors):
            p.copy_(f)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        return quaternion_linear(x, self.r_weight, self.i_weight, self.j_weight, self.k_weight,
                                 self.bias)
