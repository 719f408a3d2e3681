"""Latent-knowledge fusion, the LKGD conditioning block (counterpart of
``lkgd_tpu/ops/fusion.py``).

Three depthwise 4->1 compressors reduce the CLIP context and the domain and flow knowledge
features to d = ctx_dim/4 tokens; a quaternion linear fuses them with a learned context
(spatial branch); the magnitudes and phases of their length-d rFFTs are fused by two more
quaternion linears and a Linear(4, 1) each for the Nyquist bin, and inverted with an
irFFT of length 2d (spectral branch); a two-layer MLP recombines the branches into the
cross-attention context.

The spectral branch uses ``torch.fft.rfft`` / ``irfft`` in fp32. The JAX package computes
the same transforms as real DFT matmuls (``lkgd_tpu/ops/real_fft.py``) only because its
TPU backend has no complex dtypes; the tests hold the two against each other. As there,
the imaginary parts of the exactly-real DC and Nyquist bins are pinned to +0.0, and the
magnitude and phase are guarded at zero bins so their gradients stay finite.

Compute dtypes follow the JAX module: the compressors, the spatial quaternion linear and
the recombining MLP run in the caller's compute dtype; the spectral quaternion linears and
the Nyquist Linear layers in fp32 whatever it is. Parameters keep their own dtype (fp32
when trained) and are cast at use. Names are the JAX module's export names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import ZeroInitLinear
from lkgd_torch.ops.quaternion import QuaternionLinear


def interpolate_linear_1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resize the last axis linearly (``F.interpolate(mode="linear",
    align_corners=False)``), in x.dtype."""
    in_size = x.shape[-1]
    if in_size == out_size:
        return x
    coords = (torch.arange(out_size, dtype=torch.float32, device=x.device) + 0.5) * (
        in_size / out_size) - 0.5
    coords = coords.clamp(0.0, in_size - 1)
    lo = coords.floor().long()
    hi = (lo + 1).clamp(max=in_size - 1)
    w = (coords - lo.float()).to(x.dtype)
    return x[..., lo] * (1.0 - w) + x[..., hi] * w


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Linear layer in ``dtype`` (flax ``nn.Dense(dtype=...)``: input and params cast)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    None if layer.bias is None else layer.bias.to(dtype))


class DepthwiseCompressor(nn.Module):
    """Conv1d(in_dim -> out_dim, kernel 1, groups out_dim, no bias): output o is a learned
    combination of input channels [g*o, g*(o+1)). ``weight`` is (out_dim, g)."""

    def __init__(self, in_dim: int = 1024, out_dim: Optional[int] = None):
        super().__init__()
        self.out_dim = out_dim or in_dim // 4
        self.group = in_dim // self.out_dim
        self.weight = nn.Parameter(torch.empty(self.out_dim, self.group))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        # flax's lecun_normal over the (out_dim, g) shape takes fan_in = out_dim
        self.weight.normal_(0.0, self.out_dim ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xg = x.reshape(*x.shape[:-1], self.out_dim, self.group).to(dtype)
        return torch.einsum("...og,og->...o", xg, self.weight.to(dtype))


class LatentKnowledgeFusion(nn.Module):
    """Fuse the context (B, L, ctx_dim: SVD's CLIP token, CogVideoX's T5 tokens) with the
    domain and flow knowledge features (B, L or 1, any width; absent ones are zeros).
    Returns (B, L, ctx_dim). ``zero_init_output``: the recombining MLP's last linear starts
    at zero (CogVideoX), so that a fresh fusion adds nothing."""

    def __init__(self, ctx_dim: int = 1024, knowledge_dim: Optional[int] = None,
                 compress_dim: Optional[int] = None, sf_hidden: Optional[int] = None,
                 zero_init_output: bool = False):
        super().__init__()
        d = self.d = compress_dim or ctx_dim // 4
        n_bins = d // 2 + 1
        self.ctx_dim = ctx_dim
        self.kdim = knowledge_dim or ctx_dim
        self.lconv = DepthwiseCompressor(ctx_dim, out_dim=d)
        self.dconv = DepthwiseCompressor(self.kdim, out_dim=d)
        self.fconv = DepthwiseCompressor(self.kdim, out_dim=d)
        self.texts = nn.Parameter(torch.zeros(d))
        self.fuse = QuaternionLinear(4 * d, 2 * d)
        self.texts_fft_mag = nn.Parameter(torch.zeros(n_bins))
        self.texts_fft_pha = nn.Parameter(torch.zeros(n_bins))
        self.fuse_fft_mag = QuaternionLinear(2 * d, d, dtype=torch.float32)
        self.fuse_fft_pha = QuaternionLinear(2 * d, d, dtype=torch.float32)
        self.fuse_fft_mag0 = nn.Linear(4, 1)
        self.fuse_fft_pha0 = nn.Linear(4, 1)
        self.fuse_sf_0 = nn.Linear(4 * d, sf_hidden or d)
        self.fuse_sf_2 = (ZeroInitLinear if zero_init_output else nn.Linear)(sf_hidden or d,
                                                                             ctx_dim)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        for p in (self.texts, self.texts_fft_mag, self.texts_fft_pha):
            p.zero_()

    def forward(self, context: torch.Tensor, domain: Optional[torch.Tensor] = None,
                flow: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or context.dtype
        lh = self.lconv(context, dtype)  # (B, L, d)
        zeros = context.new_zeros(context.shape[:-1] + (self.kdim,))
        ld = self.dconv(interpolate_linear_1d(zeros if domain is None else domain, self.kdim),
                        dtype)
        lf = self.fconv(interpolate_linear_1d(zeros if flow is None else flow, self.kdim),
                        dtype)
        if ld.shape[1] != lh.shape[1] and ld.shape[1] == 1:
            # one knowledge token for every context token
            ld, lf = ld.expand(lh.shape), lf.expand(lh.shape)
        if ld.shape[0] != lh.shape[0] and ld.shape[0] == 1:
            # a CFG-doubled context with knowledge features of one side
            ld, lf = torch.cat([ld, ld]), torch.cat([lf, lf])
        ctx_learn = self.texts.to(lh.dtype).expand(lh.shape)

        spatial = self.fuse(torch.cat([lh, ld, lf, ctx_learn], dim=-1))  # (B, L, 2d)

        mags, phas = [], []
        for t in (lh, ld, lf):
            spec = torch.fft.rfft(t.float(), dim=-1)
            zero = torch.zeros_like(spec.imag[..., :1])
            re, im = spec.real, torch.cat([zero, spec.imag[..., 1:-1], zero], dim=-1)
            mag2 = re * re + im * im
            mags.append(torch.sqrt(mag2 + 1e-20))
            safe = mag2 > 1e-20
            phas.append(torch.atan2(torch.where(safe, im, 0.0), torch.where(safe, re, 1.0)))
        mags.append(self.texts_fft_mag.float().expand(mags[0].shape))
        phas.append(self.texts_fft_pha.float().expand(phas[0].shape))

        mag = self.fuse_fft_mag(torch.cat([m[..., :-1] for m in mags], dim=-1))  # (B, L, d)
        pha = self.fuse_fft_pha(torch.cat([p[..., :-1] for p in phas], dim=-1))
        f32 = torch.float32
        mag0 = _dense(self.fuse_fft_mag0, torch.stack([m[..., -1] for m in mags], dim=-1), f32)
        pha0 = _dense(self.fuse_fft_pha0, torch.stack([p[..., -1] for p in phas], dim=-1), f32)
        spec_re = torch.cat([mag * torch.cos(pha), mag0 * torch.cos(pha0)], dim=-1)  # d + 1
        spec_im = torch.cat([mag * torch.sin(pha), mag0 * torch.sin(pha0)], dim=-1)
        spectral = torch.fft.irfft(torch.complex(spec_re, spec_im), n=2 * self.d, dim=-1)

        h = torch.cat([spatial, spectral.to(spatial.dtype)], dim=-1)  # (B, L, 4d)
        h = F.leaky_relu(_dense(self.fuse_sf_0, h, dtype), negative_slope=0.1)
        return _dense(self.fuse_sf_2, h, dtype)
