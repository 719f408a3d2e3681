"""RAFT optical flow (counterpart of ``lkgd_tpu/models/raft.py``), the point tracker's flow.

torchvision's ``raft_large`` layout: feature (instance norm) and context (inference batch
norm with frozen statistics, eps 1e-5) encoders of (64, 64, 96, 128) residual stages and a
1x1 to 256 channels at 1/8 resolution; the all-pairs correlation volume (one matmul, scaled
by C^-1/2) average-pooled into a pyramid over the second image's grid; a radius-4 lookup of
every level by bilinear sampling; ``iters`` tied iterations of the motion encoder,
SepConvGRU (1x5 then 5x1) and flow head; the 0.25-scaled convex-upsampling mask head.

Activations are channels-last ``(B, H, W, C)``; convolutions run on cuDNN (no kernel of the
port's own: the JAX module runs none). Module names are torchvision's, so the
``raft_large`` state dict loads with ``load_state_dict(strict=True)``
(``lkgd_torch/utils/manifests/raft_large.json``); its BatchNorms' ``num_batches_tracked``
are dropped on load, as torchvision's ``FrozenBatchNorm2d`` drops them. The UniMatch
helpers (``instance_norm``, ``coords_grid``, ``bilinear_sample``,
``upsample_flow_with_mask``) are shared with ``models/unimatch.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import Conv2d, init_params, materialize
from lkgd_torch.models.unimatch import (bilinear_sample, coords_grid, instance_norm,
                                        upsample_flow_with_mask)
from lkgd_torch.utils.device import require_device


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    feature_dims: Tuple[int, ...] = (64, 64, 96, 128)  # conv1 + 3 residual stages
    out_dim: int = 256
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    downsample: int = 8

    @classmethod
    def large(cls) -> "RAFTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "RAFTConfig":
        return cls(feature_dims=(8, 8, 12, 16), out_dim=32, hidden_dim=16,
                   context_dim=16, corr_levels=2, corr_radius=2, iters=2)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm over the last axis with frozen running statistics (eps 1e-5):
    parameters ``weight``, ``bias``, buffers ``running_mean``, ``running_var``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return x * inv + (self.bias - self.running_mean * inv)


class InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def _conv_norm(cin: int, cout: int, k: int, stride: int, norm: str, relu: bool = True
               ) -> nn.Sequential:
    """torchvision ``Conv2dNormActivation``: ``.0`` conv without bias, ``.1`` norm."""
    layers = [Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False),
              FrozenBatchNorm(cout) if norm == "batch" else InstanceNorm()]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class ResidualBlock(nn.Module):
    """Two 3x3 conv-norm-ReLUs and, where the shape changes, a 1x1 conv-norm shortcut."""

    def __init__(self, cin: int, planes: int, stride: int, norm: str):
        super().__init__()
        self.convnormrelu1 = _conv_norm(cin, planes, 3, stride, norm)
        self.convnormrelu2 = _conv_norm(planes, planes, 3, 1, norm)
        self.downsample = (_conv_norm(cin, planes, 1, stride, norm, relu=False)
                           if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convnormrelu2(self.convnormrelu1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Encoder(nn.Module):
    """Feature (instance norm) / context (batch norm) encoder to 1/8 resolution."""

    def __init__(self, cfg: RAFTConfig, norm: str, out_dim: int):
        super().__init__()
        d = cfg.feature_dims
        self.convnormrelu = _conv_norm(3, d[0], 7, 2, norm)
        for stage, planes in enumerate(d[1:], start=1):
            stride = 1 if stage == 1 else 2
            setattr(self, f"layer{stage}", nn.Sequential(
                ResidualBlock(d[stage - 1], planes, stride, norm),
                ResidualBlock(planes, planes, 1, norm)))
        self.stages = len(d) - 1
        self.conv = Conv2d(d[-1], out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convnormrelu(x)
        for stage in range(1, self.stages + 1):
            x = getattr(self, f"layer{stage}")(x)
        return self.conv(x)


def correlation_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """All-pairs correlation / sqrt(C), average-pooled over the second image's grid:
    (B, H, W, C) x2 -> [(B*H*W, H/2^l, W/2^l, 1)] for l in [0, levels)."""
    b, h, w, c = f1.shape
    corr = torch.bmm(f1.reshape(b, h * w, c).float(),
                     f2.reshape(b, h * w, c).float().transpose(1, 2)) / (c ** 0.5)
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr.permute(0, 2, 3, 1)]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr.permute(0, 2, 3, 1))
    return pyramid


def lookup_correlation(pyramid: List[torch.Tensor], coords: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """(2r+1)^2 correlation values around ``coords`` (B, H, W, 2) at every level ->
    (B, H, W, levels*(2r+1)^2), level-major, x-offset-major within a level."""
    b, h, w, _ = coords.shape
    n = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    ox, oy = torch.meshgrid(offs, offs, indexing="ij")
    delta = torch.stack([ox, oy], dim=-1).reshape(1, n, n, 2)
    centroid = coords.reshape(b * h * w, 1, 1, 2)
    out = [bilinear_sample(corr, centroid / (2.0 ** lvl) + delta).reshape(b, h, w, n * n)
           for lvl, corr in enumerate(pyramid)]
    return torch.cat(out, dim=-1)


def _conv_relu(cin: int, cout: int, k: int) -> nn.Sequential:
    """torchvision ``Conv2dNormActivation`` without a norm: ``.0`` conv with bias."""
    return nn.Sequential(Conv2d(cin, cout, k, padding=k // 2), nn.ReLU())


class MotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convcorr1 = _conv_relu(corr_channels, 256, 1)
        self.convcorr2 = _conv_relu(256, 192, 3)
        self.convflow1 = _conv_relu(2, 128, 7)
        self.convflow2 = _conv_relu(128, 64, 3)
        self.conv = _conv_relu(192 + 64, 128 - 2, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = self.convcorr2(self.convcorr1(corr))
        f = self.convflow2(self.convflow1(flow))
        return torch.cat([self.conv(torch.cat([c, f], dim=-1)), flow], dim=-1)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int, kernel: Tuple[int, int]):
        super().__init__()
        pad = (kernel[0] // 2, kernel[1] // 2)
        for gate in ("convz", "convr", "convq"):
            setattr(self, gate, Conv2d(hidden + cin, hidden, kernel, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1)))
        return (1 - z) * h + z * q


class RecurrentBlock(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convgru1 = ConvGRU(hidden, cin, (1, 5))
        self.convgru2 = ConvGRU(hidden, cin, (5, 1))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.convgru2(self.convgru1(h, x), x)


class FlowHead(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = Conv2d(cin, 256, 3, padding=1)
        self.conv2 = Conv2d(256, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.motion_encoder = MotionEncoder(cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2)
        self.recurrent_block = RecurrentBlock(cfg.hidden_dim, cfg.context_dim + 128)
        self.flow_head = FlowHead(cfg.hidden_dim)

    def forward(self, net, inp, corr, flow):
        x = torch.cat([inp, self.motion_encoder(flow, corr)], dim=-1)
        net = self.recurrent_block(net, x)
        return net, self.flow_head(net)


class MaskPredictor(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.convrelu = _conv_relu(cfg.hidden_dim, 256, 3)
        self.conv = Conv2d(256, cfg.downsample ** 2 * 9, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.convrelu(x)) * 0.25  # torchvision's multiplier


class RAFT(nn.Module):
    """``forward(image1, image2)``: (B, H, W, 3) in [-1, 1], H and W multiples of 8 -> the
    final convex-upsampled flow (B, H, W, 2) from image1 to image2."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_encoder = Encoder(cfg, "instance", cfg.out_dim)
        self.context_encoder = Encoder(cfg, "batch", cfg.hidden_dim + cfg.context_dim)
        self.update_block = UpdateBlock(cfg)
        self.mask_predictor = MaskPredictor(cfg)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = image1.shape[0]
        f1, f2 = self.feature_encoder(torch.cat([image1, image2], dim=0)).chunk(2, dim=0)
        pyramid = correlation_pyramid(f1, f2, cfg.corr_levels)
        ctx = self.context_encoder(image1)
        net = torch.tanh(ctx[..., :cfg.hidden_dim])
        inp = F.relu(ctx[..., cfg.hidden_dim:])

        _, h8, w8, _ = f1.shape
        coords0 = coords_grid(h8, w8, image1.device)[None].expand(b, h8, w8, 2)
        coords1 = coords0
        for _ in range(cfg.iters):  # tied weights
            corr = lookup_correlation(pyramid, coords1, cfg.corr_radius)
            net, dflow = self.update_block(net, inp, corr, (coords1 - coords0).to(net.dtype))
            coords1 = coords1 + dflow.float()
        return upsample_flow_with_mask(coords1 - coords0, self.mask_predictor(net),
                                       cfg.downsample)


def raft_bidirectional_flow(model: RAFT, frames_a: torch.Tensor, frames_b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (a -> b) and backward (b -> a) flow in one batched call: frames (B, H, W, 3)
    in [0, 1], H and W multiples of 8, scaled to [-1, 1] here (torchvision's transform)."""
    a, b = frames_a * 2.0 - 1.0, frames_b * 2.0 - 1.0
    flows = model(torch.cat([a, b], dim=0), torch.cat([b, a], dim=0))
    return flows.chunk(2, dim=0)


def build_raft(config: RAFTConfig = RAFTConfig(), device="cuda",
               generator: Optional[torch.Generator] = None) -> RAFT:
    """A frozen fp32 RAFT in eval mode on ``device`` (the card unless the CPU is named),
    random from ``generator`` when one is given, else uninitialised for
    ``load_state_dict``."""
    device = require_device(device)
    model = materialize(lambda: RAFT(config), device, torch.float32)
    if generator is not None:
        init_params(model, generator)
    return model.eval().requires_grad_(False)
