"""RIFE v3-HD frame interpolator (counterpart of ``lkgd_tpu/models/rife.py``).

IFNet: three coarse-to-fine ``IFBlock``s at scales (4, 2, 1), each run twice, on
(img0, img1, +mask) with the flow and on (img1, img0, -mask) with its two halves swapped,
the two estimates averaged; backward warping is ``bilinear_sample`` (``grid_sample``,
align_corners=True, zero padding) on ``coords_grid + flow``; the resizes inside a block are
bilinear with half-pixel centres and no antialias (``F.interpolate(align_corners=False)``).
``interpolate_video`` doubles the frame rate ``exp`` times, all midpoints of a level in one
batched forward, and copies the first frame of each near-duplicate pair on the host
(``dedup_threshold``).

Activations are channels-last ``(B, H, W, C)``. Module names are IFNet_HDv3's
(``block<i>.conv0.<a>.{0: conv, 1: PReLU}``, ``block<i>.convblock<a>.<c>.{0,1}``,
``block<i>.conv{1,2}.{0: ConvTranspose2d, 1: PReLU, 2: ConvTranspose2d}``): a
``flownet.pkl`` loads strictly once its ``module.`` prefix and the training-only
``block_tea`` are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import Conv2d, init_params, materialize
from lkgd_torch.models.unimatch import bilinear_sample, coords_grid
from lkgd_torch.utils.device import require_device


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear, half-pixel centres, no antialias, on (B, H, W, C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def rife_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp of (B, H, W, C) by (B, H, W, 2)."""
    h, w = img.shape[1:3]
    return bilinear_sample(img, coords_grid(h, w, img.device)[None] + flow)


class PReLU(nn.PReLU):
    """Per-channel PReLU over the last axis; ``init_params`` sets torch's 0.25."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.weight.fill_(0.25)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(k=4, s=2, p=1)`` (2x upsampling) on (B, H, W, C)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        # the JAX module's lecun_normal over its (4, 4, in) fan-in
        fan_in = 16 * self.weight.shape[0]
        self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        self.bias.zero_()


def _conv(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 3, stride=stride, padding=1), PReLU(cout))


class IFBlock(nn.Module):
    """A 4x strided encoder, 4 residual double-conv stages, transposed-conv flow (4
    channels) and mask (1) heads."""

    def __init__(self, cin: int, c: int = 90):
        super().__init__()
        self.conv0 = nn.Sequential(_conv(cin, c // 2, 2), _conv(c // 2, c, 2))
        for i in range(4):
            setattr(self, f"convblock{i}", nn.Sequential(_conv(c, c), _conv(c, c)))
        self.conv1 = nn.Sequential(ConvTranspose2d(c, c // 2), PReLU(c // 2),
                                   ConvTranspose2d(c // 2, 4))
        self.conv2 = nn.Sequential(ConvTranspose2d(c, c // 2), PReLU(c // 2),
                                   ConvTranspose2d(c // 2, 1))

    def forward(self, x: torch.Tensor, flow: torch.Tensor, scale: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, w = x.shape[1:3]
        if scale != 1:
            x = _resize(x, h // scale, w // scale)
            flow = _resize(flow, h // scale, w // scale) / scale
        feat = self.conv0(torch.cat([x, flow.to(x.dtype)], dim=-1))
        for i in range(4):
            feat = feat + getattr(self, f"convblock{i}")(feat)
        dflow, dmask = self.conv1(feat), self.conv2(feat)
        if scale != 1:
            dflow = _resize(dflow, h, w) * scale
            dmask = _resize(dmask, h, w)
        return dflow.float(), dmask.float()


@dataclasses.dataclass(frozen=True)
class RIFEConfig:
    c: int = 90
    scale_list: Tuple[int, ...] = (4, 2, 1)


class IFNet(nn.Module):
    """``forward(img0, img1)``: (B, H, W, 3) in [0, 1], H and W multiples of 32 -> the
    midpoint frame (B, H, W, 3)."""

    def __init__(self, config: RIFEConfig = RIFEConfig()):
        super().__init__()
        self.config = config
        for i in range(len(config.scale_list)):
            setattr(self, f"block{i}", IFBlock(7 + 4, config.c))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = img0.shape
        flow = torch.zeros((b, h, w, 4), device=img0.device)
        mask = torch.zeros((b, h, w, 1), device=img0.device)
        warped0, warped1 = img0, img1
        for i, scale in enumerate(self.config.scale_list):
            block = getattr(self, f"block{i}")
            m = mask.to(img0.dtype)
            f0, m0 = block(torch.cat([warped0, warped1, m], dim=-1), flow, scale)
            f1, m1 = block(torch.cat([warped1, warped0, -m], dim=-1),
                           torch.cat([flow[..., 2:4], flow[..., :2]], dim=-1), scale)
            flow = flow + (f0 + torch.cat([f1[..., 2:4], f1[..., :2]], dim=-1)) / 2
            mask = mask + (m0 - m1) / 2
            warped0 = rife_warp(img0, flow[..., :2])
            warped1 = rife_warp(img1, flow[..., 2:4])
        m = torch.sigmoid(mask)
        return (warped0 * m + warped1 * (1 - m)).to(img0.dtype)


def pad_to_multiple(frames: torch.Tensor, multiple: int = 32
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad (..., H, W, C) at the bottom and right to a multiple; returns the original
    (H, W) too."""
    h, w = frames.shape[-3:-1]
    ph, pw = -(-h // multiple) * multiple, -(-w // multiple) * multiple
    if (ph, pw) != (h, w):
        frames = F.pad(frames, (0, 0, 0, pw - w, 0, ph - h))
    return frames, (h, w)


@torch.no_grad()
def double_frames(model: IFNet, frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) -> (2T-1, H, W, 3): every pair's midpoint inserted, in one forward."""
    mids = model(frames[:-1], frames[1:])
    t = frames.shape[0]
    out = frames.new_empty((2 * t - 1, *frames.shape[1:]))
    out[0::2] = frames
    out[1::2] = mids
    return out


def interpolate_video(model: IFNet, frames: torch.Tensor, exp: int = 1,
                      dedup_threshold: float = 0.0) -> torch.Tensor:
    """2**exp x frame-rate interpolation of (T, H, W, 3) [0, 1] frames on the model's
    device. Pairs whose mean absolute difference is under ``dedup_threshold`` (> 0) get
    copies of their first frame as their in-betweens instead of synthesised ones."""
    original = frames
    frames, (h, w) = pad_to_multiple(frames)
    for _ in range(exp):
        frames = double_frames(model, frames)
    frames = frames[:, :h, :w]
    if dedup_threshold > 0:
        arr = frames.cpu().numpy().copy()
        src = original.cpu().numpy()
        step = 2 ** exp
        diffs = np.abs(src[1:] - src[:-1]).mean(axis=(1, 2, 3))
        for i in np.nonzero(diffs < dedup_threshold)[0]:
            arr[i * step + 1:(i + 1) * step] = arr[i * step]
        return torch.from_numpy(arr).to(frames.device)
    return frames


def build_rife(config: RIFEConfig = RIFEConfig(), device="cuda",
               generator: Optional[torch.Generator] = None) -> IFNet:
    """A frozen fp32 IFNet in eval mode on ``device`` (the card unless the CPU is named),
    random from ``generator`` when one is given, else uninitialised for
    ``load_state_dict``."""
    device = require_device(device)
    model = materialize(lambda: IFNet(config), device, torch.float32)
    if generator is not None:
        init_params(model, generator)
    return model.eval().requires_grad_(False)
