"""Line art (counterpart of ``lkgd_tpu/models/lineart.py``): the Informative-Drawings
``Generator(3, 1, 3)``, the ``lineart`` (``sk_model.pth``) and ``lineart_coarse``
(``sk_model2.pth``) annotators.

A reflect-padded 7x7 stem, two stride-2 3x3 downs (64 -> 128 -> 256), three reflect-padded
residual blocks at 256, two stride-2 transposed 3x3 ups (output padding 1) and a
reflect-padded 7x7 sigmoid head; every convolution but the head followed by an affine-free
instance norm (eps 1e-5, the biased variance) and, outside the residual sums, a ReLU. The
module is the checkpoint's ``nn.Sequential`` nesting (``model0`` ... ``model4``,
``model2.<i>.conv_block``), so its names are the file's and it loads with
``load_state_dict(strict=True)``. Activations are channels-last at the module's boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from lkgd_torch.models.layers import build_frozen


@dataclasses.dataclass(frozen=True)
class LineartConfig:
    in_channels: int = 3
    out_channels: int = 1
    ngf: int = 64
    n_residual_blocks: int = 3
    sigmoid: bool = True


def _norm_relu(c: int):
    return [nn.InstanceNorm2d(c, eps=1e-5), nn.ReLU()]


class ResidualBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3), *_norm_relu(c),
            nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3), nn.InstanceNorm2d(c, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class LineartGenerator(nn.Module):
    """(B, H, W, 3) in [0, 1], H and W multiples of 4 -> (B, H, W, 1) line art in [0, 1]
    (dark lines on white)."""

    def __init__(self, config: LineartConfig = LineartConfig()):
        super().__init__()
        self.config = config
        ngf = config.ngf
        self.model0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(config.in_channels, ngf, 7),
                                    *_norm_relu(ngf))
        self.model1 = nn.Sequential(
            nn.Conv2d(ngf, 2 * ngf, 3, stride=2, padding=1), *_norm_relu(2 * ngf),
            nn.Conv2d(2 * ngf, 4 * ngf, 3, stride=2, padding=1), *_norm_relu(4 * ngf))
        self.model2 = nn.Sequential(*[ResidualBlock(4 * ngf)
                                      for _ in range(config.n_residual_blocks)])
        self.model3 = nn.Sequential(
            nn.ConvTranspose2d(4 * ngf, 2 * ngf, 3, stride=2, padding=1, output_padding=1),
            *_norm_relu(2 * ngf),
            nn.ConvTranspose2d(2 * ngf, ngf, 3, stride=2, padding=1, output_padding=1),
            *_norm_relu(ngf))
        head = [nn.ReflectionPad2d(3), nn.Conv2d(ngf, config.out_channels, 7)]
        self.model4 = nn.Sequential(*head, *([nn.Sigmoid()] if config.sigmoid else []))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                m.weight.normal_(0.0, m.weight[:, 0].numel() ** -0.5, generator=generator)
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for part in (self.model0, self.model1, self.model2, self.model3, self.model4):
            h = part(h)
        return h.permute(0, 2, 3, 1)


def build_lineart(config: LineartConfig = LineartConfig(), device="cuda",
                  generator: Optional[torch.Generator] = None) -> LineartGenerator:
    """A frozen fp32 ``LineartGenerator`` on ``device`` (the card unless the CPU is named),
    random from ``generator`` when one is given, else uninitialised for
    ``load_state_dict``."""
    return build_frozen(lambda: LineartGenerator(config), device, generator)


def make_lineart_processor(model: LineartGenerator,
                           invert: bool = True) -> Callable[[np.ndarray], np.ndarray]:
    """The ``lineart`` annotator, (H, W, 3) [0, 1] -> (H, W, 3) [0, 1]: the image
    edge-padded to a multiple of 4, the line art cropped back and, with ``invert``, turned
    to ControlNet's white lines on black."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def process(image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        padded = np.pad(image, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge")
        x = torch.from_numpy(np.asarray(padded, np.float32)[None]).to(device)
        line = model(x)[0, :h, :w, 0].cpu().numpy()
        if invert:
            line = 1.0 - line
        return np.repeat(line[..., None], 3, axis=-1).astype(np.float32)

    return process
