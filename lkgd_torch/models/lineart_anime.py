"""Anime line art (counterpart of ``lkgd_tpu/models/lineart_anime.py``): the Anime2Sketch
pix2pix ``UnetGenerator(3, 1, num_downs=8, ngf=64)`` with affine-free instance norms, the
``lineart_anime`` annotator (``netG.pth``).

Each U-Net level (``_SkipBlock``): [LeakyReLU 0.2 ->] a 4x4 stride-2 convolution [-> instance
norm] -> the inner level -> ReLU -> a 4x4 stride-2 transposed convolution -> instance norm,
concatenated after the level's input; the outermost level ends in tanh instead and has no
skip. The module is pix2pix's ``nn.Sequential`` nesting (``model.model.1.model.3...``), so its
names are the file's (``lineart_anime_key`` gives them by level) and it loads with
``load_state_dict(strict=True)``; a level's skip carries its input as it came, as the JAX
module's does (pix2pix's in-place LeakyReLU changes it only where the ReLU after the
concatenation zeroes it anyway). Activations are channels-last at the module's boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from lkgd_torch.models.layers import build_frozen


@dataclasses.dataclass(frozen=True)
class LineartAnimeConfig:
    in_channels: int = 3
    out_channels: int = 1
    num_downs: int = 8
    ngf: int = 64


class _SkipBlock(nn.Module):
    """pix2pix ``UnetSkipConnectionBlock`` (InstanceNorm2d without affine, no dropout)."""

    def __init__(self, outer_nc: int, inner_nc: int, submodule: Optional["_SkipBlock"] = None,
                 outermost: bool = False, innermost: bool = False,
                 input_nc: Optional[int] = None):
        super().__init__()
        self.outermost = outermost
        down = nn.Conv2d(input_nc or outer_nc, inner_nc, 4, stride=2, padding=1)
        up = nn.ConvTranspose2d(inner_nc if innermost else 2 * inner_nc, outer_nc, 4, stride=2,
                                padding=1)
        if outermost:
            layers = [down, submodule, nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up, nn.InstanceNorm2d(outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, nn.InstanceNorm2d(inner_nc), submodule, nn.ReLU(),
                      up, nn.InstanceNorm2d(outer_nc)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], dim=1)


class LineartAnimeGenerator(nn.Module):
    """(B, H, W, 3) in [-1, 1], H and W multiples of 2**num_downs -> (B, H, W, 1) sketch in
    [-1, 1] (white background, dark lines)."""

    def __init__(self, config: LineartAnimeConfig = LineartAnimeConfig()):
        super().__init__()
        self.config = config
        ngf = config.ngf
        block = _SkipBlock(8 * ngf, 8 * ngf, innermost=True)
        for _ in range(config.num_downs - 5):
            block = _SkipBlock(8 * ngf, 8 * ngf, block)
        block = _SkipBlock(4 * ngf, 8 * ngf, block)
        block = _SkipBlock(2 * ngf, 4 * ngf, block)
        block = _SkipBlock(ngf, 2 * ngf, block)
        self.model = _SkipBlock(config.out_channels, ngf, block, outermost=True,
                                input_nc=config.in_channels)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                m.weight.normal_(0.0, m.weight[:, 0].numel() ** -0.5, generator=generator)
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def lineart_anime_key(level: int, num_downs: int, updown: str) -> str:
    """The name prefix of the down or up convolution of U-Net ``level`` (0 = outermost) in
    pix2pix's nesting: the inner level sits at ``model.1`` of the outermost Sequential and at
    ``model.3`` of a middle one; the down convolution at index 0 (outermost) or 1, the up one
    at 3 (outermost, innermost) or 5."""
    parts = ["model"] + ["model.1" if lv == 0 else "model.3" for lv in range(level)]
    if level == 0:
        idx = 0 if updown == "down" else 3
    elif level == num_downs - 1:
        idx = 1 if updown == "down" else 3
    else:
        idx = 1 if updown == "down" else 5
    return ".".join(parts + [f"model.{idx}"])


def build_lineart_anime(config: LineartAnimeConfig = LineartAnimeConfig(), device="cuda",
                        generator: Optional[torch.Generator] = None) -> LineartAnimeGenerator:
    """A frozen fp32 ``LineartAnimeGenerator`` on ``device`` (the card unless the CPU is
    named), random from ``generator`` when one is given, else uninitialised for
    ``load_state_dict``."""
    return build_frozen(lambda: LineartAnimeGenerator(config), device, generator)


def make_lineart_anime_processor(model: LineartAnimeGenerator, invert: bool = False
                                 ) -> Callable[[np.ndarray], np.ndarray]:
    """The ``lineart_anime`` annotator, (H, W, 3) [0, 1] -> (H, W, 3) [0, 1]: the image in
    [-1, 1] edge-padded to a multiple of 2**num_downs, the sketch cropped back, mapped to
    [0, 1] and clipped; ``invert`` turns it to white lines on black."""
    device = next(model.parameters()).device
    mult = 2 ** model.config.num_downs

    @torch.no_grad()
    def process(image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        x = np.pad(image * 2.0 - 1.0, ((0, -h % mult), (0, -w % mult), (0, 0)), mode="edge")
        x = torch.from_numpy(np.asarray(x, np.float32)[None]).to(device)
        out = np.clip(model(x)[0, :h, :w, 0].cpu().numpy() / 2.0 + 0.5, 0.0, 1.0)
        if invert:
            out = 1.0 - out
        return np.repeat(out[..., None], 3, axis=-1).astype(np.float32)

    return process
