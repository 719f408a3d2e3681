"""PiDiNet edges (counterpart of ``lkgd_tpu/models/pidinet.py``): ``table5_pidinet`` (Su et
al., Pixel Difference Networks), the ``softedge_pidinet`` / ``softedge_pidsafe`` /
``scribble_pidinet`` annotators.

The checkpoint holds raw pixel-difference kernels (the ``carv4`` pattern of central, angular,
radial and vanilla differences); ``convert_pdc`` folds each into the plain convolution it
equals, on the host, once, when ``port_pidinet`` reads the file (pidinet's own
``convert_pidinet``): the module holds plain convolutions under the checkpoint's names (a
radial difference's as its 5x5 equivalent), and the forward is convolutions, max pools and
sigmoids. A stride-2 3x3 stem, four stages of PDC blocks (depthwise 3x3 or 5x5, ReLU, 1x1,
residual; the first block of stages 2-4 max-pools and adds a 1x1 shortcut), then per stage a
compact dilation module (dilations 5, 7, 9, 11), compact spatial attention and a 1x1
reduction, each side output resized bilinearly (JAX's ``"bilinear"``,
``ops/resize.resize_bilinear``) to the input, and a 1x1 classifier over the four.
Activations are channels-last at the module's boundary, the convolutions run on the
``(N, C, H, W)`` view.

The processor reuses ``models/hed.py``'s ``safe_step`` and ``scribble_postprocess``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.hed import safe_step, scribble_postprocess
from lkgd_torch.models.layers import build_frozen
from lkgd_torch.ops.resize import resize_bilinear

# the op of each of the 16 PDC convolutions (the stem, then the 15 blocks in order)
CARV4 = ("cd", "ad", "rd", "cv") * 4
# (name, output channels as a multiple of inplane, stride) of the 15 blocks
_BLOCKS = tuple((f"block1_{j}", 1, 1) for j in (1, 2, 3)) + tuple(
    (f"block{i}_{j}", 2 if i == 2 else 4, 2 if j == 1 else 1)
    for i in (2, 3, 4) for j in (1, 2, 3, 4))


class PDCBlock(nn.Module):
    """[2x2 max pool +] depthwise conv (5x5 for a radial difference, else 3x3) -> ReLU ->
    1x1, added to the input (through a 1x1 shortcut where the block downsamples)."""

    def __init__(self, cin: int, cout: int, op: str, stride: int = 1):
        super().__init__()
        k = 5 if op == "rd" else 3
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cin, k, padding=k // 2, groups=cin, bias=False)
        self.conv2 = nn.Conv2d(cin, cout, 1, bias=False)
        if stride > 1:
            self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = F.max_pool2d(x, 2, 2)
        y = self.conv2(F.relu(self.conv1(x)))
        if self.stride > 1:
            x = self.shortcut(x)
        return x + y


class CDCM(nn.Module):
    """ReLU -> 1x1 -> the sum of four bias-free dilated 3x3 convolutions (d = 5, 7, 9, 11)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1)
        for i, d in enumerate((5, 7, 9, 11)):
            self.add_module(f"conv2_{i + 1}", nn.Conv2d(cout, cout, 3, padding=d, dilation=d,
                                                        bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(x))
        return self.conv2_1(h) + self.conv2_2(h) + self.conv2_3(h) + self.conv2_4(h)


class CSAM(nn.Module):
    """ReLU -> 1x1 (to 4) -> bias-free 3x3 (to 1) -> sigmoid, multiplied onto the input."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, 4, 1)
        self.conv2 = nn.Conv2d(4, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv2(self.conv1(F.relu(x))))


class PiDiNet(nn.Module):
    """``table5_pidinet`` (inplane 60, dil 24, attention on): (B, H, W, 3) in [0, 1], H and W
    multiples of 8 -> the fused edge map (B, H, W) in [0, 1]."""

    def __init__(self, inplane: int = 60, dil: int = 24):
        super().__init__()
        self.init_block = nn.Conv2d(3, inplane, 3, stride=2, padding=1, bias=False)
        cin = inplane
        for i, (name, mult, stride) in enumerate(_BLOCKS):
            self.add_module(name, PDCBlock(cin, inplane * mult, CARV4[i + 1], stride))
            cin = inplane * mult
        widths = (inplane, 2 * inplane, 4 * inplane, 4 * inplane)
        self.dilations = nn.ModuleList([CDCM(c, dil) for c in widths])
        self.attentions = nn.ModuleList([CSAM(dil) for _ in widths])
        self.conv_reduces = nn.ModuleList([nn.Conv2d(dil, 1, 1) for _ in widths])
        self.classifier = nn.Conv2d(4, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = x.shape[1:3]
        h = self.init_block(x.permute(0, 3, 1, 2))
        planes = []
        for name, _, _ in _BLOCKS:
            if name in ("block2_1", "block3_1", "block4_1"):
                planes.append(h)
            h = getattr(self, name)(h)
        planes.append(h)
        sides = []
        for i, p in enumerate(planes):
            e = self.conv_reduces[i](self.attentions[i](self.dilations[i](p)))
            sides.append(resize_bilinear(e.permute(0, 2, 3, 1), (hh, ww)))
        fuse = self.classifier(torch.cat(sides, dim=-1).permute(0, 3, 1, 2))
        return torch.sigmoid(fuse)[:, 0]


def convert_pdc(op: str, weight: np.ndarray) -> np.ndarray:
    """pidinet's ``convert_pidinet``: a pixel-difference kernel (OIHW) -> the plain one it
    equals (OIHW). cd: the centre tap less the kernel's sum; ad: the kernel less its
    clockwise-rotated copy; rd: the 3x3 taps (centre dropped) on the 5x5 ring of radius 2,
    negated at radius 1; cv: as it is."""
    w = np.asarray(weight, np.float32)
    o, i = w.shape[:2]
    if op == "cv":
        return w
    if op == "cd":
        out = w.copy().reshape(o, i, 9)
        out[:, :, 4] = out[:, :, 4] - w.reshape(o, i, 9).sum(axis=2)
        return out.reshape(o, i, 3, 3)
    if op == "ad":
        flat = w.reshape(o, i, 9)
        return (flat - flat[:, :, [3, 0, 1, 6, 4, 2, 7, 8, 5]]).reshape(o, i, 3, 3)
    if op == "rd":
        flat = w.reshape(o, i, 9)
        buf = np.zeros((o, i, 25), np.float32)
        taps = [0, 1, 2, 3, 5, 6, 7, 8]
        buf[:, :, [0, 2, 4, 10, 14, 20, 22, 24]] = flat[:, :, taps]
        buf[:, :, [6, 7, 8, 11, 13, 16, 17, 18]] = -flat[:, :, taps]
        return buf.reshape(o, i, 5, 5)
    raise ValueError(f"unknown pdc op {op}")


def pdc_op_for(name: str) -> Optional[str]:
    """The pixel-difference op of a checkpoint weight (``module.`` dropped): the stem's and
    each block's ``conv1``; None for a plain weight."""
    if name == "init_block.weight":
        return CARV4[0]
    m = re.match(r"block(\d)_(\d)\.conv1\.weight$", name)
    if m:
        return CARV4[{1: 0, 2: 3, 3: 7, 4: 11}[int(m.group(1))] + int(m.group(2))]
    return None


def port_pidinet(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``table5_pidinet.pth``'s raw state dict -> ``PiDiNet``'s: a ``module.`` prefix dropped,
    every pixel-difference kernel turned into its plain convolution by ``convert_pdc``."""
    out = {}
    for key, value in state_dict.items():
        name = key.replace("module.", "")
        op = pdc_op_for(name)
        if op is not None:
            value = torch.from_numpy(convert_pdc(op, np.asarray(value, np.float32)))
        out[name] = value
    return out


def build_pidinet(device="cuda", generator: Optional[torch.Generator] = None) -> PiDiNet:
    """A frozen fp32 ``PiDiNet`` on ``device`` (the card unless the CPU is named), random from
    ``generator`` when one is given, else uninitialised for ``load_state_dict``."""
    return build_frozen(PiDiNet, device, generator)


def make_pidinet_processor(model: PiDiNet, safe: bool = True,
                           scribble: bool = False) -> Callable[[np.ndarray], np.ndarray]:
    """The ``softedge_pidinet`` annotator, (H, W, 3) [0, 1] -> (H, W, 3) [0, 1]: the image
    edge-padded to a multiple of 8, the fused edge cropped back; ``safe``: ``safe_step``
    (``softedge_pidsafe``); ``scribble``: ``scribble_postprocess``."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def process(image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        x = np.pad(image, ((0, -h % 8), (0, -w % 8), (0, 0)), mode="edge")
        x = torch.from_numpy(np.asarray(x, np.float32)[None]).to(device)
        edge = model(x)[0, :h, :w].cpu().numpy()
        if safe:
            edge = safe_step(edge)
        if scribble:
            edge = scribble_postprocess(edge)
        return np.repeat(edge[..., None], 3, axis=-1).astype(np.float32)

    return process
