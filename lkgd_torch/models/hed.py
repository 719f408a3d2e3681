"""HED soft edges (counterpart of ``lkgd_tpu/models/hed.py``): lllyasviel's
``ControlNetHED_Apache2``, the ``softedge_hed`` / ``scribble_hed`` annotators and their
``*_hedsafe`` variants.

A VGG16-style tower of five stages (64/128/256/512/512 channels, 2/2/3/3/3 3x3 convolutions
with ReLU, a 2x2 max pool before stages 2-5) with a 1x1 one-channel projection a stage; the
edge map is ``sigmoid(mean(stage logits resized to the input))``, each resize JAX's bilinear
(``ops/resize.resize_bilinear``). Activations are channels-last at the module's boundary;
inside, the convolutions run on the ``(N, C, H, W)`` view of that memory. Module names are
``ControlNetHED.pth``'s (``norm`` (1, 3, 1, 1), ``blockN.convs.i``, ``blockN.projection``), so
the checkpoint loads with ``load_state_dict(strict=True)`` after ``port_hed`` drops its
``netNetwork.`` prefix, where it has one.

``safe_step`` and ``scribble_postprocess`` (host cv2 and numpy) are shared with
``models/pidinet.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import build_frozen
from lkgd_torch.ops.resize import resize_bilinear


class DoubleConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin if i == 0 else cout, cout, 3, padding=1)
                                    for i in range(layers)])
        self.projection = nn.Conv2d(cout, 1, 1)

    def forward(self, h: torch.Tensor, down_sampling: bool = False):
        if down_sampling:
            h = F.max_pool2d(h, 2, 2)
        for conv in self.convs:
            h = F.relu(conv(h))
        return h, self.projection(h)


class ControlNetHED(nn.Module):
    """(B, H, W, 3) RGB in 0..255 -> the five stages' one-channel logits (B, h, w, 1) at
    1, 1/2, 1/4, 1/8 and 1/16 of the input (floor)."""

    STAGES = ((3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3))

    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        for i, (cin, cout, n) in enumerate(self.STAGES):
            self.add_module(f"block{i + 1}", DoubleConvBlock(cin, cout, n))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.norm.zero_()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = x.permute(0, 3, 1, 2) - self.norm
        projections = []
        for i in range(len(self.STAGES)):
            h, p = getattr(self, f"block{i + 1}")(h, down_sampling=i > 0)
            projections.append(p.permute(0, 2, 3, 1))
        return tuple(projections)


def hed_edge(model: ControlNetHED, image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 1] -> (B, H, W) soft edge in [0, 1]: the mean of the stage
    logits resized bilinearly to (H, W), then a sigmoid."""
    h, w = image.shape[1:3]
    ups = [resize_bilinear(p, (h, w))[..., 0] for p in model(image * 255.0)]
    return torch.sigmoid(torch.stack(ups, dim=-1).mean(dim=-1))


def safe_step(x: np.ndarray, step: int = 2) -> np.ndarray:
    """controlnet_aux ``util.safe_step``: ``floor(x * (step + 1)) / step`` in float32, the
    quantisation of the ``*safe`` variants."""
    y = np.asarray(x, np.float32) * np.float32(step + 1)
    return np.floor(y).astype(np.float32) / np.float32(step)


def scribble_postprocess(edge01: np.ndarray) -> np.ndarray:
    """controlnet_aux's scribble lines from a soft edge map (H, W) in [0, 1]: ``util.nms``
    (a sigma-3 Gaussian blur, non-maximum suppression along four directions by dilation,
    > 127 binarised), then a sigma-3 blur of the uint8 mask and the > 4 threshold; (H, W)
    float32 in {0, 1}. Host cv2 and numpy."""
    import cv2

    x = np.clip(edge01 * 255.0, 0, 255).astype(np.uint8)
    xb = cv2.GaussianBlur(x.astype(np.float32), (0, 0), 3.0)
    y = np.zeros_like(xb)
    for f in (np.array([[0, 0, 0], [1, 1, 1], [0, 0, 0]], np.uint8),
              np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], np.uint8),
              np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.uint8),
              np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.uint8)):
        np.putmask(y, cv2.dilate(xb, kernel=f) == xb, xb)
    z = np.zeros_like(y, dtype=np.uint8)
    z[y > 127] = 255
    m = cv2.GaussianBlur(z, (0, 0), 3.0)
    out = np.zeros(m.shape, np.float32)
    out[m > 4] = 1.0
    return out


def port_hed(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``ControlNetHED.pth``'s state dict -> ``ControlNetHED``'s: a ``netNetwork.`` prefix
    dropped, ``norm`` as (1, 3, 1, 1)."""
    out = {}
    for key, value in state_dict.items():
        name = key.replace("netNetwork.", "")
        out[name] = value.reshape(1, 3, 1, 1) if name == "norm" else value
    return out


def build_hed(device="cuda", generator: Optional[torch.Generator] = None) -> ControlNetHED:
    """A frozen fp32 ``ControlNetHED`` on ``device`` (the card unless the CPU is named),
    random from ``generator`` when one is given, else uninitialised for
    ``load_state_dict``."""
    return build_frozen(ControlNetHED, device, generator)


def make_hed_processor(model: ControlNetHED, scribble: bool = False,
                       safe: bool = False) -> Callable[[np.ndarray], np.ndarray]:
    """The ``softedge_hed`` annotator, (H, W, 3) [0, 1] -> (H, W, 3) [0, 1]; ``safe``: the
    ``*_hedsafe`` quantisation (``safe_step``); ``scribble``: ``scribble_postprocess``'s
    binary lines."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def process(image: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(image, np.float32)[None]).to(device)
        edge = hed_edge(model, x)[0].cpu().numpy()
        if safe:
            edge = safe_step(edge)
        if scribble:
            edge = scribble_postprocess(edge)
        return np.repeat(edge[..., None], 3, axis=-1).astype(np.float32)

    return process
