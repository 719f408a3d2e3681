"""The FVD feature network, I3D (Inflated 3D Inception, Kinetics-400), at evaluation
(counterpart of ``lkgd_tpu/eval/i3d.py``).

The standard InceptionI3d of pytorch-i3d: ``Unit3D`` = bias-free Conv3d, BatchNorm (eps
1e-3) and ReLU with TensorFlow's SAME padding, nine Inception modules and the 400-way
logits unit (a 1 x 1 x 1 convolution with a bias). The features are the pre-softmax logits
averaged over time, the convention of the original FVD. Modules carry pytorch-i3d's
``state_dict`` names, so its Kinetics-400 checkpoint loads strictly
(``load_torch_state_dict``). Videos are (B, T, H, W, 3) in [0, 1] with T >= 9 (FVD uses
16-frame clips at 224 x 224). SAME padding is asymmetric (the odd pixel goes after), so it
is an explicit ``F.pad`` (-inf before a max pool) and not the convolution's ``padding=``.
The convolutions run on cuDNN.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lkgd_torch.eval._layers import EvalBatchNorm, init_synthetic, load_feature_state_dict

# Inception modules: input channels, (b0, b1a, b1b, b2a, b2b, b3b) output channels
MODULES = {
    "Mixed_3b": (192, (64, 96, 128, 16, 32, 32)),
    "Mixed_3c": (256, (128, 128, 192, 32, 96, 64)),
    "Mixed_4b": (480, (192, 96, 208, 16, 48, 64)),
    "Mixed_4c": (512, (160, 112, 224, 24, 64, 64)),
    "Mixed_4d": (512, (128, 128, 256, 24, 64, 64)),
    "Mixed_4e": (512, (112, 144, 288, 32, 64, 64)),
    "Mixed_4f": (528, (256, 160, 320, 32, 128, 128)),
    "Mixed_5b": (832, (256, 160, 320, 32, 128, 128)),
    "Mixed_5c": (832, (384, 192, 384, 48, 128, 128)),
}
NUM_CLASSES = 400


def same_pad(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    """TensorFlow's SAME padding of (B, C, T, H, W): out = ceil(n / s); of the total
    padding the smaller half goes before."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel), reversed(stride)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def _max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    return F.max_pool3d(same_pad(x, kernel, stride, float("-inf")), kernel, stride)


class Unit3D(nn.Module):
    """Conv3d with SAME padding; with ``bn`` bias-free and followed by BatchNorm and ReLU
    (the ``logits`` unit has a bias and neither)."""

    def __init__(self, c_in: int, c_out: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 bn: bool = True):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(c_in, c_out, kernel, stride=stride, bias=not bn)
        self.bn = EvalBatchNorm(c_out) if bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3d(same_pad(x, self.kernel, self.stride))
        return F.relu(self.bn(y)) if self.bn is not None else y


class InceptionModule(nn.Module):
    def __init__(self, c_in: int, out: Sequence[int]):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = out
        self.b0 = Unit3D(c_in, b0)
        self.b1a = Unit3D(c_in, b1a)
        self.b1b = Unit3D(b1a, b1b, (3, 3, 3))
        self.b2a = Unit3D(c_in, b2a)
        self.b2b = Unit3D(b2a, b2b, (3, 3, 3))
        self.b3b = Unit3D(c_in, b3b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(_max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], 1)


def preprocess(videos: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) in [0, 1] -> [-1, 1] (resize to 224 beforehand if needed)."""
    return videos.float() * 2.0 - 1.0


class InceptionI3d(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, (c_in, out) in MODULES.items():
            setattr(self, name, InceptionModule(c_in, out))
        self.logits = Unit3D(1024, NUM_CLASSES, bn=False)

    @torch.no_grad()
    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) videos in [0, 1] -> FVD features (B, 400): the Kinetics logits
        before the softmax, averaged over time."""
        x = preprocess(videos.to(self.logits.conv3d.weight.device))
        x = x.permute(0, 4, 1, 2, 3).contiguous()  # (B, 3, T, H, W)
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = _max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = _max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        # global spatial average pool (the TF model's 2 x 7 x 7 average pool, any H and W)
        x = x.mean(dim=(3, 4), keepdim=True)
        return self.logits(x)[:, :, :, 0, 0].mean(dim=2)

    def init_synthetic(self, generator: torch.Generator, scale: float = 0.05) -> None:
        """Random convolutions (normal x ``scale``), zero logits bias and identity
        BatchNorm, as the JAX ``init_synthetic``."""
        init_synthetic(self, generator, scale)


def load_torch_state_dict(model: InceptionI3d, state_dict: Mapping) -> None:
    """A pytorch-i3d ``state_dict``, strictly, without ``num_batches_tracked``."""
    load_feature_state_dict(model, state_dict, r"num_batches_tracked$")


def build_i3d(device="cuda", generator: torch.Generator | None = None) -> InceptionI3d:
    """I3D in fp32 on ``device`` (the card by default; the CPU must be named),
    ``init_synthetic`` from ``generator`` when one is given."""
    from lkgd_torch.utils.device import require_device

    model = InceptionI3d().to(require_device(device)).eval()
    if generator is not None:
        model.init_synthetic(generator)
    return model
