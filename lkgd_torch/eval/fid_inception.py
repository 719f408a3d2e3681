"""The FID feature network, InceptionV3 to pool3 (2048 features), at evaluation
(counterpart of ``lkgd_tpu/eval/fid_inception.py``).

pytorch-fid's network: torchvision's InceptionV3 with the FID patches, average pools that
do not count the padding (``count_include_pad=False``) in the A, C and E blocks and a 3 x 3
stride-1 max pool in the pool branch of the last E block (``Mixed_7c``), with BatchNorm at
eps 1e-3. The modules carry pytorch-fid's ``state_dict`` names, so its checkpoint
(``pt_inception-2015-12-05``) loads with a strict ``load_state_dict`` of the convolution
trunk (``load_torch_state_dict``: the ``fc`` head FID never runs is left out). Images are
(B, H, W, 3) in [0, 1]; ``preprocess`` is pytorch-fid's bilinear resize to 299 x 299
without antialiasing and the scale to [-1, 1]. The convolutions run on cuDNN.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from lkgd_torch.eval._layers import EvalBatchNorm, init_synthetic, load_feature_state_dict
from lkgd_torch.ops.resize import resize_bilinear

SIZE = 299


class BasicConv2d(nn.Module):
    """torchvision's BasicConv2d: bias-free convolution, BatchNorm, ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, bias=False)
        self.bn = EvalBatchNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3_nopad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3_nopad(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c7: int):
        super().__init__()
        h, w = (0, 3), (3, 0)  # the (1, 7) and (7, 1) paddings
        self.branch1x1 = BasicConv2d(768, 192, 1)
        self.branch7x7_1 = BasicConv2d(768, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=h)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=w)
        self.branch7x7dbl_1 = BasicConv2d(768, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=w)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=h)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=w)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=h)
        self.branch_pool = BasicConv2d(768, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3_nopad(x))], 1)


class InceptionD(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(768, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(768, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool="avg"``: pytorch-fid's FIDInceptionE_1 (``Mixed_7b``); ``"max"``: its
    FIDInceptionE_2 (``Mixed_7c``)."""

    def __init__(self, c_in: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = _avg_pool3_nopad(x) if self.pool == "avg" else F.max_pool2d(x, 3, 1, 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> bilinear 299 x 299 without antialiasing (pytorch-fid's
    ``F.interpolate``; an antialiased downscale would break comparability with published
    FID numbers), scaled to [-1, 1]."""
    x = resize_bilinear(images.float(), (SIZE, SIZE), antialias=False)
    return x * 2.0 - 1.0


class InceptionV3(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(128)
        self.Mixed_6c = InceptionC(160)
        self.Mixed_6d = InceptionC(160)
        self.Mixed_6e = InceptionC(192)
        self.Mixed_7a = InceptionD()
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed (B, 3, 299, 299) -> pool3 (B, 2048)."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # the adaptive average pool

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> FID features (B, 2048)."""
        x = preprocess(images.to(self.Conv2d_1a_3x3.conv.weight.device))
        return self.features(x.permute(0, 3, 1, 2).contiguous())

    def init_synthetic(self, generator: torch.Generator, scale: float = 0.05) -> None:
        """Random convolutions (normal x ``scale``) and identity BatchNorm, as the JAX
        ``init_synthetic``: for tests and runs without weights."""
        init_synthetic(self, generator, scale)


def load_torch_state_dict(model: InceptionV3, state_dict: Mapping) -> None:
    """A pytorch-fid / torchvision InceptionV3 ``state_dict``, strictly, without ``fc``,
    ``AuxLogits`` and ``num_batches_tracked``."""
    load_feature_state_dict(model, state_dict, r"^(fc|AuxLogits)\.|num_batches_tracked$")


def build_inception(device="cuda", generator: torch.Generator | None = None) -> InceptionV3:
    """InceptionV3 in fp32 on ``device`` (the card by default; the CPU must be named),
    ``init_synthetic`` from ``generator`` when one is given."""
    from lkgd_torch.utils.device import require_device

    model = InceptionV3().to(require_device(device)).eval()
    if generator is not None:
        model.init_synthetic(generator)
    return model
