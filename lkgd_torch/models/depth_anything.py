"""Depth-Anything (counterpart of ``lkgd_tpu/models/depth_anything.py``): a DINOv2 ViT and a
DPT neck and head, the ``depth_anything`` annotator.

DINOv2: a patch-14 convolution, the cls token, the learned position embedding resampled to
the input's grid by torch's bicubic (``ops/resize.bicubic_resize``: a = -0.75, half-pixel,
no antialias), pre-norm layers with LayerScale and exact-erf GELU whose attention is the
port's ``ops/attention.dot_product_attention``: at 518 x 518, 1370 tokens, fp32, so the
fp32 flash form of kernels 1, 2 and 1a on the card. The four tapped layers go through the
backbone's final LayerNorm, lose the cls token and are reassembled (1x1 projections; 4x and
2x transposed convolutions, identity, a stride-2 convolution), fused deepest first with
align-corners upsampling to the next level's size, and the head resizes to the input's
pixels.

Activations are channels-last. Module names are HF ``DepthAnythingForDepthEstimation``'s,
including ``backbone.embeddings.mask_token`` and the deepest fusion layer's first residual
unit, which the forward never reads, so a checkpoint loads with
``load_state_dict(strict=True)``. The reassemble transposed convolutions are torch's
``ConvTranspose2d``, as in HF's model; ``lkgd_torch.utils.porting.depth_anything_state_dict``
carries the JAX module's kernels across flipped, since flax's ``ConvTranspose`` applies its
kernel mirrored against torch's (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import Conv2d, init_params, materialize
from lkgd_torch.models.midas import DPTNeck, HFAttention, Mlp, resize_bilinear_ac
from lkgd_torch.ops.attention import dot_product_attention
from lkgd_torch.ops.resize import bicubic_resize, resize_bilinear
from lkgd_torch.utils.device import require_device


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    image_size: int = 518  # a multiple of patch_size
    patch_size: int = 14
    hidden_size: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    out_indices: Tuple[int, ...] = (8, 9, 10, 11)
    neck_hidden_sizes: Tuple[int, ...] = (48, 96, 192, 384)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    layer_norm_eps: float = 1e-6

    @classmethod
    def small(cls) -> "DepthAnythingConfig":
        return cls()

    @classmethod
    def base(cls) -> "DepthAnythingConfig":
        return cls(hidden_size=768, num_heads=12, neck_hidden_sizes=(96, 192, 384, 768),
                   fusion_hidden_size=128)

    @classmethod
    def tiny(cls) -> "DepthAnythingConfig":
        return cls(image_size=28, patch_size=14, hidden_size=32, depth=4, num_heads=2,
                   out_indices=(0, 1, 2, 3), neck_hidden_sizes=(8, 8, 16, 16),
                   fusion_hidden_size=16, head_hidden_size=8)


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        ps = cfg.patch_size
        self.projection = Conv2d(3, cfg.hidden_size, ps, stride=ps)


class Dinov2Embeddings(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        g = cfg.image_size // cfg.patch_size
        d = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))  # never read at inference
        self.position_embeddings = nn.Parameter(torch.zeros(1, g * g + 1, d))
        self.patch_embeddings = _PatchEmbeddings(cfg)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()
        self.mask_token.zero_()
        self.position_embeddings.normal_(0.0, 0.02, generator=generator)


class _LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(d))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.lambda1.fill_(1.0)


class Dinov2Layer(nn.Module):
    """Pre-norm ViT layer with LayerScale and exact GELU."""

    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attention = HFAttention(d, cfg.num_heads)
        self.layer_scale1 = _LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(d, d * cfg.mlp_ratio)
        self.layer_scale2 = _LayerScale(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = self.attention.attention.qkv(self.norm1(x))
        o = self.attention.output.dense(dot_product_attention(q, k, v).reshape(b, s, d))
        x = x + o * self.layer_scale1.lambda1
        return x + self.mlp(self.norm2(x)) * self.layer_scale2.lambda1


class _Encoder(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        self.layer = nn.ModuleList([Dinov2Layer(cfg) for _ in range(cfg.depth)])


class Dinov2Backbone(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        self.embeddings = Dinov2Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Head(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        f = cfg.fusion_hidden_size
        self.conv1 = Conv2d(f, f // 2, 3, padding=1)
        self.conv2 = Conv2d(f // 2, cfg.head_hidden_size, 3, padding=1)
        self.conv3 = Conv2d(cfg.head_hidden_size, 1, 1)


class DepthAnything(nn.Module):
    """(B, H, W, 3) ImageNet-normalised pixels, H and W multiples of the patch -> (B, H, W)
    relative depth (>= 0)."""

    def __init__(self, config: DepthAnythingConfig = DepthAnythingConfig()):
        super().__init__()
        self.config = config
        self.backbone = Dinov2Backbone(config)
        self.neck = DPTNeck(config.hidden_size, config.neck_hidden_sizes,
                            config.fusion_hidden_size, readout=False)
        self.head = _Head(config)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg, emb = self.config, self.backbone.embeddings
        b, hh, ww, _ = pixel_values.shape
        ph, pw = hh // cfg.patch_size, ww // cfg.patch_size
        d = cfg.hidden_size
        x = emb.patch_embeddings.projection(pixel_values).reshape(b, ph * pw, d)
        pos = emb.position_embeddings
        g = cfg.image_size // cfg.patch_size
        patch_pos = pos[:, 1:].reshape(1, g, g, d)
        if (ph, pw) != (g, g):
            patch_pos = bicubic_resize(patch_pos, (ph, pw))
        x = x + patch_pos.reshape(1, ph * pw, d)
        x = torch.cat([(emb.cls_token + pos[:, :1]).expand(b, 1, d), x], dim=1)
        taps = []
        for i, layer in enumerate(self.backbone.encoder.layer):
            x = layer(x)
            if i in cfg.out_indices:
                taps.append(self.backbone.layernorm(x)[:, 1:])

        stage = self.neck.reassemble_stage
        feats = [self.neck.convs[j](stage.layers[j](t.reshape(b, ph, pw, d)))
                 for j, t in enumerate(taps)]
        fusion = self.neck.fusion_stage.layers  # layer 0 fuses the deepest feature
        fused = None
        for j in (3, 2, 1, 0):
            layer = fusion[3 - j]
            size = feats[j - 1].shape[1:3] if j > 0 else None
            fused = layer(feats[j], size=size) if fused is None else layer(fused, feats[j], size)

        head = self.head
        h = resize_bilinear_ac(head.conv1(fused), hh, ww)
        h = head.conv3(F.relu(head.conv2(h)))
        return F.relu(h)[..., 0]


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_pixels(images01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, device=images01.device)
    std = torch.tensor(IMAGENET_STD, device=images01.device)
    return (images01 - mean) / std


def make_depth_processor(model: DepthAnything):
    """The ``depth_anything`` annotator: (H, W, 3) [0, 1] -> (H, W, 3) [0, 1]. JAX's
    bilinear resize (antialiased when it shrinks) to the square ``image_size``, the model,
    min-max normalised, the same resize back to (H, W)."""
    size = model.config.image_size
    device = next(model.parameters()).device

    @torch.no_grad()
    def process(image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        img = resize_bilinear(torch.as_tensor(image, dtype=torch.float32).to(device),
                              (size, size))
        d = model(normalize_pixels(img)[None])[0]
        d = (d - d.min()) / (d.max() - d.min() + 1e-8)
        d = resize_bilinear(d[..., None], (h, w))[..., 0]
        return np.repeat(d.cpu().numpy().astype(np.float32)[..., None], 3, axis=-1)

    return process


def build_depth_anything(config: DepthAnythingConfig = DepthAnythingConfig(), device="cuda",
                         generator: Optional[torch.Generator] = None) -> DepthAnything:
    """A frozen fp32 Depth-Anything in eval mode on ``device`` (the card unless the CPU is
    named), random from ``generator`` when one is given, else uninitialised for
    ``load_state_dict``."""
    device = require_device(device)
    model = materialize(lambda: DepthAnything(config), device, torch.float32)
    if generator is not None:
        init_params(model, generator)
    return model.eval().requires_grad_(False)
