"""ViT-B/16-384, the domain and flow knowledge encoders (counterpart of
``lkgd_tpu/models/vit_mae.py``), with timm's ``vit_base_patch16_384`` parameter names
(``patch_embed.proj``, ``blocks.N.attn.qkv``, ``blocks.N.mlp.fc1``, ``head``, ...).

Pre-norm blocks with a fused qkv projection, a cls token and a learned position embedding,
a final norm and the classifier head, whose output is the knowledge feature vector. Input
``(B, 384, 384, 3)`` channels-last. Its 577 tokens are below the flash threshold, so
attention runs the plain form.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import Conv2d
from lkgd_torch.ops.attention import dot_product_attention
from lkgd_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_classes: int = 1000
    layer_norm_eps: float = 1e-6

    @classmethod
    def vit_base_patch16_384(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, hidden_size=32, depth=2, num_heads=2,
                   num_classes=48)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = self.qkv(x).view(b, s, 3, self.heads, d // self.heads).unbind(dim=2)
        return self.proj(dot_product_attention(q, k, v).reshape(b, s, d))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf GELU


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = _Attention(d, cfg.num_heads)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(d, d * cfg.mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size)


class ViT(nn.Module):
    def __init__(self, config: ViTConfig = ViTConfig()):
        super().__init__()
        self.config = cfg = config
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, cfg.hidden_size))
        self.blocks = nn.ModuleList([ViTBlock(cfg) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.head = nn.Linear(cfg.hidden_size, cfg.num_classes)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b = pixel_values.shape[0]
        x = self.patch_embed.proj(pixel_values.to(self.cls_token.dtype))
        x = x.reshape(b, -1, self.config.hidden_size)
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        return self.head(x[:, 0])  # cls-token pooling


def encode_knowledge_features(vit: ViT, frames: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) frames in [-1, 1] -> (B, 1, num_classes): the ViT of every frame
    after the antialiased bilinear resize to its input size, averaged over frames."""
    b, t = frames.shape[:2]
    x = frames.reshape(b * t, *frames.shape[2:])
    size = vit.config.image_size
    x = resize_bilinear(x, (size, size))
    return vit(x).reshape(b, t, -1).mean(dim=1, keepdim=True)

