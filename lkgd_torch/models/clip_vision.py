"""CLIP vision encoder with projection, SVD's image conditioner (counterpart of
``lkgd_tpu/models/clip_vision.py``), with transformers' ``CLIPVisionModelWithProjection``
parameter names. Returns the projected pooled embedding, (B, projection_dim).

Input: (B, 224, 224, 3) channels-last, already CLIP-normalised. Its 257 tokens are below
the flash threshold, so attention runs the plain form.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.configs import CLIPVisionConfig
from lkgd_torch.models.layers import Conv2d
from lkgd_torch.ops.attention import dot_product_attention

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@functools.lru_cache(maxsize=8)
def _clip_stats(dtype: torch.dtype, device: torch.device):
    """CLIP mean and std on ``device``, copied there once: a copy from the host waits for
    the device's queue to drain."""
    return (torch.tensor(CLIP_IMAGE_MEAN, dtype=dtype, device=device),
            torch.tensor(CLIP_IMAGE_STD, dtype=dtype, device=device))


def clip_normalize(images: torch.Tensor) -> torch.Tensor:
    """Normalise [0, 1] (B, H, W, 3) images with CLIP mean/std."""
    mean, std = _clip_stats(images.dtype, images.device)
    return (images - mean) / std


def _act(name: str):
    if name == "gelu":
        return F.gelu
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, s, d = h.shape
        shape = (b, s, self.heads, d // self.heads)
        o = dot_product_attention(self.q_proj(h).view(shape), self.k_proj(h).view(shape),
                                  self.v_proj(h).view(shape))
        return self.out_proj(o.reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = _act(cfg.hidden_act)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(h)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n_positions = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                      stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n_positions, cfg.hidden_size)

    def init_extra(self, generator: torch.Generator) -> None:
        self.class_embedding.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values).reshape(b, -1, self.class_embedding.shape[0])
        cls = self.class_embedding.expand(b, 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                           bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        x = vm.embeddings(pixel_values.to(self.visual_projection.weight.dtype))
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
