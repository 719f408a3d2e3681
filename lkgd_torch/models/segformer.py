"""SegFormer (counterpart of ``lkgd_tpu/models/segformer.py``): HF
``SegformerForSemanticSegmentation`` on ADE20K (MiT-B4 ``b4_ade``, MiT-B0 ``b0_ade``), the
``segmentation`` annotator.

Four MiT stages: an overlapping patch embedding (7x7 stride 4, then 3x3 stride 2) and its
LayerNorm; blocks of pre-norm efficient attention (keys and values from a strided
``sr_ratio`` convolution and a LayerNorm, the attention its own fp32-logit einsum) and Mix-FFN
(a 1x1, the depthwise 3x3, exact GELU, a 1x1); a LayerNorm closing each stage. The all-MLP
decode head projects each stage to ``decoder_hidden``, resizes it bilinearly to the 1/4 grid
(JAX's ``"bilinear"``, ``ops/resize.resize_bilinear``), concatenates the four deepest first,
fuses by a bias-free 1x1, applies the inference BatchNorm as the JAX module folds it and a
ReLU, and classifies. Module names are HF's (``segformer.encoder.block.<i>.<j>.attention.self
.sr``, ``decode_head.batch_norm.running_var``, ...), so the checkpoint loads with
``load_state_dict(strict=True)``. Activations are channels-last.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import build_frozen
from lkgd_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    hidden_sizes: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 8, 27, 3)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratio: int = 4
    decoder_hidden: int = 768
    num_labels: int = 150
    eps: float = 1e-6

    @classmethod
    def b4_ade(cls) -> "SegformerConfig":
        return cls()

    @classmethod
    def b0_ade(cls) -> "SegformerConfig":
        return cls(hidden_sizes=(32, 64, 160, 256), depths=(2, 2, 2, 2), decoder_hidden=256)

    @classmethod
    def tiny(cls) -> "SegformerConfig":
        return cls(hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4),
                   decoder_hidden=16, num_labels=5)


class _PatchEmbeddings(nn.Module):
    def __init__(self, cin: int, cout: int, patch: int, stride: int, eps: float):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, patch, stride=stride, padding=patch // 2)
        self.layer_norm = nn.LayerNorm(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.layer_norm(y)


class _EfficientSelfAttention(nn.Module):
    def __init__(self, c: int, heads: int, sr: int, eps: float):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.query, self.key, self.value = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        if sr > 1:
            self.sr = nn.Conv2d(c, c, sr, stride=sr)
            self.layer_norm = nn.LayerNorm(c, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        q = self.query(x).reshape(b, h * w, self.heads, -1)
        kv = x
        if self.sr_ratio > 1:
            kv = self.layer_norm(self.sr(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        kv = kv.reshape(b, -1, c)
        k = self.key(kv).reshape(b, kv.shape[1], self.heads, -1)
        v = self.value(kv).reshape(b, kv.shape[1], self.heads, -1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, h, w, c)


class _SelfOutput(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dense = nn.Linear(c, c)


class _Attention(nn.Module):
    def __init__(self, c: int, heads: int, sr: int, eps: float):
        super().__init__()
        self.self = _EfficientSelfAttention(c, heads, sr, eps)
        self.output = _SelfOutput(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output.dense(self.self(x))


class _DWConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dwconv = nn.Conv2d(c, c, 3, padding=1, groups=c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _MixFFN(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(c, hidden)
        self.dwconv = _DWConv(hidden)
        self.dense2 = nn.Linear(hidden, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense2(F.gelu(self.dwconv(self.dense1(x))))


class _Layer(nn.Module):
    def __init__(self, c: int, heads: int, sr: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(c, eps=eps)
        self.attention = _Attention(c, heads, sr, eps)
        self.layer_norm_2 = nn.LayerNorm(c, eps=eps)
        self.mlp = _MixFFN(c, c * mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_1(x))
        return x + self.mlp(self.layer_norm_2(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        cins = (3,) + cfg.hidden_sizes[:-1]
        self.patch_embeddings = nn.ModuleList([
            _PatchEmbeddings(cins[i], c, cfg.patch_sizes[i], cfg.strides[i], cfg.eps)
            for i, c in enumerate(cfg.hidden_sizes)])
        self.block = nn.ModuleList([nn.ModuleList([
            _Layer(c, cfg.num_heads[i], cfg.sr_ratios[i], cfg.mlp_ratio, cfg.eps)
            for _ in range(cfg.depths[i])]) for i, c in enumerate(cfg.hidden_sizes)])
        self.layer_norm = nn.ModuleList([nn.LayerNorm(c, eps=cfg.eps) for c in cfg.hidden_sizes])


class _Segformer(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        self.encoder = _Encoder(cfg)


class _MLP(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)


class _DecodeHead(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        d = cfg.decoder_hidden
        self.linear_c = nn.ModuleList([_MLP(c, d) for c in cfg.hidden_sizes])
        self.linear_fuse = nn.Conv2d(4 * d, d, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(d)
        self.classifier = nn.Conv2d(d, cfg.num_labels, 1)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        bn = self.batch_norm
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
        bn.num_batches_tracked.zero_()


class SegformerForSemanticSegmentation(nn.Module):
    """Normalised pixels (B, H, W, 3), H and W multiples of 32 -> logits
    (B, H/4, W/4, num_labels)."""

    def __init__(self, cfg: SegformerConfig = SegformerConfig()):
        super().__init__()
        self.cfg = cfg
        self.segformer = _Segformer(cfg)
        self.decode_head = _DecodeHead(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        enc = self.segformer.encoder
        x, feats = pixels, []
        for i in range(4):
            x = enc.patch_embeddings[i](x)
            for layer in enc.block[i]:
                x = layer(x)
            x = enc.layer_norm[i](x)
            feats.append(x)
        head = self.decode_head
        th, tw = feats[0].shape[1:3]
        fused = [resize_bilinear(head.linear_c[i].proj(f), (th, tw)) for i, f in enumerate(feats)]
        y = head.linear_fuse(torch.cat(fused[::-1], dim=-1).permute(0, 3, 1, 2))
        bn = head.batch_norm
        inv = torch.rsqrt(bn.running_var + 1e-5) * bn.weight
        y = F.relu(y * inv[:, None, None] + (bn.bias - bn.running_mean * inv)[:, None, None])
        return head.classifier(y).permute(0, 2, 3, 1)


ADE20K_PALETTE_SEED = 20
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def ade_palette(num_labels: int = 150) -> np.ndarray:
    """The label -> colour map, (num_labels, 3) uint8, seeded as the JAX package's."""
    rng = np.random.default_rng(ADE20K_PALETTE_SEED)
    return rng.integers(0, 256, size=(num_labels, 3)).astype(np.uint8)


def segformer_config(model_size: str) -> SegformerConfig:
    """``--model-size``'s configuration, as the JAX CLI picks it: small -> B0, base -> B4."""
    return SegformerConfig.b0_ade() if model_size == "small" else SegformerConfig.b4_ade()


def build_segformer(cfg: SegformerConfig = SegformerConfig(), device="cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> SegformerForSemanticSegmentation:
    """A frozen fp32 SegFormer on ``device`` (the card unless the CPU is named), random from
    ``generator`` when one is given, else uninitialised for ``load_state_dict``."""
    return build_frozen(lambda: SegformerForSemanticSegmentation(cfg), device, generator)


def segformer_labels(model: SegformerForSemanticSegmentation, image: np.ndarray) -> np.ndarray:
    """(H, W, 3) -> the (H', W') class map at 1/4 of the image zero-padded to multiples of
    32: ``image / 255`` padded, normalised with ImageNet's statistics (the padding too), the
    argmax of the logits."""
    device = next(model.parameters()).device
    h, w = image.shape[:2]
    img = np.pad(image.astype(np.float32) / 255.0, ((0, -h % 32), (0, -w % 32), (0, 0)))
    x = torch.from_numpy(img[None]).to(device)
    mean, std = (torch.tensor(v, device=device) for v in (IMAGE_MEAN, IMAGE_STD))
    with torch.no_grad():
        return model((x - mean) / std)[0].argmax(dim=-1).cpu().numpy()


def make_segmentation_processor(model: SegformerForSemanticSegmentation
                                ) -> Callable[[np.ndarray], np.ndarray]:
    """The ``segmentation`` annotator, (H, W, 3) -> (H, W, 3) uint8 palette image: the
    class map coloured by ``ade_palette`` and resized to the padded size by nearest
    neighbour with half-pixel centres (JAX's ``"nearest"``, torch's ``"nearest-exact"``),
    cropped back. It divides its input by 255, as the JAX processor does, whatever the
    input's range."""
    palette = torch.from_numpy(ade_palette(model.cfg.num_labels))

    def process(image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        seg = palette[torch.from_numpy(segformer_labels(model, image))].float()
        seg = F.interpolate(seg.permute(2, 0, 1)[None], size=(h + (-h % 32), w + (-w % 32)),
                            mode="nearest-exact")[0].permute(1, 2, 0)
        return seg[:h, :w].numpy().astype(np.uint8)

    return process
