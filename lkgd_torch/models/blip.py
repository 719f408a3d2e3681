"""BLIP captioning (counterpart of ``lkgd_tpu/models/blip.py``): HF
``BlipForConditionalGeneration`` (``Salesforce/blip-image-captioning-large`` / ``-base``), a
ViT image encoder and a BERT decoder that cross-attends to it.

The ViT: a 16x16 patch convolution, the class token and a learned position embedding, pre-norm
layers (LayerNorm eps 1e-6, as the JAX module sets it, a fused ``qkv``, exact GELU) and a final
LayerNorm. The decoder: word and position embeddings with their LayerNorm, post-norm BERT
layers (causal self-attention, cross-attention to the image tokens, exact-GELU MLP; eps 1e-12)
and the prediction head (dense, GELU, LayerNorm, vocabulary projection). Attention is its own
einsum in the model's dtype with an additive mask, as the JAX module computes it. Module names
are HF's, the prediction bias held once and named twice as HF ties it
(``cls.predictions.bias`` = ``cls.predictions.decoder.bias``), so a checkpoint loads with
``load_state_dict(strict=True)``. Tokens are ``(B, S, D)``, images channels-last.

``greedy_caption`` decodes at a fixed padded length, re-running the whole decoder a step in a
plain loop, as the JAX scan does; the image is encoded once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import build_frozen


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    image_size: int = 384
    patch_size: int = 16
    vision_hidden: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    vision_intermediate: int = 4096
    vocab_size: int = 30524
    text_hidden: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    bos_token_id: int = 30522  # [DEC]
    sep_token_id: int = 102  # [SEP] ends the caption
    pad_token_id: int = 0

    @classmethod
    def large(cls) -> "BlipConfig":
        return cls()

    @classmethod
    def base(cls) -> "BlipConfig":
        return cls(vision_hidden=768, vision_layers=12, vision_heads=12,
                   vision_intermediate=3072)


def _attn(q, k, v, heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, sq, d = q.shape
    hd = d // heads
    q, k, v = (t.reshape(b, t.shape[1], heads, hd) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    if mask is not None:
        s = s + mask
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v).reshape(b, sq, d)


class _VisionAttention(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.heads = cfg.vision_heads
        self.qkv = nn.Linear(cfg.vision_hidden, 3 * cfg.vision_hidden)
        self.projection = nn.Linear(cfg.vision_hidden, cfg.vision_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.projection(_attn(q, k, v, self.heads))


class _VisionMlp(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.vision_hidden, cfg.vision_intermediate)
        self.fc2 = nn.Linear(cfg.vision_intermediate, cfg.vision_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _VisionLayer(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.vision_hidden, eps=1e-6)
        self.self_attn = _VisionAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.vision_hidden, eps=1e-6)
        self.mlp = _VisionMlp(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        d, p = cfg.vision_hidden, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, d))
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p)
        self.position_embedding = nn.Parameter(torch.zeros(1, (cfg.image_size // p) ** 2 + 1, d))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.class_embedding.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b = pixels.shape[0]
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(b, 1, -1), x], dim=1)
        return x + self.position_embedding[:, :x.shape[1]]


class _VisionEncoder(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.layers = nn.ModuleList([_VisionLayer(cfg) for _ in range(cfg.vision_layers)])


class BlipVisionModel(nn.Module):
    """(B, S, S, 3) normalised pixels -> (B, 1 + N, D) image tokens."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.encoder = _VisionEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.vision_hidden, eps=1e-6)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(pixels)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, kv_dim: int):
        super().__init__()
        self.query, self.key, self.value = (nn.Linear(d, d), nn.Linear(kv_dim, d),
                                            nn.Linear(kv_dim, d))


class _SelfOutput(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)


class _BertAttention(nn.Module):
    """Post-LN BERT attention (self or cross)."""

    def __init__(self, cfg: BlipConfig, kv_dim: int):
        super().__init__()
        self.heads = cfg.text_heads
        self.self = _SelfAttention(cfg.text_hidden, kv_dim)
        self.output = _SelfOutput(cfg.text_hidden, cfg.layer_norm_eps)

    def forward(self, x, kv, mask=None) -> torch.Tensor:
        s = self.self
        h = _attn(s.query(x), s.key(kv), s.value(kv), self.heads, mask)
        return self.output.LayerNorm(x + self.output.dense(h))


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)


class _Output(_Dense):
    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__(cin, cout)
        self.LayerNorm = nn.LayerNorm(cout, eps=eps)


class _TextLayer(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.attention = _BertAttention(cfg, cfg.text_hidden)
        self.crossattention = _BertAttention(cfg, cfg.vision_hidden)
        self.intermediate = _Dense(cfg.text_hidden, cfg.text_intermediate)
        self.output = _Output(cfg.text_intermediate, cfg.text_hidden, cfg.layer_norm_eps)

    def forward(self, x, enc, causal) -> torch.Tensor:
        x = self.attention(x, x, causal)
        x = self.crossattention(x, enc)
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + h)


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.text_hidden)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.text_hidden)
        self.LayerNorm = nn.LayerNorm(cfg.text_hidden, eps=cfg.layer_norm_eps)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        for e in (self.word_embeddings, self.position_embeddings):
            e.weight.normal_(0.0, 0.02, generator=generator)


class _TextEncoder(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.layer = nn.ModuleList([_TextLayer(cfg) for _ in range(cfg.text_layers)])


class _Bert(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _TextEncoder(cfg)


class _Transform(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)


class _Predictions(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.transform = _Transform(cfg.text_hidden, cfg.layer_norm_eps)
        self.decoder = nn.Linear(cfg.text_hidden, cfg.vocab_size)
        self.bias = self.decoder.bias  # HF ties the two names to one parameter


class _Heads(nn.Module):
    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.predictions = _Predictions(cfg)


class BlipTextDecoder(nn.Module):
    """(B, S) ids and the image tokens -> (B, S, vocab) causal logits."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.bert = _Bert(cfg)
        self.cls = _Heads(cfg)

    def forward(self, input_ids: torch.Tensor, encoder_states: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        emb = self.bert.embeddings
        pos = torch.arange(s, device=input_ids.device)[None]
        x = emb.LayerNorm(emb.word_embeddings(input_ids) + emb.position_embeddings(pos))
        tril = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
        causal = torch.where(tril, 0.0, torch.finfo(torch.float32).min).to(x.dtype)[None, None]
        for layer in self.bert.encoder.layer:
            x = layer(x, encoder_states, causal)
        p = self.cls.predictions
        h = p.transform.LayerNorm(F.gelu(p.transform.dense(x)))
        return p.decoder(h)


class BlipCaptioner(nn.Module):
    """HF ``BlipForConditionalGeneration``'s captioning path."""

    def __init__(self, cfg: BlipConfig = BlipConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = BlipVisionModel(cfg)
        self.text_decoder = BlipTextDecoder(cfg)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_decoder(input_ids, self.vision_model(pixels))


def build_blip(cfg: BlipConfig = BlipConfig(), device="cuda",
               generator: Optional[torch.Generator] = None) -> BlipCaptioner:
    """A frozen fp32 ``BlipCaptioner`` on ``device`` (the card unless the CPU is named), random
    from ``generator`` when one is given, else uninitialised for ``load_state_dict``."""
    model = build_frozen(lambda: BlipCaptioner(cfg), device, generator)
    preds = model.text_decoder.cls.predictions
    preds.bias = preds.decoder.bias  # the tie, which the move off the meta device undoes
    return model


@torch.no_grad()
def greedy_caption(model: BlipCaptioner, pixels: torch.Tensor,
                   max_length: int = 20) -> torch.Tensor:
    """Greedy decoding at a fixed padded length: (B, max_length) ids, BOS first, PAD after a
    SEP; the image encoded once and the whole decoder re-run each step."""
    cfg = model.cfg
    enc = model.vision_model(pixels)
    ids = torch.full((pixels.shape[0], max_length), cfg.pad_token_id, dtype=torch.long,
                     device=pixels.device)
    ids[:, 0] = cfg.bos_token_id
    for i in range(max_length - 1):
        nxt = model.text_decoder(ids, enc)[:, i].argmax(dim=-1)
        done = (ids == cfg.sep_token_id).any(dim=-1)
        ids[:, i + 1] = torch.where(done, cfg.pad_token_id, nxt)
    return ids


IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_images(images: np.ndarray, image_size: int = 384) -> np.ndarray:
    """(B, H, W, 3) [0, 1] -> (B, S, S, 3) float32 model pixels: cv2 ``INTER_CUBIC`` to the
    square size, normalised with CLIP's statistics (HF ``BlipProcessor``)."""
    import cv2

    out = np.stack([cv2.resize(im, (image_size, image_size), interpolation=cv2.INTER_CUBIC)
                    for im in images])
    return ((out - IMAGE_MEAN) / IMAGE_STD).astype(np.float32)
