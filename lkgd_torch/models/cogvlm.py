"""CogVLM2 video captioning (counterpart of ``lkgd_tpu/models/cogvlm.py``):
THUDM/cogvlm2-llama3-caption, CogVideoX's captioner, at ``CogVLMConfig.caption_8b()``.

* The LM: LLaMA3-8B with visual experts. Every projection (``query_key_value`` with bias,
  ``dense``, the SwiGLU ``gate_proj``/``up_proj``/``down_proj``) has a vision and a language
  weight; both run over the whole sequence and a mask selects each token's
  (``_ExpertDense``), as the JAX module does. RMSNorm in fp32, rotate-half RoPE in fp32 over
  ``build_position_ids``' compressed positions (a vision span shares one position), GQA
  (8 KV heads repeated to 32) through the port's ``ops/attention.dot_product_attention`` with
  the causal mask, which takes its plain form.
* The vision tower: EVA2-CLIP-E (a 14x14 patch convolution, the cls token, learned positions;
  63 layers whose LayerNorms apply to each sublayer's output, ``x + ln(attn(x))``), the cls
  token dropped, a 2x2 stride-2 convolution, the SwiGLU GLU adapter, and ``boi`` / ``eoi``
  around the frames' tokens. Its 257 tokens a frame take the plain attention.

Module names are THUDM's (``model.layers.<i>.self_attn.vision_expert_query_key_value``,
``model.vision.transformer.layers.<i>.attention.dense``, ``model.vision.linear_proj.norm1``,
``lm_head``), so a checkpoint loads with ``load_state_dict(strict=True)`` once
``port_cogvlm`` has dropped the rotary buffers, which the published modules keep and the
port computes. Tokens are ``(B, S, D)``, frames ``(B, T, H, W, 3)`` channels-last.

``greedy_video_caption`` computes the frames' features once a video (they do not depend on
the ids) and re-runs the LM over the padded sequence each step, as the JAX scan does; the
head projects only the position it reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import build_frozen
from lkgd_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CogVLMConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    vision_hidden: int = 1792
    vision_layers: int = 63
    vision_heads: int = 16
    vision_intermediate: int = 15360
    patch_size: int = 14
    image_size: int = 224
    bos_token_id: int = 128000
    eos_token_id: int = 128001
    pad_token_id: int = 128002

    @classmethod
    def caption_8b(cls) -> "CogVLMConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CogVLMConfig":
        return cls(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                   intermediate_size=64, vision_hidden=24, vision_layers=2, vision_heads=2,
                   vision_intermediate=48, patch_size=8, image_size=32, bos_token_id=1,
                   eos_token_id=2, pad_token_id=0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def tokens_per_frame(self) -> int:
        return (self.image_size // self.patch_size // 2) ** 2


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (x32 * self.weight.float()).to(x.dtype)


def rotary(x: torch.Tensor, position_ids: torch.Tensor, theta: float) -> torch.Tensor:
    """LLaMA's rotate-half RoPE on (B, S, H, D) at positions (B, S), in fp32."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = position_ids[..., None].float() * inv
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _expert(vision: nn.Linear, language: nn.Linear, x: torch.Tensor,
            vision_mask: torch.Tensor) -> torch.Tensor:
    """``_ExpertDense``: both experts over every token, each token keeping its own."""
    return torch.where(vision_mask[..., None], vision(x), language(x))


class _Attention(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.cfg = cfg
        qkv = cfg.hidden_size + 2 * cfg.num_kv_heads * cfg.head_dim
        self.vision_expert_query_key_value = nn.Linear(cfg.hidden_size, qkv)
        self.language_expert_query_key_value = nn.Linear(cfg.hidden_size, qkv)
        self.vision_expert_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=False)
        self.language_expert_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, bias=False)

    def forward(self, h, vision_mask, position_ids, attn_mask) -> torch.Tensor:
        cfg = self.cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        b, s = h.shape[:2]
        qkv = _expert(self.vision_expert_query_key_value, self.language_expert_query_key_value,
                      h, vision_mask)
        q, k, v = qkv.split([d, cfg.num_kv_heads * hd, cfg.num_kv_heads * hd], dim=-1)
        q = rotary(q.reshape(b, s, cfg.num_heads, hd), position_ids, cfg.rope_theta)
        k = rotary(k.reshape(b, s, cfg.num_kv_heads, hd), position_ids, cfg.rope_theta)
        v = v.reshape(b, s, cfg.num_kv_heads, hd)
        rep = cfg.num_heads // cfg.num_kv_heads
        att = dot_product_attention(q, k.repeat_interleave(rep, dim=2),
                                    v.repeat_interleave(rep, dim=2), mask=attn_mask)
        return _expert(self.vision_expert_dense, self.language_expert_dense,
                       att.reshape(b, s, d), vision_mask)


class _Mlp(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, inner, bias=False)
        self.up_proj = nn.Linear(d, inner, bias=False)
        self.down_proj = nn.Linear(inner, d, bias=False)


class _ExpertMlp(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.vision_mlp = _Mlp(cfg.hidden_size, cfg.intermediate_size)
        self.language_mlp = _Mlp(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, h: torch.Tensor, vision_mask: torch.Tensor) -> torch.Tensor:
        vis, lang = self.vision_mlp, self.language_mlp
        gate = _expert(vis.gate_proj, lang.gate_proj, h, vision_mask)
        up = _expert(vis.up_proj, lang.up_proj, h, vision_mask)
        return _expert(vis.down_proj, lang.down_proj, F.silu(gate) * up, vision_mask)


class CogVLMDecoderLayer(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = _Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = _ExpertMlp(cfg)

    def forward(self, x, vision_mask, position_ids, attn_mask) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), vision_mask, position_ids, attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x), vision_mask)


class _VisionAttention(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.heads = cfg.vision_heads
        self.query_key_value = nn.Linear(cfg.vision_hidden, 3 * cfg.vision_hidden)
        self.dense = nn.Linear(cfg.vision_hidden, cfg.vision_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = self.query_key_value(x).reshape(b, s, 3, self.heads, -1).unbind(2)
        return self.dense(dot_product_attention(q, k, v).reshape(b, s, d))


class _VisionMlp(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.vision_hidden, cfg.vision_intermediate)
        self.fc2 = nn.Linear(cfg.vision_intermediate, cfg.vision_hidden)


class EVAVisionLayer(nn.Module):
    """THUDM visual.py's TransformerLayer: ``x + ln(attn(x))``, then ``x + ln(mlp(x))``."""

    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.input_layernorm = nn.LayerNorm(cfg.vision_hidden, eps=1e-6)
        self.attention = _VisionAttention(cfg)
        self.mlp = _VisionMlp(cfg)
        self.post_attention_layernorm = nn.LayerNorm(cfg.vision_hidden, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.input_layernorm(self.attention(x))
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(x)))
        return x + self.post_attention_layernorm(h)


class _PatchEmbedding(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        p, d = cfg.patch_size, cfg.vision_hidden
        self.proj = nn.Conv2d(3, d, p, stride=p)
        self.cls_embedding = nn.Parameter(torch.zeros(1, d))
        self.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, d)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.cls_embedding.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.proj(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        b, _, d = x.shape
        x = torch.cat([self.cls_embedding.expand(b, 1, d).to(x.dtype), x], dim=1)
        return x + self.position_embedding.weight.to(x.dtype)


class _Transformer(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.layers = nn.ModuleList([EVAVisionLayer(cfg) for _ in range(cfg.vision_layers)])


class _GLU(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        d, inner = cfg.hidden_size, cfg.intermediate_size
        self.linear_proj = nn.Linear(d, d, bias=False)
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.gate_proj = nn.Linear(d, inner, bias=False)
        self.dense_h_to_4h = nn.Linear(d, inner, bias=False)
        self.dense_4h_to_h = nn.Linear(inner, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.norm1(self.linear_proj(x)))
        return self.dense_4h_to_h(F.silu(self.gate_proj(x)) * self.dense_h_to_4h(x))


class EVAVisionModel(nn.Module):
    """(N, H, W, 3) frames -> (N, tokens_per_frame, hidden_size) LM-width tokens; ``boi`` and
    ``eoi`` are held here, as THUDM holds them, and placed by the captioner."""

    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embedding = _PatchEmbedding(cfg)
        self.transformer = _Transformer(cfg)
        self.linear_proj = _GLU(cfg)
        self.conv = nn.Conv2d(cfg.vision_hidden, cfg.hidden_size, 2, stride=2)
        self.boi = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.eoi = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.boi.zero_()
        self.eoi.zero_()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixels.to(self.conv.weight.dtype))
        for layer in self.transformer.layers:
            x = layer(x)
        n, _, d = x.shape
        g = self.cfg.image_size // self.cfg.patch_size
        x = self.conv(x[:, 1:].reshape(n, g, g, d).permute(0, 3, 1, 2))
        return self.linear_proj(x.flatten(2).transpose(1, 2))


def build_position_ids(vision_mask: torch.Tensor) -> torch.Tensor:
    """THUDM's compressed positions: a language token advances the position, a vision token
    only where it starts a contiguous vision span (``boi`` and ``eoi`` are language)."""
    v = vision_mask.long()
    prev = F.pad(v[:, :-1], (1, 0))
    return torch.cumsum(1 - (v & prev), dim=-1) - 1


class _Model(nn.Module):
    def __init__(self, cfg: CogVLMConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([CogVLMDecoderLayer(cfg) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.vision = EVAVisionModel(cfg)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        w = self.embed_tokens.weight
        w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)


class CogVLMVideoCaptioner(nn.Module):
    """Frames and token ids -> next-token logits over the ids' span."""

    def __init__(self, cfg: CogVLMConfig = CogVLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.model = _Model(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def image_features(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> (B, 2 + T * tokens_per_frame, hidden): [boi | frames | eoi]."""
        b, t = frames.shape[:2]
        vision = self.model.vision
        feats = vision(frames.reshape(b * t, *frames.shape[2:])).reshape(b, -1, self.cfg.hidden_size)
        return torch.cat([vision.boi.expand(b, 1, -1).to(feats.dtype), feats,
                          vision.eoi.expand(b, 1, -1).to(feats.dtype)], dim=1)

    def hidden(self, img: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """The LM's final-norm states over [image | ids]: the image span vision-expert but for
        ``boi`` and ``eoi``, the causal mask, ``build_position_ids``' positions."""
        b, n_img = img.shape[:2]
        x = torch.cat([img, self.model.embed_tokens(input_ids).to(img.dtype)], dim=1)
        s = x.shape[1]
        vision_mask = torch.zeros((b, s), dtype=torch.bool, device=x.device)
        vision_mask[:, 1:n_img - 1] = True
        position_ids = build_position_ids(vision_mask)
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))[None, None]
        for layer in self.model.layers:
            x = layer(x, vision_mask, position_ids, causal)
        return self.model.norm(x)

    def forward(self, frames: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """frames (B, T, H, W, 3) CLIP-normalised, ids (B, S) -> logits (B, S, vocab)."""
        img = self.image_features(frames)
        return self.lm_head(self.hidden(img, input_ids)[:, img.shape[1]:])


def build_cogvlm(cfg: CogVLMConfig = CogVLMConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.bfloat16) -> CogVLMVideoCaptioner:
    """A frozen ``CogVLMVideoCaptioner`` in ``dtype`` (bf16, as the JAX CLI builds it) on
    ``device`` (the card unless the CPU is named), random from ``generator`` when one is
    given, else uninitialised for ``load_state_dict``."""
    return build_frozen(lambda: CogVLMVideoCaptioner(cfg), device, generator, dtype)


@torch.no_grad()
def greedy_video_caption(model: CogVLMVideoCaptioner, frames: torch.Tensor,
                         prompt_ids: torch.Tensor, max_new_tokens: int = 64) -> torch.Tensor:
    """Greedy decoding: (B, max_new_tokens) generated ids, PAD after an EOS. The frames'
    features once, then the LM over the prompt and the padded tail each step."""
    cfg = model.cfg
    b, n_prompt = prompt_ids.shape
    ids = torch.full((b, n_prompt + max_new_tokens), cfg.pad_token_id, dtype=torch.long,
                     device=prompt_ids.device)
    ids[:, :n_prompt] = prompt_ids
    img = model.image_features(frames)
    for i in range(max_new_tokens):
        pos = img.shape[1] + n_prompt + i - 1
        nxt = model.lm_head(model.hidden(img, ids)[:, pos]).argmax(dim=-1)
        done = (ids == cfg.eos_token_id).any(dim=-1)
        ids[:, n_prompt + i] = torch.where(done, cfg.pad_token_id, nxt)
    return ids[:, n_prompt:]


DERIVED = ("rotary_emb.inv_freq",)  # buffers the published modules keep and the port computes


def port_cogvlm(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CogVLM2 checkpoint -> ``CogVLMVideoCaptioner``'s state dict: the rotary buffers
    dropped, as the JAX package's ``cogvlm_key_map`` drops them."""
    return {k: v for k, v in state_dict.items() if not k.endswith(DERIVED)}
