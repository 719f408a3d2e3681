"""The T5 v1.1 encoder, CogVideoX's text conditioner (counterpart of
``lkgd_tpu/models/t5_text.py`` :47-163).

RMS LayerNorm (no mean, no bias, the variance in fp32), bias-free projections without the
1/sqrt(d) scale, a bucketed relative-position bias held by block 0 and shared by every
block, padding masked with ``finfo(float32).min`` before the softmax, a gated-GELU (tanh)
feed-forward and a final norm. The encoder computes in its parameters' dtype, the attention
logits and softmax in fp32. Its attention is the plain form, as in the JAX package: a
position bias never reaches the flash kernels (and 226 tokens are below their reach).

Parameter names are transformers' ``T5EncoderModel`` names, the ones the JAX package's
``port_t5_encoder`` reads: ``shared.weight`` (tied to ``encoder.embed_tokens.weight``),
``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}.weight``,
``encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight``,
``encoder.block.{i}.layer.{0,1}.layer_norm.weight``,
``encoder.block.{i}.layer.1.DenseReluDense.{wi_0,wi_1,wo}.weight`` and
``encoder.final_layer_norm.weight``, so that such a state dict loads strictly. The
tokenizer wrapper ``T5TextEncoder`` is not ported: it needs a tokenizer and a checkpoint,
and none is in the repository (ROADMAP.md Queue 1, item 11).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.configs import T5Config
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.utils.device import require_device


class T5LayerNorm(nn.Module):
    """T5's RMS norm: no mean subtraction, no bias, the variance accumulated in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.weight.to(x.dtype)


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int, max_distance: int,
                              device=None) -> torch.Tensor:
    """Bidirectional T5 bucketing of ``k_pos - q_pos``: (q_len, k_len) int64 bucket ids, half
    the buckets for keys after the query; distances below a quarter of the buckets exact,
    the rest logarithmic up to ``max_distance``."""
    rel = (torch.arange(k_len, device=device)[None, :]
           - torch.arange(q_len, device=device)[:, None])
    half = num_buckets // 2
    bucket = torch.where(rel > 0, half, 0)
    n = rel.abs()
    max_exact = half // 2
    log_large = max_exact + (torch.log(n.clamp(min=1).float() / max_exact)
                             / math.log(max_distance / max_exact)
                             * (half - max_exact)).to(torch.int64)
    log_large = log_large.clamp(max=half - 1)
    return bucket + torch.where(n < max_exact, n, log_large)


class T5SelfAttention(nn.Module):
    """No biases and no 1/sqrt(d) scale; block 0 holds the relative-position table
    (buckets, heads) and hands its bias to the later blocks."""

    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.config = config
        inner = config.num_heads * config.d_kv
        self.q = nn.Linear(config.d_model, inner, bias=False)
        self.k = nn.Linear(config.d_model, inner, bias=False)
        self.v = nn.Linear(config.d_model, inner, bias=False)
        self.o = nn.Linear(inner, config.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                config.relative_attention_num_buckets, config.num_heads)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if hasattr(self, "relative_attention_bias"):
            w = self.relative_attention_bias.weight
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device))

    def position_bias(self, s: int, device) -> torch.Tensor:
        cfg = self.config
        buckets = relative_position_buckets(s, s, cfg.relative_attention_num_buckets,
                                            cfg.relative_attention_max_distance, device)
        return self.relative_attention_bias.weight[buckets].permute(2, 0, 1)[None]  # (1,H,S,S)

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor],
                mask: Optional[torch.Tensor]):
        cfg = self.config
        b, s, _ = x.shape
        q, k, v = (proj(x).view(b, s, cfg.num_heads, cfg.d_kv) for proj in (self.q, self.k, self.v))
        if position_bias is None:
            position_bias = self.position_bias(s, x.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits + position_bias.float()
        if mask is not None:
            logits = torch.where(mask[:, None, None, :].bool(), logits,
                                 torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
        return self.o(out), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5SelfAttention(config, has_relative_bias)
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon)


class T5DenseGatedActDense(nn.Module):
    """v1.1's gated-GELU feed-forward: ``wo(gelu_tanh(wi_0 x) * wi_1 x)``."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.wi_1 = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.wo = nn.Linear(config.d_ff, config.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(config)
        self.layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(config, has_relative_bias),
                                    T5LayerFF(config)])

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor],
                mask: Optional[torch.Tensor]):
        attn, ff = self.layer
        h, position_bias = attn.SelfAttention(attn.layer_norm(x), position_bias, mask)
        x = x + h
        return x + ff.DenseReluDense(ff.layer_norm(x)), position_bias


class T5Stack(nn.Module):
    def __init__(self, config: T5Config, embed_tokens: nn.Embedding):
        super().__init__()
        self.embed_tokens = embed_tokens
        self.block = nn.ModuleList([T5Block(config, has_relative_bias=i == 0)
                                    for i in range(config.num_layers)])
        self.final_layer_norm = T5LayerNorm(config.d_model, config.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """Token ids (B, S) -> hidden states (B, S, d_model) in the parameters' dtype;
    ``attention_mask`` (B, S), 1 for tokens and 0 for padding."""

    def __init__(self, config: T5Config = T5Config()):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config, self.shared)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        w = self.shared.weight
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared(input_ids)
        position_bias = None
        for block in self.encoder.block:
            x, position_bias = block(x, position_bias, attention_mask)
        return self.encoder.final_layer_norm(x)


def build_t5_encoder(config: T5Config = T5Config(), dtype: torch.dtype = torch.bfloat16,
                     device="cuda", generator: Optional[torch.Generator] = None) -> T5Encoder:
    """A ``T5Encoder`` on ``device`` (the card unless another is named; without one and no
    explicit ``"cpu"`` it raises) in ``dtype``, in eval mode without gradients: random
    weights from ``generator`` (embeddings and the bias table standard normal, as the JAX
    module initialises them), or uninitialised when it is None (fill them with
    ``load_state_dict``)."""
    device = require_device(device)
    model = materialize(lambda: T5Encoder(config), device, dtype)
    if generator is not None:
        init_params(model, generator)
    return model.eval().requires_grad_(False)
