"""Common layers of the port (counterpart of ``lkgd_tpu/models/layers.py``).

Activations are channels-last, as in the JAX package: images ``(N, H, W, C)``, tokens
``(N, S, C)``. Convolutions run on the ``(N, C, H, W)`` view of that memory, which is
PyTorch's ``channels_last`` format, so a GroupNorm input is physically ``(N, M, C)`` and
reaches the kernel as a view. Parameter names are diffusers' (``to_out.0``,
``ff.net.0.proj``, ...), so the state dicts exported from the JAX package load with
``load_state_dict(strict=True)``.

Modules are built without touching any random generator (``materialize``) and filled
either from a state dict or by ``init_params`` from an explicit ``torch.Generator``.

LoRA adapters are part of a projection (``DenseWithLora``), statically routed as in the
JAX package: ``y = x W + sum_a gate_a * (x A_a) B_a * alpha_a / rank_a``, with
parameters ``lora_<name>_A`` (in, rank) and ``lora_<name>_B`` (rank, out), the names and
layouts the JAX package's ``export_state_dict`` writes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.ops.attention import dot_product_attention
from lkgd_torch.ops.group_norm import group_norm
from lkgd_torch.utils.device import require_device


# --------------------------------------------------------------------------- building
def materialize(factory: Callable[[], nn.Module], device, dtype: torch.dtype,
                fp32: Optional[Callable[[str], bool]] = None) -> nn.Module:
    """Build ``factory()`` on the meta device, then allocate its parameters (uninitialised)
    on ``device`` in ``dtype``, convolution weights channels-last (4-D) or channels-last-3d
    (5-D), the layouts of the channels-last activations. ``fp32``: a predicate
    on parameter names whose parameters stay float32 whatever ``dtype`` is (trained
    parameters, cast to the compute dtype at use). Fill them with ``init_params`` or
    ``load_state_dict``."""
    with torch.device("meta"):
        module = factory().to(dtype=dtype)
        for name, p in module.named_parameters():
            if fp32 is not None and fp32(name):
                p.data = p.data.float()
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
            elif p.dim() == 5:
                p.data = p.data.contiguous(memory_format=torch.channels_last_3d)
    return module.to_empty(device=device)  # empty_like keeps the strides


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` only, shaped as the JAX modules initialise them:
    linear and convolution weights normal with std fan_in^-1/2, biases zero, norm scales
    one; modules with parameters of their own fill them in ``init_extra(generator)``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if hasattr(m, "init_extra"):
            m.init_extra(generator)


def build_frozen(factory: Callable[[], nn.Module], device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """``factory()`` frozen in eval mode on ``device`` (the card unless the CPU is named) in
    ``dtype``, random from ``generator`` when one is given, else uninitialised for
    ``load_state_dict``."""
    device = require_device(device)
    model = materialize(factory, device, dtype)
    if generator is not None:
        init_params(model, generator)
    return model.eval().requires_grad_(False)


def share_parameters(src: nn.Module, dst: nn.Module) -> nn.Module:
    """Make ``dst`` (the same architecture, built on the meta device) use ``src``'s very
    parameters and buffers: the two modules then differ only in their static configuration
    (stream masks), and loading or moving one loads or moves the other."""
    for name, sub in src.named_modules():
        target = dst.get_submodule(name)
        for key, p in sub._parameters.items():
            target._parameters[key] = p
        for key, b in sub._buffers.items():
            target._buffers[key] = b
    return dst


class CastLinear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype at use, so that a
    trained layer may keep fp32 parameters in a bf16 model (a no-op where they agree)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class ZeroInitLinear(CastLinear):
    """A linear layer that ``init_params`` fills with zeros (the JAX modules'
    ``kernel_init=zeros`` projections, which add nothing until trained)."""

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.weight.zero_()
        if self.bias is not None:
            self.bias.zero_()


# --------------------------------------------------------------------------- embeddings
def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True, downscale_freq_shift: float = 0.0,
                           max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings (diffusers ``Timesteps``), always fp32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """2-layer SiLU MLP over the sinusoidal embedding (diffusers ``TimestepEmbedding``); its
    layers cast their parameters to the input's dtype, so that they may be trained in fp32
    inside a bf16 model."""

    def __init__(self, in_dim: int, time_embed_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = CastLinear(in_dim, time_embed_dim)
        self.linear_2 = CastLinear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


# --------------------------------------------------------------------------- convolutions
class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` taking and returning channels-last ``(N, H, W, C)`` tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ZeroInitConv2d(Conv2d):
    """A :class:`Conv2d` that ``init_params`` fills with zeros (the JAX modules'
    ``kernel_init=zeros`` convolutions: the ControlNet's heads, ``conv_in2``)."""

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.weight.zero_()
        if self.bias is not None:
            self.bias.zero_()


class TemporalConv(nn.Conv3d):
    """diffusers' (3, 1, 1) ``Conv3d`` over frames (weight ``(O, I, 3, 1, 1)``), applied to
    ``(B, T, M, C)`` as a (3, 1) convolution over (T, M) with frame padding 1 — the JAX
    package's ``nn.Conv((3, 1))`` over its ``(B, T, HW, C)`` layout."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight[..., 0], self.bias, padding=(1, 0))
        return y.permute(0, 2, 3, 1)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of ``(N, H, W, C)``, kept channels-last."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


# --------------------------------------------------------------------------- LoRA
@dataclasses.dataclass(frozen=True)
class LoraSpec:
    """One adapter on one projection. ``streams``: the static stream mask, entry s gating
    the s-th contiguous block of rows; empty = every row."""

    name: str
    rank: int = 4
    alpha: float = 4.0
    streams: Tuple[int, ...] = ()

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def stream_gate(mask: Sequence[int], rows: int, dtype, device=None) -> torch.Tensor:
    """A stream-level 0/1 mask expanded to per-row gains (``rows // len(mask)`` each). Masks
    are static, so each gate is built once per (mask, rows, dtype, device) and kept on the
    device: a forward pass copies nothing from the host."""
    return _stream_gate(tuple(int(m) for m in mask), rows, dtype, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=256)
def _stream_gate(mask: Tuple[int, ...], rows: int, dtype, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode: a training step may
    # multiply a gradient-carrying delta by the same cached gate later
    with torch.inference_mode(False):
        return torch.tensor(mask, dtype=dtype, device=device).repeat_interleave(
            rows // len(mask))


class DenseWithLora(CastLinear):
    """``nn.Linear`` with zero or more statically routed LoRA adapters folded in. The weight,
    bias and adapter factors are cast to the input's dtype at use, so that trained ones may
    be stored in fp32 in a bf16 model."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 adapters: Tuple[LoraSpec, ...] = ()):
        super().__init__(in_features, out_features, bias=bias)
        self.adapters = tuple(adapters)
        for spec in self.adapters:
            setattr(self, f"lora_{spec.name}_A", nn.Parameter(torch.empty(in_features, spec.rank)))
            setattr(self, f"lora_{spec.name}_B", nn.Parameter(torch.zeros(spec.rank, out_features)))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        """A: he_uniform (bound sqrt(6 / in)), B: zeros, as the JAX module."""
        bound = math.sqrt(6.0 / self.in_features)
        for spec in self.adapters:
            a = getattr(self, f"lora_{spec.name}_A")
            a.copy_(torch.rand(a.shape, generator=generator, device=a.device) * 2 * bound - bound)
            getattr(self, f"lora_{spec.name}_B").zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        for spec in self.adapters:
            y = y + lora_delta(x, getattr(self, f"lora_{spec.name}_A"),
                               getattr(self, f"lora_{spec.name}_B"), spec)
        return y


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, spec: LoraSpec) -> torch.Tensor:
    """One adapter's ``(x @ A) @ B * scaling`` in ``x``'s dtype, gated by its stream mask."""
    delta = (x @ a.to(x.dtype)) @ b.to(x.dtype) * spec.scaling
    if spec.streams:
        gate = stream_gate(spec.streams, x.shape[0], x.dtype, x.device)
        delta = delta * gate.view(-1, *(1,) * (x.dim() - 1))
    return delta


# --------------------------------------------------------------------------- attention
_NO_ADAPTERS = {"to_q": (), "to_k": (), "to_v": (), "to_out": ()}


def _projections(module: nn.Module, query_dim: int, inner: int, kv_dim: Optional[int],
                 adapters: Optional[dict]) -> None:
    """to_q/to_k/to_v (no bias) and to_out.0 (diffusers' names), with the LoRA adapters
    ``adapters[projection]`` resolved for each."""
    ad = {**_NO_ADAPTERS, **(adapters or {})}
    module.to_q = DenseWithLora(query_dim, inner, bias=False, adapters=ad["to_q"])
    module.to_k = DenseWithLora(kv_dim or query_dim, inner, bias=False, adapters=ad["to_k"])
    module.to_v = DenseWithLora(kv_dim or query_dim, inner, bias=False, adapters=ad["to_v"])
    module.to_out = nn.ModuleList([DenseWithLora(inner, query_dim, adapters=ad["to_out"])])


class Attention(nn.Module):
    """diffusers ``Attention`` as SVD configures it: no q/k/v bias, output projection with
    bias, scale head_dim^-0.5 (``lkgd_tpu/models/layers.py:133-186``). ``adapters``: LoRA
    specs per projection name (``to_q``, ``to_k``, ``to_v``, ``to_out``)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, kv_dim: Optional[int] = None,
                 adapters: Optional[dict] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        _projections(self, query_dim, heads * dim_head, kv_dim, adapters)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        b, sq = hidden_states.shape[:2]
        if ctx.shape[1] == 1:
            # one key (SVD cross-attention on the CLIP token): softmax over one key is 1,
            # so attention is exactly to_out(v) broadcast over the queries
            out = self.to_out[0](self.to_v(ctx))
            return out.expand(b, sq, out.shape[-1])
        q = self.to_q(hidden_states).view(b, sq, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, ctx.shape[1], self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, ctx.shape[1], self.heads, self.dim_head)
        out = dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(b, sq, self.heads * self.dim_head))


class FrameAxisAttention(nn.Module):
    """Attention over the frame axis of spatial-major ``(B*T, HW, C)`` tokens, parameters
    as :class:`Attention` (``lkgd_tpu/models/layers.py:189-287``), in the token-major form:
    one transpose each way around a ``(B*HW*heads, T, D)`` attention core.

    ``encoder_hidden_states``: None (self-attention over frames), a partner stream of the
    input's own shape ``(B*T, HW, C)`` (joint attention: K and V come from it), or, with
    ``per_sample_ctx=True``, a per-sample ``(B, L, kv_dim)`` context whose L keys every frame
    and pixel of the sample attends to (SVD's CLIP embedding is one token, L = 1).
    ``adapters`` as for :class:`Attention`."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, kv_dim: Optional[int] = None,
                 adapters: Optional[dict] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        _projections(self, query_dim, heads * dim_head, kv_dim, adapters)

    def forward(self, hidden_states: torch.Tensor, num_frames: int,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                per_sample_ctx: bool = False) -> torch.Tensor:
        bt, hw, _ = hidden_states.shape
        b, heads, d = bt // num_frames, self.heads, self.dim_head
        ctx = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        if per_sample_ctx:
            if ctx.shape[1] == 1:
                # one key per sample: attention is to_out(v) broadcast over frames and pixels
                out = self.to_out[0](self.to_v(ctx))  # (B, 1, C)
                out = out[:, None].expand(b, num_frames, hw, out.shape[-1])
                return out.reshape(bt, hw, out.shape[-1])
            # L keys per sample, shared by its frames and pixels (plain torch: the JAX
            # package leaves these einsums to XLA)
            q = self.to_q(hidden_states).view(b, num_frames, hw, heads, d)
            k, v = (p(ctx).view(b, -1, heads, d) for p in (self.to_k, self.to_v))
            logits = torch.einsum("bqphd,blhd->bphql", q.float(), k.float()) * d ** -0.5
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bphql,blhd->bqphd", probs, v)
            return self.to_out[0](out.reshape(bt, hw, heads * d))

        def to_tok(x):
            x = x.view(b, num_frames, hw, heads, d)
            return x.permute(0, 2, 3, 1, 4).reshape(b * hw * heads, num_frames, d)

        qt = to_tok(self.to_q(hidden_states))
        kt, vt = to_tok(self.to_k(ctx)), to_tok(self.to_v(ctx))
        logits = torch.bmm(qt.float(), kt.float().transpose(1, 2)) * d ** -0.5
        probs = torch.softmax(logits, dim=-1).to(vt.dtype)
        out = torch.bmm(probs, vt).view(b, hw, heads, num_frames, d).permute(0, 3, 1, 2, 4)
        return self.to_out[0](out.reshape(bt, hw, heads * d))


# --------------------------------------------------------------------------- feed-forward
class GEGLU(nn.Module):
    def __init__(self, dim_in: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, inner_dim * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf GELU, as the reference


class FeedForward(nn.Module):
    """GEGLU MLP (diffusers ``FeedForward``, activation "geglu", mult 4); ``net.1`` is
    diffusers' parameter-free dropout slot."""

    def __init__(self, dim: int, mult: int = 4, dim_out: Optional[int] = None):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim_out or dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


# --------------------------------------------------------------------------- mixers
class AlphaBlender(nn.Module):
    """Learned scalar spatial/temporal mixer (diffusers ``AlphaBlender``,
    "learned_with_images"): rows flagged in ``image_only_indicator`` mix purely spatially,
    video rows with sigmoid(mix_factor)."""

    def __init__(self, alpha: float = 0.5, switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.alpha = alpha
        self.switch = switch_spatial_to_temporal_mix
        self.mix_factor = nn.Parameter(torch.full((1,), alpha))

    def init_extra(self, generator: torch.Generator) -> None:
        self.mix_factor.fill_(self.alpha)

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor,
                image_only_indicator: torch.Tensor) -> torch.Tensor:
        alpha = torch.where(image_only_indicator.bool(), torch.ones_like(self.mix_factor),
                            torch.sigmoid(self.mix_factor))  # (B, T)
        if x_spatial.dim() == 4:  # (B, T, HW, C) resblock layout
            alpha = alpha[:, :, None, None]
        elif x_spatial.dim() == 3:  # (B*T, HW, C) transformer layout
            alpha = alpha.reshape(-1)[:, None, None]
        else:
            raise ValueError(f"AlphaBlender: unsupported ndim {x_spatial.dim()}")
        alpha = alpha.to(x_spatial.dtype)
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


# --------------------------------------------------------------------------- norms
class AdaLayerNormContinuous(nn.Module):
    """AdaLN with continuous conditioning (the joint branch's ``norm1n`` under
    ``add_norm``): ``LN(x) * (1 + scale) + shift`` with (shift, scale) from a zero-init
    SiLU + Linear on the conditioning embedding; the LayerNorm has no parameters."""

    def __init__(self, embedding_dim: int, conditioning_dim: int):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.linear = ZeroInitLinear(conditioning_dim, 2 * embedding_dim)

    def forward(self, x: torch.Tensor, conditioning: torch.Tensor) -> torch.Tensor:
        shift, scale = self.linear(F.silu(conditioning)).chunk(2, dim=-1)
        h = F.layer_norm(x, (self.embedding_dim,), eps=1e-6)
        return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis with an optional fused SiLU, backed by the
    GroupNorm kernels: ``(N, ..., C)`` is normalised as ``(N, M, C)``."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        y = group_norm(x.reshape(n, -1, c), self.weight, self.bias,
                       num_groups=self.num_groups, eps=self.eps, act=self.act)
        return y.view(x.shape)

