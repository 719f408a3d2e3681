"""The CogVideoX 3D transformer (DiT) with LKGD latent-knowledge fusion (counterpart of
``lkgd_tpu/models/cogvideox.py``).

Patchified video latents and the T5 text tokens run as one joint ``[text | video]``
stream: adaLN-zero conditioning from the timestep (one LayerNorm shared by both streams),
qk LayerNorm over the head dim, 3D rotary embeddings on the video tokens (1.0 and 1.5) or
3D sincos positions added to them (2b), a GELU-tanh feed-forward, and the quaternion+FFT
knowledge fusion of the T5 context before the patch embedding (zero-init output).

Layout: ``hidden_states`` (B, T, H, W, C) channels-last latents, ``encoder_hidden_states``
(B, L, text_embed_dim). The compute dtype is the constructor's ``dtype`` (the JAX module's
``dtype=``), or where none is given the dtype of the frozen weights (``text_proj``'s);
every layer casts its parameters to it at use, so that trained parameters may stay fp32 in
a bf16 model (LoRA factors, the fusion, or every parameter under a full fine-tune). Under
``config.remat`` each block runs under ``torch.utils.checkpoint`` (non-reentrant) while a
gradient is recorded, the rotary tables and the time embedding passed in as inputs: the
counterpart of ``nn.remat(CogVideoXBlock)``. The rotary tables are built once a forward with the identity
rotation (cos 1, sin 0) over the text prefix and cast to the compute dtype, so every layer
rotates the whole joint sequence. Attention goes through ``ops/attention.py``: the flash
kernels at S >= 1024 (17776 tokens at 49x480x720), the plain form below.

Sequence parallelism (``config.sequence_parallel``, inference only): after the patch
embedding each rank of ``context_group`` (the process group of the mesh's ``sp_axis``, which
the pipeline built with ``mesh=`` sets) keeps its Sv/P video tokens and the
matching rows of the rotary tables, the text stream replicated; every block runs on these
tokens and only the attention communicates (``parallel/sequence.py`` ``joint_sp_attention``);
the video tokens are gathered after ``proj_out`` (the final norms act token by token), before
the unpatchify. GSPMD does this split implicitly in the JAX module.

Pipeline parallelism: ``forward(..., blocks_override=)`` runs a callable in the place of the
block loop, as the JAX module's ``blocks_override`` does (``parallel/pp.py``
``cogvideox_pp_blocks``: the blocks split over the mesh's ``stage`` axis, GPipe-style).

Parameter names are diffusers' ``CogVideoXTransformer3DModel`` names as the JAX package's
``cogvideox_export_key_map`` writes them (``transformer_blocks.{i}.attn1.to_q``,
``norm1.linear``, ``ff.net.0.proj``, ``patch_embed.proj``, ``norm_out.linear``, and
``quaternion_lora_*`` for the fusion), so a JAX export loads with
``load_state_dict(strict=True)``. The fusion lives at ``knowledge_fusion`` in the module
tree; its state-dict names are renamed to ``quaternion_lora_*`` on the way out and back.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.configs import CogVideoXConfig
from torch.utils.checkpoint import checkpoint

from lkgd_torch.models.layers import (CastLinear, Conv2d, DenseWithLora, TimestepEmbedding,
                                      get_timestep_embedding)
from lkgd_torch.ops.attention import dot_product_attention
from lkgd_torch.ops.fusion import LatentKnowledgeFusion
from lkgd_torch.parallel import sequence

_FUSION, _EXPORTED = "knowledge_fusion.", "quaternion_lora_"


def rope_3d(num_frames: int, height: int, width: int, head_dim: int, theta: float = 10000.0,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D rotary embedding (diffusers ``get_3d_rotary_pos_embed``): the head dim split into
    (t, h, w) parts of (d/4, 3d/8, 3d/8), interleaved pairs. Returns fp32 (cos, sin), each
    (T*H*W, head_dim)."""
    dims = (head_dim // 4, head_dim * 3 // 8, head_dim * 3 // 8)
    sizes = (num_frames, height, width)

    def freqs(n, dim):
        inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                               / dim))
        f = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv)
        return f.repeat_interleave(2, dim=-1)  # (n, dim)

    parts = []
    for axis, (n, dim) in enumerate(zip(sizes, dims)):
        shape = [1, 1, 1, dim]
        shape[axis] = n
        parts.append(freqs(n, dim).view(shape).expand(*sizes, dim))
    f = torch.cat(parts, dim=-1).reshape(-1, head_dim)
    return torch.cos(f), torch.sin(f)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D) with interleaved pairs, in x's dtype."""
    rot = torch.stack((-x[..., 1::2], x[..., 0::2]), dim=-1).flatten(-2)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def _sincos_1d(dim: int, pos) -> np.ndarray:
    omega = 1.0 / (10000.0 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)))
    out = np.asarray(pos, np.float64)[:, None] * omega[None]
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_3d(dim: int, t: int, h: int, w: int, spatial_scale: float = 1.875,
                        temporal_scale: float = 1.0) -> torch.Tensor:
    """3D sincos positions (t*h*w, dim) fp32 for CogVideoX-2b (diffusers
    ``get_3d_sincos_pos_embed``): 3/4 of the dim for the (h, w) grid (half each, in
    diffusers' meshgrid order), 1/4 for time; grids divided by the interpolation scales."""
    dim_sp, dim_t = 3 * dim // 4, dim // 4
    gw, gh = np.meshgrid(np.arange(w) / spatial_scale, np.arange(h) / spatial_scale)
    spatial = np.concatenate([_sincos_1d(dim_sp // 2, gw.reshape(-1)),
                              _sincos_1d(dim_sp // 2, gh.reshape(-1))], axis=1)
    temporal = _sincos_1d(dim_t, np.arange(t) / temporal_scale)
    pos = np.concatenate([np.repeat(temporal[:, None, :], h * w, axis=1),
                          np.repeat(spatial[None, :, :], t, axis=0)], axis=2)
    return torch.from_numpy(pos.reshape(t * h * w, dim).astype(np.float32))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with its scale and bias cast to the input's dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class CastConv2d(Conv2d):
    """The channels-last :class:`Conv2d` with its weight and bias cast to the input's
    dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class CogVideoXLayerNormZero(nn.Module):
    """adaLN-zero: (shift, scale, gate) for the video and the text stream from one linear
    on SiLU(temb), one LayerNorm (eps 1e-5) shared by both streams."""

    def __init__(self, conditioning_dim: int, dim: int):
        super().__init__()
        self.linear = CastLinear(conditioning_dim, 6 * dim)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, hidden, encoder, temb):
        shift, scale, gate, e_shift, e_scale, e_gate = (
            self.linear(F.silu(temb))[:, None].chunk(6, dim=-1))
        hidden = self.norm(hidden) * (1 + scale) + shift
        encoder = self.norm(encoder) * (1 + e_scale) + e_shift
        return hidden, encoder, gate, e_gate


class CogVideoXAttention(nn.Module):
    """Joint text+video attention with qk LayerNorm (eps 1e-6) over the head dim and the
    rotary tables applied to the whole joint sequence (diffusers
    ``CogVideoXAttnProcessor2_0``). ``adapters``: LoRA specs per projection."""

    def __init__(self, config: CogVideoXConfig, adapters: dict):
        super().__init__()
        inner, hd = config.inner_dim, config.attention_head_dim
        self.heads, self.head_dim = config.num_attention_heads, hd
        self.sequence_parallel = config.sequence_parallel
        self.to_q = DenseWithLora(inner, inner, adapters=adapters["to_q"])
        self.to_k = DenseWithLora(inner, inner, adapters=adapters["to_k"])
        self.to_v = DenseWithLora(inner, inner, adapters=adapters["to_v"])
        self.norm_q = LayerNorm(hd, eps=1e-6)
        self.norm_k = LayerNorm(hd, eps=1e-6)
        self.to_out = nn.ModuleList([DenseWithLora(inner, inner, adapters=adapters["to_out"])])

    def forward(self, x: torch.Tensor, rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                text_len: int = 0, pg=None):
        """x: the joint (B, S, inner) stream, ``text_len`` text tokens first (under sequence
        parallelism the video tokens of this rank's shard of ``pg``); rope: (S, D) tables in
        x's dtype or None."""
        b, s, _ = x.shape
        # -1: the heads this rank's projections give (all, or H/P under tensor parallelism)
        q = self.norm_q(self.to_q(x).view(b, s, -1, self.head_dim))
        k = self.norm_k(self.to_k(x).view(b, s, -1, self.head_dim))
        v = self.to_v(x).view(b, s, -1, self.head_dim)
        if rope is not None:
            q, k = apply_rotary(q, *rope), apply_rotary(k, *rope)
        if pg is not None:
            out = sequence.joint_sp_attention(q, k, v, text_len, self.sequence_parallel, pg)
        else:
            out = dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(b, s, -1))


class GELUProj(nn.Module):
    """diffusers ``GELU`` with ``approximate="tanh"``: ``gelu_tanh(proj(x))``."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = CastLinear(dim_in, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """diffusers ``FeedForward`` with ``gelu-approximate``, mult 4; ``net.1`` is the
    parameter-free dropout slot."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, 4 * dim), nn.Identity(), CastLinear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class CogVideoXBlock(nn.Module):
    def __init__(self, config: CogVideoXConfig, path: str):
        super().__init__()
        inner = config.inner_dim
        self.norm1 = CogVideoXLayerNormZero(config.time_embed_dim, inner)
        self.attn1 = CogVideoXAttention(config, config.lora.adapters(f"{path}.attn1"))
        self.norm2 = CogVideoXLayerNormZero(config.time_embed_dim, inner)
        self.ff = FeedForward(inner)

    def forward(self, hidden, encoder, temb, rope, pg=None):
        text_len = encoder.shape[1]
        nh, ne, gate, e_gate = self.norm1(hidden, encoder, temb)
        attn = self.attn1(torch.cat([ne, nh], dim=1), rope, text_len, pg)
        hidden = hidden + gate * attn[:, text_len:]
        encoder = encoder + e_gate * attn[:, :text_len]
        nh, ne, gate, e_gate = self.norm2(hidden, encoder, temb)
        h = self.ff(torch.cat([ne, nh], dim=1))
        return hidden + gate * h[:, text_len:], encoder + e_gate * h[:, :text_len]


class PatchEmbed(nn.Module):
    """``proj``: a p x p stride-p convolution per frame (1.0) or a linear over
    (pt, p, p, C) patches (1.5); ``text_proj``: the T5 width to the inner width."""

    def __init__(self, config: CogVideoXConfig):
        super().__init__()
        p, pt, inner = config.patch_size, config.patch_size_t, config.inner_dim
        self.proj = (CastConv2d(config.in_channels, inner, p, stride=p) if pt is None
                     else CastLinear(pt * p * p * config.in_channels, inner))
        self.text_proj = CastLinear(config.text_embed_dim, inner)


class NormOut(nn.Module):
    """The final adaLN: (shift, scale) from a linear on SiLU(temb) around a LayerNorm
    without parameters (eps 1e-5)."""

    def __init__(self, conditioning_dim: int, dim: int):
        super().__init__()
        self.dim = dim
        self.linear = CastLinear(conditioning_dim, 2 * dim)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        shift, scale = self.linear(F.silu(temb))[:, None].chunk(2, dim=-1)
        return F.layer_norm(x, (self.dim,), eps=1e-5) * (1 + scale) + shift


class CogVideoXTransformer3D(nn.Module):
    """``dtype``: the compute dtype; None computes in the dtype of the frozen weights."""

    def __init__(self, config: CogVideoXConfig = CogVideoXConfig(),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype = dtype
        # the process group the video tokens split over under sequence parallelism
        self.context_group = None
        inner = cfg.inner_dim
        self.time_embedding = TimestepEmbedding(inner, cfg.time_embed_dim)
        self.knowledge_fusion = None
        if cfg.knowledge_fusion:
            d = min(256, cfg.text_embed_dim // 4)  # 256 at full width
            self.knowledge_fusion = LatentKnowledgeFusion(
                ctx_dim=cfg.text_embed_dim, knowledge_dim=max(1024 * d // 256, 4 * d),
                compress_dim=d, sf_hidden=2 * d, zero_init_output=True)
            self._register_state_dict_hook(_fusion_names_out)
            self._register_load_state_dict_pre_hook(_fusion_names_in)
        self.patch_embed = PatchEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(
            [CogVideoXBlock(cfg, f"transformer_blocks.{i}") for i in range(cfg.num_layers)])
        self.norm_final = LayerNorm(inner, eps=1e-5)
        self.norm_out = NormOut(cfg.time_embed_dim, inner)
        p, pt = cfg.patch_size, cfg.patch_size_t or 1
        self.proj_out = CastLinear(inner, pt * p * p * cfg.out_channels)

    def _embed_video(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, t, h, w, c = x.shape
        p, pt = cfg.patch_size, cfg.patch_size_t
        if pt is None:
            video = self.patch_embed.proj(x.reshape(b * t, h, w, c))
            return video.reshape(b, t * (h // p) * (w // p), cfg.inner_dim)
        if t % pt:
            raise ValueError(f"{t} latent frames not a multiple of patch_size_t={pt} (pad "
                             f"the latent clip: the pipeline does this)")
        # feature order (pt, p, p, c), token order (t/pt, h/p, w/p)
        v = x.reshape(b, t // pt, pt, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        return self.patch_embed.proj(v.reshape(b, -1, pt * p * p * c))

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                timestep, domain_features: Optional[torch.Tensor] = None,
                flow_features: Optional[torch.Tensor] = None,
                blocks_override: Optional[Callable] = None) -> torch.Tensor:
        """``blocks_override(hidden, encoder, emb, rope) -> (hidden, encoder)``, given, runs in
        the place of the block loop (``parallel/pp.py`` ``cogvideox_pp_blocks``: the blocks as
        a pipeline over the mesh's ``stage`` axis), as in the JAX module; not with sequence
        parallelism, which JAX never combines with it."""
        cfg = self.config
        if blocks_override is not None and cfg.sequence_parallel != "none":
            raise ValueError("blocks_override with sequence_parallel: the pipeline's stages "
                             "run whole sequences (ROADMAP.md Queue 3, 'blocks_override')")
        dtype = self.compute_dtype or self.patch_embed.text_proj.weight.dtype
        b, t, h, w, _ = hidden_states.shape
        p, pt = cfg.patch_size, cfg.patch_size_t
        device = hidden_states.device

        timestep = torch.as_tensor(timestep, device=device).reshape(-1).expand(b)
        emb = self.time_embedding(get_timestep_embedding(timestep, cfg.inner_dim).to(dtype))

        context = encoder_hidden_states.to(dtype)
        if self.knowledge_fusion is not None:
            context = self.knowledge_fusion(context, domain_features, flow_features,
                                            dtype=dtype)

        video = self._embed_video(hidden_states.to(dtype))
        text = self.patch_embed.text_proj(context.to(dtype))
        tokens = (t // (pt or 1), h // p, w // p)
        rope = None
        if cfg.use_rope:
            cos, sin = rope_3d(*tokens, cfg.attention_head_dim, device=device)
            text_len = text.shape[1]
            # the identity rotation over the text prefix, once for every layer
            rope = (F.pad(cos, (0, 0, text_len, 0), value=1.0).to(dtype),
                    F.pad(sin, (0, 0, text_len, 0)).to(dtype))
        else:  # 2b: sincos positions added to the video tokens
            pos = sincos_pos_embed_3d(cfg.inner_dim, *tokens, cfg.spatial_interpolation_scale,
                                      cfg.temporal_interpolation_scale)
            video = video + pos.to(device, dtype)[None]

        pg = None
        if cfg.sequence_parallel != "none":
            pg = self.context_group
            if pg is None:
                raise RuntimeError(f"sequence_parallel={cfg.sequence_parallel!r} needs the "
                                   f"transformer's context_group: build the pipeline with a "
                                   f"mesh= that has a {cfg.sp_axis!r} axis")
            video, rope = _shard_tokens(video, rope, text.shape[1], pg)

        hidden, encoder = video, text
        remat = cfg.remat and torch.is_grad_enabled()
        if blocks_override is not None:
            hidden, encoder = blocks_override(hidden, encoder, emb, rope)
        else:
            for block in self.transformer_blocks:
                if remat:
                    hidden, encoder = checkpoint(block, hidden, encoder, emb, rope, pg,
                                                 use_reentrant=False)
                else:
                    hidden, encoder = block(hidden, encoder, emb, rope, pg)

        # norm_final acts token by token: the text rows it would also normalise are dropped
        hidden = self.proj_out(self.norm_out(self.norm_final(hidden), emb))
        if pg is not None:
            hidden = sequence.all_gather(hidden, 1, pg)

        c = cfg.out_channels
        if pt is None:  # inverse of the embed's (p, p, C) feature order
            out = hidden.reshape(b, t, h // p, w // p, p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        else:
            out = hidden.reshape(b, t // pt, h // p, w // p, pt, p, p, c)
            out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return out.reshape(b, t, h, w, c)


def _shard_tokens(video: torch.Tensor, rope, text_len: int, pg):
    """This rank's Sv/P video tokens (B, Sv, inner) and the rows of the rotary tables
    (text prefix, then the video) that go with them."""
    p, i = dist.get_world_size(pg), dist.get_rank(pg)
    sv = video.shape[1]
    if sv % p:
        raise ValueError(f"sequence parallelism splits the {sv} video tokens over the {p} "
                         f"ranks: {sv} does not divide by {p} (49 frames at 480x720 give "
                         f"13 x 30 x 45 = 17550 tokens: 2, 3, 5 or 6 ranks)")
    n = sv // p
    video = video[:, i * n:(i + 1) * n]
    if rope is not None:
        rope = tuple(torch.cat([x[:text_len], x[text_len + i * n:text_len + (i + 1) * n]])
                     for x in rope)
    return video, rope


def _exported_name(name: str) -> str:
    """``knowledge_fusion.fuse_sf_0.weight`` -> ``quaternion_lora_fuse_sf.0.weight``."""
    name = name[len(_FUSION):].replace("fuse_sf_0", "fuse_sf.0").replace("fuse_sf_2", "fuse_sf.2")
    return _EXPORTED + name


def _module_name(name: str) -> str:
    name = name[len(_EXPORTED):].replace("fuse_sf.0", "fuse_sf_0").replace("fuse_sf.2", "fuse_sf_2")
    return _FUSION + name


def _fusion_names_out(module, state_dict, prefix, local_metadata):
    for key in [k for k in state_dict if k.startswith(prefix + _FUSION)]:
        state_dict[prefix + _exported_name(key[len(prefix):])] = state_dict.pop(key)


def _fusion_names_in(state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                     error_msgs):
    for key in [k for k in state_dict if k.startswith(prefix + _EXPORTED)]:
        state_dict[prefix + _module_name(key[len(prefix):])] = state_dict.pop(key)

