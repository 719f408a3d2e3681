"""Spatio-temporal UNet building blocks of the port (counterpart of
``lkgd_tpu/models/blocks_svd.py``), with the joint x<->y stream attention of the spatial
and temporal transformer blocks.

The joint branch's parameters sit directly on the transformer block under diffusers'
names (``attn1n``, ``conv1n`` | ``scale1n``, ``norm1n``), with no scope of their own: the
JAX exporter drops its ``joint.`` scope, and the exported state dicts load here with
``strict=True``.

LoRA adapters are resolved by the ``LoraRouter`` on the same diffusers-style paths as in
the JAX package (``down_blocks.0.attentions.1.temporal_transformer_blocks.0.attn1``,
``mid_block.attentions.0...``); the temporal blocks' cross-attention takes none, as there.

Layout: hidden states ``(B*T, H, W, C)`` channels-last; temb ``(B*T, temb_channels)``;
image_only_indicator ``(B, T)``; spatial attention tokens ``(B*T, H*W, C)``.

The JAX package's ``Upsample2D`` is nearest-2x followed by a 3x3 convolution; its
``FoldedUpsampleConv`` (the same math on four 2x2 convolutions) is a later optimisation.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.configs import EMPTY_ROUTER, JointAttentionConfig, LoraRouter
from lkgd_torch.models.layers import (
    AdaLayerNormContinuous,
    AlphaBlender,
    Attention,
    Conv2d,
    FeedForward,
    FrameAxisAttention,
    GroupNorm,
    TemporalConv,
    TimestepEmbedding,
    ZeroInitConv2d,
    ZeroInitLinear,
    get_timestep_embedding,
    nearest_upsample_2x,
)
from lkgd_torch.ops.track_fusion import track_scatter_fusion


# ------------------------------------------------------------------ resnet blocks
class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D (pre-norm, SiLU, 3x3 convs, temb added after conv1)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int = 1280,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, eps, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, 32, eps, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TemporalResnetBlock(nn.Module):
    """diffusers TemporalResnetBlock: (3,1,1) convs over frames. Input ``(B, T, H*W, C)``,
    temb ``(B, T, temb_channels)``; GroupNorm statistics per sample over all frames."""

    def __init__(self, channels: int, temb_channels: int = 1280, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(channels, 32, eps, act="silu")
        self.conv1 = TemporalConv(channels, channels)
        self.time_emb_proj = nn.Linear(temb_channels, channels)
        self.norm2 = GroupNorm(channels, 32, eps, act="silu")
        self.conv2 = TemporalConv(channels, channels)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, :]
        return x + self.conv2(self.norm2(h))


class SpatioTemporalResBlock(nn.Module):
    """Spatial ResBlock + temporal ResBlock + learned AlphaBlender."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int = 1280,
                 eps: float = 1e-5):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels, temb_channels, eps)
        self.temporal_res_block = TemporalResnetBlock(out_channels, temb_channels, eps)
        self.time_mixer = AlphaBlender(0.5, switch_spatial_to_temporal_mix=True)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                image_only_indicator: torch.Tensor) -> torch.Tensor:
        num_frames = image_only_indicator.shape[-1]
        h = self.spatial_res_block(x, temb)
        bf, hh, ww, c = h.shape
        b = bf // num_frames
        h_t = h.view(b, num_frames, hh * ww, c)
        mix = self.temporal_res_block(h_t, temb.view(b, num_frames, temb.shape[-1]))
        return self.time_mixer(h_t, mix, image_only_indicator).view(bf, hh, ww, c)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


# ------------------------------------------------------------------ joint attention
def _partner_streams(x: torch.Tensor, joint: JointAttentionConfig, num_frames: int,
                     flip_frames: bool) -> torch.Tensor:
    """The partner-stream context of ``x`` ``(rows, N, C)``, rows stream-major: stream
    blocks swapped per the static mask and, with ``flip_frames`` and ``joint.flip``, the
    frame axis reversed (frames are innermost in a stream's ``B*T`` rows). Built from
    views, ``flip`` and ``stack`` alone: no index tensor, nothing copied from the host."""
    s = len(joint.mask)
    rows, n, c = x.shape
    perm = joint.partner_perm
    # alternating masks pair adjacent streams: the swap is the reverse of a size-2 axis
    pair_swap = all(p == i ^ 1 for i, p in enumerate(perm))
    if flip_frames and joint.flip:
        if pair_swap:
            xr = x.reshape(s // 2, 2, rows // s // num_frames, num_frames, n, c).flip(1, 3)
        else:
            xr = x.reshape(s, rows // s // num_frames, num_frames, n, c)
            xr = torch.stack([xr[p] for p in perm]).flip(2)
    elif pair_swap:
        xr = x.reshape(s // 2, 2, rows // s, n, c).flip(1)
    else:
        xr = x.reshape(s, rows // s, n, c)
        xr = torch.stack([xr[p] for p in perm])
    return xr.reshape(rows, n, c)


class JointBranchMixin:
    """``attn1n`` + a zero-init post projection (``conv`` | ``scale`` | ``conv_fuse``), with
    an optional AdaLN ``norm1n`` in front (``add_norm``). The branch's modules are
    registered on the block that mixes this in. ``temporal=True``: the branch of a temporal
    transformer block, where tokens stay ``(B*T, HW, C)`` and ``attn1n`` contracts the
    frame axis. The K and V adapters of ``attn1n`` act on the partner stream and take
    inverted stream masks; Q and ``to_out`` do not."""

    def _init_joint(self, dim: int, heads: int, dim_head: int, joint: JointAttentionConfig,
                    block_path: str, lora: LoraRouter, temporal: bool,
                    temb_channels: int) -> None:
        self.joint, self.joint_temporal = joint, temporal
        if joint.add_norm:
            self.norm1n = AdaLayerNormContinuous(dim, temb_channels)
        attention = FrameAxisAttention if temporal else Attention
        self.attn1n = attention(dim, heads, dim_head,
                                adapters=lora.adapters(f"{block_path}.attn1n", invert_kv=True))
        if joint.post == "conv":
            self.conv1n = ZeroInitLinear(dim, dim, bias=False)
        elif joint.post == "scale":
            self.scale1n = nn.Parameter(torch.zeros(1, 1, dim))
        else:  # conv_fuse: one linear over the x rows and y rows side by side
            self.conv1n = ZeroInitLinear(2 * dim, 2 * dim, bias=False)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if hasattr(self, "scale1n"):
            self.scale1n.zero_()

    def _joint_branch(self, norm_hidden_states: torch.Tensor, num_frames: int,
                      flip_frames: bool, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        joint, x = self.joint, norm_hidden_states
        if joint.add_norm:
            if temb is None:
                raise ValueError("add_norm joint attention requires temb conditioning")
            x = self.norm1n(x, temb)
        partner = _partner_streams(x, joint, num_frames, flip_frames)
        if self.joint_temporal:
            out = self.attn1n(x, num_frames, encoder_hidden_states=partner)
        else:
            out = self.attn1n(x, encoder_hidden_states=partner)
        if joint.post == "conv":
            return self.conv1n(out)
        if joint.post == "scale":
            return out * self.scale1n.to(out.dtype)
        # conv_fuse: the y-stream rows beside the x-stream rows featurewise through one
        # linear, and each half back to its streams
        s = len(joint.mask)
        rows, n, c = out.shape
        blocks = out.reshape(s, rows // s, n, c)
        ones = [i for i, m in enumerate(joint.mask) if m]
        zeros = [i for i, m in enumerate(joint.mask) if not m]
        x_part = torch.cat([blocks[i] for i in ones])
        y_part = torch.cat([blocks[i] for i in zeros])
        fx, fy = self.conv1n(torch.cat([x_part, y_part], dim=-1)).chunk(2, dim=-1)
        fx, fy = fx.reshape(len(ones), rows // s, n, c), fy.reshape(len(zeros), rows // s, n, c)
        fused = [None] * s
        for j, i in enumerate(ones):
            fused[i] = fx[j]
        for j, i in enumerate(zeros):
            fused[i] = fy[j]
        return torch.stack(fused).reshape(rows, n, c)


class JointAttentionBranch(nn.Module, JointBranchMixin):
    """The joint branch alone (counterpart of the JAX ``JointAttentionBranch``)."""

    def __init__(self, dim: int, heads: int, dim_head: int, joint: JointAttentionConfig,
                 block_path: str, lora: LoraRouter = EMPTY_ROUTER, temporal: bool = False,
                 temb_channels: int = 1280):
        super().__init__()
        self._init_joint(dim, heads, dim_head, joint, block_path, lora, temporal, temb_channels)

    def forward(self, norm_hidden_states: torch.Tensor, num_frames: int, flip_frames: bool,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._joint_branch(norm_hidden_states, num_frames, flip_frames, temb)


# ------------------------------------------------------------------ transformer blocks
class BasicTransformerBlock(nn.Module, JointBranchMixin):
    """Spatial transformer block: self-attention (plus the joint branch, scaled by
    ``joint_scale``), cross-attention, GEGLU feed-forward. With ``track_fusion`` (the 2D
    UNet's joint-frame pairs), ``tracks=(src_idx, dst_idx, visibility)`` given to the
    forward fuse the paired frames after self-attention through a zero-init 3x3
    ``conv_fuse`` (2*dim -> 2*dim) on the ``spatial_hw`` grid (``ops/track_fusion.py``)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 1024,
                 lora: LoraRouter = EMPTY_ROUTER, block_path: str = "",
                 joint: Optional[JointAttentionConfig] = None, temb_channels: int = 1280,
                 track_fusion: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head, adapters=lora.adapters(f"{block_path}.attn1"))
        self.has_joint = joint is not None and joint.spatial
        if self.has_joint:
            self._init_joint(dim, heads, dim_head, joint, block_path, lora, False, temb_channels)
        if track_fusion:
            self.conv_fuse = ZeroInitConv2d(2 * dim, 2 * dim, 3, padding=1)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, kv_dim=cross_attention_dim,
                               adapters=lora.adapters(f"{block_path}.attn2"))
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                num_frames: int = 1, joint_scale=1.0,
                temb: Optional[torch.Tensor] = None, tracks=None,
                spatial_hw: Optional[tuple] = None) -> torch.Tensor:
        norm_x = self.norm1(x)
        attn_out = self.attn1(norm_x)
        if self.has_joint:
            attn_out = attn_out + self._joint_branch(norm_x, num_frames, True, temb) * joint_scale
        x = x + attn_out
        if tracks is not None and hasattr(self, "conv_fuse"):
            src_idx, dst_idx, visibility = tracks
            x = track_scatter_fusion(x, src_idx, dst_idx, visibility, self.conv_fuse,
                                     *spatial_hw)
        x = x + self.attn2(self.norm2(x), encoder_hidden_states=encoder_hidden_states)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module, JointBranchMixin):
    """Temporal transformer block on spatial-major ``(B*T, HW, C)`` tokens: ff_in, frame
    self-attention (plus the joint branch, added unscaled: ``joint_scale`` acts on the
    spatial path only, as in the JAX package), per-sample cross-attention, feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 1024,
                 lora: LoraRouter = EMPTY_ROUTER, block_path: str = "",
                 joint: Optional[JointAttentionConfig] = None, temb_channels: int = 1280):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = FrameAxisAttention(dim, heads, dim_head,
                                        adapters=lora.adapters(f"{block_path}.attn1"))
        self.has_joint = joint is not None and joint.temporal
        if self.has_joint:
            self._init_joint(dim, heads, dim_head, joint, block_path, lora, True, temb_channels)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = FrameAxisAttention(dim, heads, dim_head, kv_dim=cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, num_frames: int,
                time_context: torch.Tensor) -> torch.Tensor:
        x = x + self.ff_in(self.norm_in(x))  # is_res: time_mix_inner_dim == dim in SVD
        norm_x = self.norm1(x)
        attn_out = self.attn1(norm_x, num_frames)
        if self.has_joint:  # the temporal branch takes no temb: add_norm cannot be met here
            attn_out = attn_out + self._joint_branch(norm_x, num_frames, False)
        x = x + attn_out
        x = x + self.attn2(self.norm2(x), num_frames, encoder_hidden_states=time_context,
                           per_sample_ctx=True)
        return x + self.ff(self.norm3(x))


class TransformerSpatioTemporalModel(nn.Module):
    """GroupNorm + proj_in + interleaved spatial/temporal blocks + AlphaBlender + proj_out."""

    def __init__(self, channels: int, num_layers: int, heads: int,
                 cross_attention_dim: int = 1024, lora: LoraRouter = EMPTY_ROUTER,
                 block_path: str = "", joint: Optional[JointAttentionConfig] = None,
                 temb_channels: int = 1280):
        super().__init__()
        dim_head = channels // heads
        inner = heads * dim_head
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.time_pos_embed = TimestepEmbedding(inner, inner * 4, out_dim=inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, lora,
                                   f"{block_path}.transformer_blocks.{i}", joint, temb_channels)
             for i in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, lora,
                                           f"{block_path}.temporal_transformer_blocks.{i}",
                                           joint, temb_channels)
             for i in range(num_layers)])
        self.time_mixer = AlphaBlender(0.5)  # one blender shared by all layers
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                image_only_indicator: torch.Tensor, joint_scale=1.0,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        bf, hh, ww, c = x.shape
        num_frames = image_only_indicator.shape[-1]
        b = bf // num_frames
        # first-frame context per sample, consumed per sample by the temporal blocks
        ctx = encoder_hidden_states
        time_context = ctx.view(b, num_frames, *ctx.shape[1:])[:, 0]

        h = self.proj_in(self.norm(x).view(bf, hh * ww, c))
        frame_ids = torch.arange(num_frames, dtype=torch.float32, device=x.device).repeat(b)
        emb = self.time_pos_embed(get_timestep_embedding(frame_ids, h.shape[-1]).to(h.dtype))
        emb = emb[:, None, :]
        for block, temporal in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = block(h, encoder_hidden_states, num_frames, joint_scale, temb)
            h_mix = temporal(h + emb, num_frames, time_context)
            h = self.time_mixer(h, h_mix, image_only_indicator)
        return self.proj_out(h).view(bf, hh, ww, c) + x


# ------------------------------------------------------------------ down / mid / up blocks
class CrossAttnDownBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, eps: float,
                 transformer_layers: int, heads: int, cross_attention_dim: int,
                 add_downsample: bool, temb_channels: int, lora: LoraRouter = EMPTY_ROUTER,
                 block_path: str = "", joint: Optional[JointAttentionConfig] = None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(in_channels if i == 0 else out_channels, out_channels,
                                    temb_channels, eps) for i in range(num_layers)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(out_channels, transformer_layers, heads,
                                            cross_attention_dim, lora,
                                            f"{block_path}.attentions.{i}", joint, temb_channels)
             for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, encoder_hidden_states, image_only_indicator, joint_scale=1.0):
        outputs = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = resnet(x, temb, image_only_indicator)
            x = attn(x, encoder_hidden_states, image_only_indicator, joint_scale, temb)
            outputs.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, tuple(outputs)


class DownBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, eps: float,
                 add_downsample: bool, temb_channels: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(in_channels if i == 0 else out_channels, out_channels,
                                    temb_channels, eps) for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, image_only_indicator):
        outputs = []
        for resnet in self.resnets:
            x = resnet(x, temb, image_only_indicator)
            outputs.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, tuple(outputs)


class UNetMidBlockSpatioTemporal(nn.Module):
    def __init__(self, channels: int, transformer_layers: int, eps: float, heads: int,
                 cross_attention_dim: int, temb_channels: int, lora: LoraRouter = EMPTY_ROUTER,
                 block_path: str = "mid_block", joint: Optional[JointAttentionConfig] = None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(channels, channels, temb_channels, eps) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(channels, transformer_layers, heads,
                                            cross_attention_dim, lora,
                                            f"{block_path}.attentions.0", joint, temb_channels)])

    def forward(self, x, temb, encoder_hidden_states, image_only_indicator, joint_scale=1.0):
        x = self.resnets[0](x, temb, image_only_indicator)
        x = self.attentions[0](x, encoder_hidden_states, image_only_indicator, joint_scale, temb)
        return self.resnets[1](x, temb, image_only_indicator)


def _skip_channels(in_channels: int, out_channels: int, prev_output_channels: int,
                   num_layers: int) -> List[int]:
    """(resnet input channels) of an up block: the running x concatenated with the skip
    popped from the down path (diffusers' up-block wiring)."""
    chans = []
    for i in range(num_layers):
        skip = in_channels if i == num_layers - 1 else out_channels
        x_in = prev_output_channels if i == 0 else out_channels
        chans.append(x_in + skip)
    return chans


class UpBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, prev_output_channels: int,
                 num_layers: int, eps: float, add_upsample: bool, temb_channels: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(cin, out_channels, temb_channels, eps)
             for cin in _skip_channels(in_channels, out_channels, prev_output_channels,
                                       num_layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, x, res_samples, temb, image_only_indicator):
        for resnet in self.resnets:
            x = torch.cat([x, res_samples[-1]], dim=-1)
            res_samples = res_samples[:-1]
            x = resnet(x, temb, image_only_indicator)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class CrossAttnUpBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, prev_output_channels: int,
                 num_layers: int, eps: float, transformer_layers: int, heads: int,
                 cross_attention_dim: int, add_upsample: bool, temb_channels: int,
                 lora: LoraRouter = EMPTY_ROUTER, block_path: str = "",
                 joint: Optional[JointAttentionConfig] = None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(cin, out_channels, temb_channels, eps)
             for cin in _skip_channels(in_channels, out_channels, prev_output_channels,
                                       num_layers)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(out_channels, transformer_layers, heads,
                                            cross_attention_dim, lora,
                                            f"{block_path}.attentions.{i}", joint, temb_channels)
             for i in range(num_layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, x, res_samples, temb, encoder_hidden_states, image_only_indicator,
                joint_scale=1.0):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = torch.cat([x, res_samples[-1]], dim=-1)
            res_samples = res_samples[:-1]
            x = resnet(x, temb, image_only_indicator)
            x = attn(x, encoder_hidden_states, image_only_indicator, joint_scale, temb)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x
