"""Spatio-temporal UNet building blocks of the port (counterpart of
``lkgd_tpu/models/blocks_svd.py``), without joint attention.

LoRA adapters are resolved by the ``LoraRouter`` on the same diffusers-style paths as in
the JAX package (``down_blocks.0.attentions.1.temporal_transformer_blocks.0.attn1``,
``mid_block.attentions.0...``); the temporal blocks' cross-attention takes none, as there.

Layout: hidden states ``(B*T, H, W, C)`` channels-last; temb ``(B*T, temb_channels)``;
image_only_indicator ``(B, T)``; spatial attention tokens ``(B*T, H*W, C)``.

The JAX package's ``Upsample2D`` is nearest-2x followed by a 3x3 convolution; its
``FoldedUpsampleConv`` (the same math on four 2x2 convolutions) is a later optimisation.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.configs import EMPTY_ROUTER, LoraRouter
from lkgd_torch.models.layers import (
    AlphaBlender,
    Attention,
    Conv2d,
    FeedForward,
    FrameAxisAttention,
    GroupNorm,
    TemporalConv,
    TimestepEmbedding,
    get_timestep_embedding,
    nearest_upsample_2x,
)


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


# ------------------------------------------------------------------ transformer blocks
class BasicTransformerBlock(nn.Module):
    """Spatial transformer block: self-attention, cross-attention, GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 1024,
                 lora: LoraRouter = EMPTY_ROUTER, block_path: str = ""):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head, adapters=lora.adapters(f"{block_path}.attn1"))
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, kv_dim=cross_attention_dim,
                               adapters=lora.adapters(f"{block_path}.attn2"))
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), encoder_hidden_states=encoder_hidden_states)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """Temporal transformer block on spatial-major ``(B*T, HW, C)`` tokens: ff_in, frame
    self-attention, per-sample cross-attention, feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 1024,
                 lora: LoraRouter = EMPTY_ROUTER, block_path: str = ""):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = FrameAxisAttention(dim, heads, dim_head,
                                        adapters=lora.adapters(f"{block_path}.attn1"))
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = FrameAxisAttention(dim, heads, dim_head, kv_dim=cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, num_frames: int,
                time_context: torch.Tensor) -> torch.Tensor:
        x = x + self.ff_in(self.norm_in(x))  # is_res: time_mix_inner_dim == dim in SVD
        x = x + self.attn1(self.norm1(x), num_frames)
        x = x + self.attn2(self.norm2(x), num_frames, encoder_hidden_states=time_context,
                           per_sample_ctx=True)
        return x + self.ff(self.norm3(x))


class TransformerSpatioTemporalModel(nn.Module):
    """GroupNorm + proj_in + interleaved spatial/temporal blocks + AlphaBlender + proj_out."""

    def __init__(self, channels: int, num_layers: int, heads: int,
                 cross_attention_dim: int = 1024, lora: LoraRouter = EMPTY_ROUTER,
                 block_path: str = ""):
        super().__init__()
        dim_head = channels // heads
        inner = heads * dim_head
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.time_pos_embed = TimestepEmbedding(inner, inner * 4, out_dim=inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, lora,
                                   f"{block_path}.transformer_blocks.{i}")
             for i in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, lora,
                                           f"{block_path}.temporal_transformer_blocks.{i}")
             for i in range(num_layers)])
        self.time_mixer = AlphaBlender(0.5)  # one blender shared by all layers
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                image_only_indicator: torch.Tensor) -> torch.Tensor:
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
            h = block(h, encoder_hidden_states)
            h_mix = temporal(h + emb, num_frames, time_context)
            h = self.time_mixer(h, h_mix, image_only_indicator)
        return self.proj_out(h).view(bf, hh, ww, c) + x


# ------------------------------------------------------------------ down / mid / up blocks
class CrossAttnDownBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, eps: float,
                 transformer_layers: int, heads: int, cross_attention_dim: int,
                 add_downsample: bool, temb_channels: int, lora: LoraRouter = EMPTY_ROUTER,
                 block_path: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(in_channels if i == 0 else out_channels, out_channels,
                                    temb_channels, eps) for i in range(num_layers)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(out_channels, transformer_layers, heads,
                                            cross_attention_dim, lora,
                                            f"{block_path}.attentions.{i}")
             for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, encoder_hidden_states, image_only_indicator):
        outputs = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = resnet(x, temb, image_only_indicator)
            x = attn(x, encoder_hidden_states, image_only_indicator)
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
                 block_path: str = "mid_block"):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(channels, channels, temb_channels, eps) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(channels, transformer_layers, heads,
                                            cross_attention_dim, lora,
                                            f"{block_path}.attentions.0")])

    def forward(self, x, temb, encoder_hidden_states, image_only_indicator):
        x = self.resnets[0](x, temb, image_only_indicator)
        x = self.attentions[0](x, encoder_hidden_states, image_only_indicator)
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
                 lora: LoraRouter = EMPTY_ROUTER, block_path: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(cin, out_channels, temb_channels, eps)
             for cin in _skip_channels(in_channels, out_channels, prev_output_channels,
                                       num_layers)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(out_channels, transformer_layers, heads,
                                            cross_attention_dim, lora,
                                            f"{block_path}.attentions.{i}")
             for i in range(num_layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, x, res_samples, temb, encoder_hidden_states, image_only_indicator):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = torch.cat([x, res_samples[-1]], dim=-1)
            res_samples = res_samples[:-1]
            x = resnet(x, temb, image_only_indicator)
            x = attn(x, encoder_hidden_states, image_only_indicator)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x
