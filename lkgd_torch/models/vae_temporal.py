"""AutoencoderKL with a temporal decoder, the SVD video VAE (counterpart of
``lkgd_tpu/models/vae_temporal.py``), with diffusers' ``AutoencoderKLTemporalDecoder``
parameter names.

Channels-last: ``encode_mode`` (B*T, H, W, 3) -> (B*T, h, w, 4); ``decode``
(B*T, h, w, 4) -> (B*T, H, W, 3). The mid-block attention is one head of width 512 over
H*W/64 tokens (9216 at 576x1024), which the flash kernels carry.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.configs import TemporalVAEConfig
from lkgd_torch.models.layers import (
    Conv2d,
    GroupNorm,
    TemporalConv,
    nearest_upsample_2x,
)
from lkgd_torch.ops.attention import dot_product_attention


class VAEResnetBlock(nn.Module):
    """ResnetBlock2D without time embedding (VAE flavour, eps 1e-6)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, 1e-6, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels, 32, 1e-6, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAETemporalPart(nn.Module):
    """The temporal half of a decoder resblock: (3,1,1) convs over frames, eps 1e-5.
    Input (B, T, HW, C)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm1 = GroupNorm(channels, 32, 1e-5, act="silu")
        self.conv1 = TemporalConv(channels, channels)
        self.norm2 = GroupNorm(channels, 32, 1e-5, act="silu")
        self.conv2 = TemporalConv(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.norm2(self.conv1(self.norm1(x))))


class VAEMixer(nn.Module):
    """diffusers' AlphaBlender with merge_strategy "learned": alpha = sigmoid(mix_factor),
    initialised at 0."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def init_extra(self, generator: torch.Generator) -> None:
        self.mix_factor.zero_()

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor) -> torch.Tensor:
        alpha = torch.sigmoid(self.mix_factor).to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class VAETemporalResnetBlock(nn.Module):
    """Spatial + temporal resblock pair with a learned blender."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.spatial_res_block = VAEResnetBlock(in_channels, out_channels)
        self.temporal_res_block = VAETemporalPart(out_channels)
        self.time_mixer = VAEMixer()

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        h = self.spatial_res_block(x)
        bf, hh, ww, c = h.shape
        h_t = h.view(bf // num_frames, num_frames, hh * ww, c)
        return self.time_mixer(h_t, self.temporal_res_block(h_t)).view(bf, hh, ww, c)


class VAEAttention(nn.Module):
    """Single-head VAE attention with GroupNorm and a residual connection."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, 32, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf, hh, ww, c = x.shape
        h = self.group_norm(x).view(bf, hh * ww, c)
        q = self.to_q(h)[:, :, None, :]
        k = self.to_k(h)[:, :, None, :]
        v = self.to_v(h)[:, :, None, :]
        o = dot_product_attention(q, k, v).reshape(bf, hh * ww, c)
        return x + self.to_out[0](o).view(bf, hh, ww, c)


class _Sampler(nn.Module):
    """Holds diffusers' ``downsamplers.0.conv`` / ``upsamplers.0.conv`` parameter path."""

    def __init__(self, conv: Conv2d):
        super().__init__()
        self.conv = conv


class DownEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(in_channels if j == 0 else out_channels, out_channels)
             for j in range(num_layers)])
        self.downsamplers = (nn.ModuleList([_Sampler(Conv2d(out_channels, out_channels, 3,
                                                            stride=2))])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            # diffusers' encoder downsample: pad (0, 1, 0, 1), then 3x3 stride 2, no padding
            x = self.downsamplers[0].conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        return x


class _MidBlock(nn.Module):
    def __init__(self, resnets: nn.ModuleList, channels: int):
        super().__init__()
        self.resnets = resnets
        self.attentions = nn.ModuleList([VAEAttention(channels)])


class Encoder(nn.Module):
    """SD VAE encoder (diffusers ``Encoder``)."""

    def __init__(self, cfg: TemporalVAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [DownEncoderBlock(chs[max(i - 1, 0)], ch, cfg.layers_per_block,
                              add_downsample=i < len(chs) - 1) for i, ch in enumerate(chs)])
        self.mid_block = _MidBlock(
            nn.ModuleList([VAEResnetBlock(chs[-1], chs[-1]) for _ in range(2)]), chs[-1])
        self.conv_norm_out = GroupNorm(chs[-1], 32, 1e-6, act="silu")
        self.conv_out = Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(self.conv_norm_out(h))


class _UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAETemporalResnetBlock(in_channels if j == 0 else out_channels, out_channels)
             for j in range(num_layers)])
        self.upsamplers = (nn.ModuleList([_Sampler(Conv2d(out_channels, out_channels, 3,
                                                          padding=1))])
                           if add_upsample else None)

    def forward(self, h: torch.Tensor, num_frames: int) -> torch.Tensor:
        for resnet in self.resnets:
            h = resnet(h, num_frames)
        if self.upsamplers is not None:
            h = self.upsamplers[0].conv(nearest_upsample_2x(h))
        return h


class TemporalDecoder(nn.Module):
    """diffusers ``TemporalDecoder``: temporal resblocks + a final (3,1,1) time conv."""

    def __init__(self, cfg: TemporalVAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        rev = tuple(reversed(chs))
        self.conv_in = Conv2d(cfg.latent_channels, chs[-1], 3, padding=1)
        self.mid_block = _MidBlock(
            nn.ModuleList([VAETemporalResnetBlock(chs[-1], chs[-1]) for _ in range(2)]),
            chs[-1])
        self.up_blocks = nn.ModuleList(
            [_UpBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                      add_upsample=i < len(chs) - 1) for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(chs[0], 32, 1e-6, act="silu")
        self.conv_out = Conv2d(chs[0], cfg.out_channels, 3, padding=1)
        self.time_conv_out = TemporalConv(cfg.out_channels, cfg.out_channels)

    def forward(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h, num_frames)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h, num_frames)
        for block in self.up_blocks:
            h = block(h, num_frames)
        h = self.conv_out(self.conv_norm_out(h))
        bf, hh, ww, c = h.shape
        ht = self.time_conv_out(h.reshape(bf // num_frames, num_frames, hh * ww, c))
        return ht.reshape(bf, hh, ww, c)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, config: TemporalVAEConfig = TemporalVAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.decoder = TemporalDecoder(config)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(B*T, H, W, 3) -> (B*T, h, w, 2*latent) mean/logvar moments."""
        return self.quant_conv(self.encoder(x))

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """Posterior mode (the mean), the reference's ``latent_dist.mode()``."""
        return self.encode_moments(x)[..., : self.config.latent_channels]

    def decode(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """(B*T, h, w, latent) -> (B*T, H, W, 3). The caller divides by scaling_factor."""
        return self.decoder(z, num_frames)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        return self.decode(self.encode_mode(x), num_frames)
