"""The SD image VAE, ``AutoencoderKL`` (counterpart of ``lkgd_tpu/models/vae_2d.py``): the
temporal VAE's ``Encoder`` (``models/vae_temporal.py``, as in the JAX package) with a plain
2D decoder, under diffusers' ``AutoencoderKL`` names.

Channels-last: ``encode_mode`` (B, H, W, 3) -> (B, h, w, 4); ``decode`` (B, h, w, 4) ->
(B, H, W, 3). The mid-block attention is one head of width 512 over H*W/64 tokens (4096 at
512x512), which the flash kernels carry. The caller scales the latents
(``config.scaling_factor``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lkgd_torch.models.configs import VAE2DConfig
from lkgd_torch.models.layers import Conv2d, GroupNorm, nearest_upsample_2x
from lkgd_torch.models.vae_temporal import (Encoder, VAEAttention, VAEResnetBlock, _MidBlock,
                                            _Sampler)


class _UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(in_channels if j == 0 else out_channels, out_channels)
             for j in range(num_layers)])
        self.upsamplers = (nn.ModuleList([_Sampler(Conv2d(out_channels, out_channels, 3,
                                                          padding=1))])
                           if add_upsample else None)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            h = resnet(h)
        if self.upsamplers is not None:
            h = self.upsamplers[0].conv(nearest_upsample_2x(h))
        return h


class Decoder2D(nn.Module):
    def __init__(self, cfg: VAE2DConfig):
        super().__init__()
        chs = cfg.block_out_channels
        rev = tuple(reversed(chs))
        self.conv_in = Conv2d(cfg.latent_channels, chs[-1], 3, padding=1)
        self.mid_block = _MidBlock(
            nn.ModuleList([VAEResnetBlock(chs[-1], chs[-1]) for _ in range(2)]), chs[-1])
        self.up_blocks = nn.ModuleList(
            [_UpDecoderBlock2D(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                               add_upsample=i < len(chs) - 1) for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(chs[0], 32, 1e-6, act="silu")
        self.conv_out = Conv2d(chs[0], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAE2DConfig = VAE2DConfig()):
        super().__init__()
        self.config = config
        latent = config.latent_channels
        self.encoder = Encoder(config)
        self.quant_conv = Conv2d(2 * latent, 2 * latent, 1)
        self.post_quant_conv = Conv2d(latent, latent, 1)
        self.decoder = Decoder2D(config)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, h, w, 2 * latent) mean / logvar moments."""
        return self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior's mode (its mean)."""
        return self.encode_moments(x)[..., : self.config.latent_channels]

    def encode_sample(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A posterior draw, logvar clipped to [-30, 20]; ``noise`` (standard normal, the
        latents' shape) in place of a draw from ``generator``."""
        m = self.encode_moments(x)
        latent = self.config.latent_channels
        mean, logvar = m[..., :latent], torch.clamp(m[..., latent:], -30.0, 20.0)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode_mode(x))
