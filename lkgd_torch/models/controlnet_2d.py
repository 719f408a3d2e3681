"""ControlNet-2D, the SD image ControlNet (counterpart of ``lkgd_tpu/models/controlnet_2d.py``):
the 2D UNet's encoder and mid block with an image-space conditioning embedder added at
``conv_in`` and zero-init 1x1 heads that turn each skip and the mid block's output into the
residuals the UNet adds. As in the JAX module, the timestep sinusoids take the defaults
(``flip_sin_to_cos=True``, shift 0) whatever the config says, and the blocks carry no joint
branch, LoRA or track fusion.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from lkgd_torch.models.configs import ControlNet2DConfig
from lkgd_torch.models.layers import Conv2d, TimestepEmbedding, ZeroInitConv2d
from lkgd_torch.models.unet_2d import (ConditioningEmbedding, encoder_blocks, run_encoder,
                                       run_mid, time_embedding)


def _skip_widths(cfg) -> list:
    """The channels of the UNet's skips, in the order the down path makes them."""
    chans = cfg.block_out_channels
    widths = [chans[0]]
    for i in range(len(chans)):
        widths += [chans[i]] * cfg.layers_per_block
        if i < len(chans) - 1:
            widths.append(chans[i])
    return widths


class ControlNet2D(nn.Module):
    """``forward(sample, timesteps, encoder_hidden_states, controlnet_cond,
    conditioning_scale)`` -> ``(down_residuals, mid_residual)``, each scaled by
    ``conditioning_scale``; ``controlnet_cond`` ``(B, H, W, conditioning_channels)`` in
    image space."""

    def __init__(self, config: ControlNet2DConfig = ControlNet2DConfig()):
        super().__init__()
        self.config = config
        cfg = config.unet
        chans = cfg.block_out_channels
        self.time_embedding = TimestepEmbedding(chans[0], cfg.time_embed_dim)
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.controlnet_cond_embedding = ConditioningEmbedding(
            config.conditioning_channels, chans[0], config.conditioning_embedding_out_channels)
        self.down_blocks, self.mid_block = encoder_blocks(cfg)
        self.controlnet_down_blocks = nn.ModuleList(
            [ZeroInitConv2d(c, c, 1) for c in _skip_widths(cfg)])
        self.controlnet_mid_block = ZeroInitConv2d(chans[-1], chans[-1], 1)

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                controlnet_cond: torch.Tensor, conditioning_scale: float = 1.0):
        cfg = self.config.unet
        dtype = self.conv_in.weight.dtype
        emb = time_embedding(self.time_embedding, timesteps, sample.shape[0],
                             cfg.block_out_channels[0], dtype, sample.device)
        sample = self.conv_in(sample.to(dtype))
        sample = sample + self.controlnet_cond_embedding(controlnet_cond)
        ehs = encoder_hidden_states.to(dtype)
        sample, res_samples = run_encoder(self.down_blocks, sample, emb, ehs)
        sample = run_mid(self.mid_block, sample, emb, ehs)
        down = tuple(head(r) * conditioning_scale
                     for head, r in zip(self.controlnet_down_blocks, res_samples))
        return down, self.controlnet_mid_block(sample) * conditioning_scale
