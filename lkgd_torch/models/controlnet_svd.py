"""ControlNet-SDV (counterpart of ``lkgd_tpu/models/controlnet_svd.py``): an image-space
conditioning embedder (stride-2 convolutions, a zero-init output), a copy of the SVD UNet's
encoder and mid block, and zero-init 1x1 heads that turn each skip and the mid block's
output into the residuals the UNet adds (``down_block_additional_residuals`` /
``mid_block_additional_residual``).

The blocks are plain whatever the host UNet's config says, as in the JAX module: GroupNorm
eps 1e-5, no joint branch, no LoRA, no knowledge fusion and no remat. Parameter names are
those that the JAX package's ``export_state_dict(params, svd_export_key_map)`` gives the
JAX ControlNet, so that export loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from lkgd_torch.models.blocks_svd import (CrossAttnDownBlockSpatioTemporal,
                                          DownBlockSpatioTemporal, UNetMidBlockSpatioTemporal)
from lkgd_torch.models.configs import SVDUNetConfig
from lkgd_torch.models.layers import (Conv2d, TimestepEmbedding, ZeroInitConv2d,
                                      get_timestep_embedding)
from lkgd_torch.models.unet_2d import ConditioningEmbedding

EPS = 1e-5  # the JAX blocks' default: the ControlNet passes no eps of the host UNet


@dataclasses.dataclass(frozen=True)
class ControlNetSDVConfig:
    unet: SVDUNetConfig = SVDUNetConfig()
    conditioning_channels: int = 3
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)


class ControlNetConditioningEmbeddingSVD(ConditioningEmbedding):
    """The 2D conditioning embedder (``models/unet_2d.py``) over every frame:
    ``(B, T, H, W, C_cond)`` -> ``(B*T, h, w, embedding_channels)``."""

    def forward(self, conditioning: torch.Tensor) -> torch.Tensor:
        b, t = conditioning.shape[:2]
        return super().forward(conditioning.reshape(b * t, *conditioning.shape[2:]))


class ControlNetSDV(nn.Module):
    """``forward(sample, timesteps, encoder_hidden_states, added_time_ids, controlnet_cond,
    conditioning_scale)`` -> ``(down_residuals, mid_residual)``, each ``(B*T, h, w, C)`` as
    in the JAX module and multiplied by ``conditioning_scale``. ``sample`` is the UNet's own
    input; ``controlnet_cond`` ``(B, T, H, W, C_cond)`` in image space, or None."""

    def __init__(self, config: ControlNetSDVConfig = ControlNetSDVConfig()):
        super().__init__()
        self.config = config
        cfg = config.unet
        chans = cfg.block_out_channels
        n_levels = len(chans)
        self.time_embedding = TimestepEmbedding(chans[0], cfg.time_embed_dim)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                               cfg.time_embed_dim)
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.controlnet_cond_embedding = ControlNetConditioningEmbeddingSVD(
            config.conditioning_channels, chans[0], config.conditioning_embedding_out_channels)

        self.down_blocks = nn.ModuleList()
        skip_channels = [chans[0]]
        for i, block_type in enumerate(cfg.down_block_types):
            cin = chans[max(i - 1, 0)]
            add_down = i < n_levels - 1
            if block_type == "CrossAttnDownBlockSpatioTemporal":
                self.down_blocks.append(CrossAttnDownBlockSpatioTemporal(
                    cin, chans[i], cfg.layers_per_block, EPS, cfg.transformer_layers_per_block,
                    cfg.num_attention_heads[i], cfg.cross_attention_dim, add_down,
                    cfg.time_embed_dim, block_path=f"down_blocks.{i}"))
            elif block_type == "DownBlockSpatioTemporal":
                self.down_blocks.append(DownBlockSpatioTemporal(
                    cin, chans[i], cfg.layers_per_block, EPS, add_down, cfg.time_embed_dim))
            else:
                raise ValueError(block_type)
            skip_channels += [chans[i]] * (cfg.layers_per_block + int(add_down))
        self.mid_block = UNetMidBlockSpatioTemporal(
            chans[-1], cfg.transformer_layers_per_block, EPS, cfg.num_attention_heads[-1],
            cfg.cross_attention_dim, cfg.time_embed_dim)
        self.controlnet_down_blocks = nn.ModuleList(
            [ZeroInitConv2d(c, c, 1) for c in skip_channels])
        self.controlnet_mid_block = ZeroInitConv2d(chans[-1], chans[-1], 1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, added_time_ids: torch.Tensor,
                controlnet_cond: Optional[torch.Tensor] = None, conditioning_scale=1.0):
        cfg = self.config.unet
        dtype = self.conv_in.weight.dtype
        batch_size, num_frames = sample.shape[:2]

        timesteps = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        t_emb = get_timestep_embedding(timesteps.expand(batch_size), cfg.block_out_channels[0])
        add_embeds = get_timestep_embedding(added_time_ids.reshape(-1),
                                            cfg.addition_time_embed_dim)
        emb = (self.time_embedding(t_emb.to(dtype))
               + self.add_embedding(add_embeds.reshape(batch_size, -1).to(dtype)))

        sample = sample.reshape(batch_size * num_frames, *sample.shape[2:]).to(dtype)
        emb = emb.repeat_interleave(num_frames, dim=0)
        encoder_hidden_states = encoder_hidden_states.to(dtype).repeat_interleave(
            num_frames, dim=0)
        image_only_indicator = torch.zeros(batch_size, num_frames, dtype=dtype,
                                           device=sample.device)

        sample = self.conv_in(sample)
        if controlnet_cond is not None:
            sample = sample + self.controlnet_cond_embedding(controlnet_cond)

        res_samples = (sample,)
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlockSpatioTemporal):
                sample, outs = block(sample, emb, encoder_hidden_states, image_only_indicator)
            else:
                sample, outs = block(sample, emb, image_only_indicator)
            res_samples = res_samples + outs
        sample = self.mid_block(sample, emb, encoder_hidden_states, image_only_indicator)

        down = tuple(head(r) * conditioning_scale
                     for head, r in zip(self.controlnet_down_blocks, res_samples))
        return down, self.controlnet_mid_block(sample) * conditioning_scale


_FROM_UNET = ("down_blocks", "mid_block", "time_embedding", "add_embedding", "conv_in")


@torch.no_grad()
def init_from_unet(controlnet: ControlNetSDV, unet: nn.Module) -> int:
    """Copy the encoder, mid block, embeddings and ``conv_in`` of ``unet`` into
    ``controlnet`` (the JAX package's ``init_from_unet``, the reference's ``from_unet``).
    Tensors the UNet has and the ControlNet lacks (joint branch, LoRA, the y head) are
    skipped; the zero heads and the conditioning embedder keep their values. Returns the
    number of tensors copied."""
    source = unet.state_dict()
    copied = 0
    for name, value in controlnet.state_dict().items():
        if name.split(".")[0] in _FROM_UNET and name in source:
            value.copy_(source[name])
            copied += 1
    return copied
