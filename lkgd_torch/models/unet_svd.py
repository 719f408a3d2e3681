"""UNetSpatioTemporalCondition (counterpart of ``lkgd_tpu/models/unet_svd.py``): the base
SVD UNet with the LKGD knowledge fusion of the context (``config.knowledge_fusion``),
joint x<->y stream attention (``config.joint``, its spatial branch scaled by the
``joint_scale`` argument), LoRA adapters routed by ``config.lora`` and gradient
checkpointing (``config.remat``).

I/O as in the JAX package: ``sample`` ``(B, T, H, W, C_in)`` channels-last, ``timesteps``
``(B,)`` or a scalar (continuous 0.25*log(sigma) for SVD), ``encoder_hidden_states``
``(B, L, D)``, ``added_time_ids`` ``(B, 3)``, knowledge features ``(B, 1, K)`` or None;
returns ``(B, T, H, W, C_out)``.

With ``remat`` each down, mid and up block runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` when a gradient is being
recorded, the counterpart of ``nn.remat``: its activations are recomputed in the backward
pass instead of kept.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from lkgd_torch.models.blocks_svd import (
    CrossAttnDownBlockSpatioTemporal,
    CrossAttnUpBlockSpatioTemporal,
    DownBlockSpatioTemporal,
    UNetMidBlockSpatioTemporal,
    UpBlockSpatioTemporal,
)
from lkgd_torch.models.configs import SVDUNetConfig
from lkgd_torch.models.layers import Conv2d, GroupNorm, TimestepEmbedding, get_timestep_embedding
from lkgd_torch.ops.fusion import LatentKnowledgeFusion


class UNetSpatioTemporalCondition(nn.Module):
    def __init__(self, config: SVDUNetConfig = SVDUNetConfig()):
        super().__init__()
        self.config = cfg = config
        chans = cfg.block_out_channels
        n_levels = len(chans)
        self.time_embedding = TimestepEmbedding(chans[0], cfg.time_embed_dim)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                               cfg.time_embed_dim)
        self.knowledge_fusion = (LatentKnowledgeFusion(ctx_dim=cfg.cross_attention_dim)
                                 if cfg.knowledge_fusion else None)
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)

        eps_cross = cfg.resnet_eps_cross or cfg.resnet_eps
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            cin = chans[max(i - 1, 0)]
            add_down = i < n_levels - 1
            if block_type == "CrossAttnDownBlockSpatioTemporal":
                self.down_blocks.append(CrossAttnDownBlockSpatioTemporal(
                    cin, chans[i], cfg.layers_per_block, eps_cross,
                    cfg.transformer_layers_per_block, cfg.num_attention_heads[i],
                    cfg.cross_attention_dim, add_down, cfg.time_embed_dim, cfg.lora,
                    f"down_blocks.{i}", cfg.joint))
            elif block_type == "DownBlockSpatioTemporal":
                self.down_blocks.append(DownBlockSpatioTemporal(
                    cin, chans[i], cfg.layers_per_block, cfg.resnet_eps, add_down,
                    cfg.time_embed_dim))
            else:
                raise ValueError(block_type)

        self.mid_block = UNetMidBlockSpatioTemporal(
            chans[-1], cfg.transformer_layers_per_block, cfg.resnet_eps,
            cfg.num_attention_heads[-1], cfg.cross_attention_dim, cfg.time_embed_dim, cfg.lora,
            joint=cfg.joint)

        rev = tuple(reversed(chans))
        rev_heads = tuple(reversed(cfg.num_attention_heads))
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, block_type in enumerate(cfg.up_block_types):
            cin = rev[min(i + 1, n_levels - 1)]
            add_up = i < n_levels - 1
            n_layers = cfg.layers_per_block + 1
            if block_type == "CrossAttnUpBlockSpatioTemporal":
                self.up_blocks.append(CrossAttnUpBlockSpatioTemporal(
                    cin, rev[i], prev, n_layers, eps_cross, cfg.transformer_layers_per_block,
                    rev_heads[i], cfg.cross_attention_dim, add_up, cfg.time_embed_dim,
                    cfg.lora, f"up_blocks.{i}", cfg.joint))
            elif block_type == "UpBlockSpatioTemporal":
                self.up_blocks.append(UpBlockSpatioTemporal(
                    cin, rev[i], prev, n_layers, cfg.resnet_eps_up or cfg.resnet_eps, add_up,
                    cfg.time_embed_dim))
            else:
                raise ValueError(block_type)
            prev = rev[i]

        self.conv_norm_out = GroupNorm(chans[0], 32, 1e-5, act="silu")
        self.conv_out = Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    def _run(self, block: nn.Module, *args):
        """``block(*args)``, checkpointed under ``remat`` while a gradient is recorded."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, added_time_ids: torch.Tensor,
                domain_features: Optional[torch.Tensor] = None,
                flow_features: Optional[torch.Tensor] = None, joint_scale=1.0) -> torch.Tensor:
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        batch_size, num_frames = sample.shape[:2]

        # time + added-time embeddings (fp32 sinusoids, cast to the model dtype)
        timesteps = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        t_emb = get_timestep_embedding(timesteps.expand(batch_size), cfg.block_out_channels[0])
        emb = self.time_embedding(t_emb.to(dtype))
        add_embeds = get_timestep_embedding(added_time_ids.reshape(-1),
                                            cfg.addition_time_embed_dim)
        emb = emb + self.add_embedding(add_embeds.reshape(batch_size, -1).to(dtype))

        # knowledge fusion of the context, before its per-frame copies
        if self.knowledge_fusion is not None:
            encoder_hidden_states = self.knowledge_fusion(
                encoder_hidden_states, domain_features, flow_features, dtype=dtype)

        # flatten frames; per-frame copies of emb and context
        sample = sample.reshape(batch_size * num_frames, *sample.shape[2:]).to(dtype)
        emb = emb.repeat_interleave(num_frames, dim=0)
        encoder_hidden_states = encoder_hidden_states.to(dtype).repeat_interleave(
            num_frames, dim=0)
        image_only_indicator = torch.zeros(batch_size, num_frames, dtype=dtype,
                                           device=sample.device)  # video rows only

        sample = self.conv_in(sample)
        res_samples = (sample,)
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlockSpatioTemporal):
                sample, outs = self._run(block, sample, emb, encoder_hidden_states,
                                         image_only_indicator, joint_scale)
            else:
                sample, outs = self._run(block, sample, emb, image_only_indicator)
            res_samples = res_samples + outs

        sample = self._run(self.mid_block, sample, emb, encoder_hidden_states,
                           image_only_indicator, joint_scale)

        for block in self.up_blocks:
            n_layers = len(block.resnets)
            skips, res_samples = res_samples[-n_layers:], res_samples[:-n_layers]
            if isinstance(block, CrossAttnUpBlockSpatioTemporal):
                sample = self._run(block, sample, skips, emb, encoder_hidden_states,
                                   image_only_indicator, joint_scale)
            else:
                sample = self._run(block, sample, skips, emb, image_only_indicator)

        sample = self.conv_out(self.conv_norm_out(sample))
        return sample.reshape(batch_size, num_frames, *sample.shape[1:])
