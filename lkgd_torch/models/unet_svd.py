"""UNetSpatioTemporalCondition (counterpart of ``lkgd_tpu/models/unet_svd.py``): the base
SVD UNet with the LKGD knowledge fusion of the context (``config.knowledge_fusion``),
joint x<->y stream attention (``config.joint``, its spatial branch scaled by the
``joint_scale`` argument), LoRA adapters routed by ``config.lora``, gradient
checkpointing (``config.remat``), a second input head selected per stream
(``config.y_input_head_mask``), the flow variant's second input convolution
(``config.dual_cond_conv_in``), ControlNet residuals and the DeepCache contract.

I/O as in the JAX package: ``sample`` ``(B, T, H, W, C_in)`` channels-last, ``timesteps``
``(B,)`` or a scalar (continuous 0.25*log(sigma) for SVD), ``encoder_hidden_states``
``(B, L, D)``, ``added_time_ids`` ``(B, 3)``, knowledge features ``(B, 1, K)`` or None;
returns ``(B, T, H, W, C_out)``.

``down_block_additional_residuals`` (one per skip, each reshaped to its skip and cast to
its dtype) are added to the skips after the down path and ``mid_block_additional_residual``
after the mid block: the ControlNet's outputs.

DeepCache (Ma et al. 2023, arXiv:2312.00858): ``return_deep_feature=True`` also returns
the input of the last up block, ``(B*T, h, w, block_out_channels[1])``; given back as
``deep_cache`` on a later step, the UNet recomputes only ``conv_in`` and down block 0 (its
downsampler too, whose output is discarded as in the JAX module) for fresh skips against
the current latents, runs the last up block on the cached feature, then the output head.
``full(x) == cached(x, feature_of(full(x)))`` exactly.

With ``remat`` each down, mid and up block runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` when a gradient is being
recorded, the counterpart of ``nn.remat``: its activations are recomputed in the backward
pass instead of kept.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
from lkgd_torch.models.layers import (Conv2d, GroupNorm, TimestepEmbedding, ZeroInitConv2d,
                                      get_timestep_embedding, stream_gate)
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
        if cfg.y_input_head_mask is not None:
            self.time_embedding_y = TimestepEmbedding(chans[0], cfg.time_embed_dim)
            self.add_embedding_y = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                     cfg.time_embed_dim)
            if not cfg.dual_cond_conv_in:  # the JAX module gives the flow variant no y conv
                self.conv_in_y = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        if cfg.dual_cond_conv_in:
            # conv_in2 reads sample[..., :in_channels // 2] joined with cond2 or with the
            # sample's channels past in_channels; the JAX pipelines initialise it on a sample
            # of in_channels channels and no cond2, so it takes in_channels // 2 channels
            self.conv_in2 = ZeroInitConv2d(cfg.in_channels // 2, chans[0], 3, padding=1)
            self.conv_in2_alpha = nn.Parameter(torch.zeros(1))

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

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if self.config.dual_cond_conv_in:
            self.conv_in2_alpha.zero_()

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, added_time_ids: torch.Tensor,
                domain_features: Optional[torch.Tensor] = None,
                flow_features: Optional[torch.Tensor] = None,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None,
                image_only_indicator: Optional[torch.Tensor] = None, joint_scale=1.0,
                cond2: Optional[torch.Tensor] = None,
                deep_cache: Optional[torch.Tensor] = None, return_deep_feature: bool = False):
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        batch_size, num_frames = sample.shape[:2]

        # time + added-time embeddings (fp32 sinusoids, cast to the model dtype)
        timesteps = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        t_emb = get_timestep_embedding(timesteps.expand(batch_size),
                                       cfg.block_out_channels[0]).to(dtype)
        add_embeds = get_timestep_embedding(added_time_ids.reshape(-1),
                                            cfg.addition_time_embed_dim)
        add_embeds = add_embeds.reshape(batch_size, -1).to(dtype)
        emb = self.time_embedding(t_emb) + self.add_embedding(add_embeds)
        if cfg.y_input_head_mask is not None:
            # the y head's rows, chosen by the static stream mask (a select, not a blend)
            emb_y = self.time_embedding_y(t_emb) + self.add_embedding_y(add_embeds)
            gate = stream_gate(cfg.y_input_head_mask, batch_size, dtype, sample.device)
            emb = torch.where(gate[:, None] > 0, emb_y, emb)

        # knowledge fusion of the context, before its per-frame copies
        if self.knowledge_fusion is not None:
            encoder_hidden_states = self.knowledge_fusion(
                encoder_hidden_states, domain_features, flow_features, dtype=dtype)

        # flatten frames; per-frame copies of emb and context
        sample = sample.reshape(batch_size * num_frames, *sample.shape[2:]).to(dtype)
        emb = emb.repeat_interleave(num_frames, dim=0)
        encoder_hidden_states = encoder_hidden_states.to(dtype).repeat_interleave(
            num_frames, dim=0)
        if image_only_indicator is None:
            image_only_indicator = torch.zeros(batch_size, num_frames, dtype=dtype,
                                               device=sample.device)  # video rows only
        else:
            image_only_indicator = image_only_indicator.to(dtype)
        ctx = (emb, encoder_hidden_states, image_only_indicator, joint_scale)

        sample = self._conv_in(sample, cond2, batch_size, num_frames)

        if deep_cache is not None:
            # a cached step: fresh shallow skips from the current latents, the deep trunk
            # replaced by the cached feature, straight to the last up block
            if (down_block_additional_residuals is not None
                    or mid_block_additional_residual is not None):
                raise ValueError("deep_cache is incompatible with ControlNet residuals")
            _, outs0 = self._down_block(self.down_blocks[0], sample, ctx)
            skips = (sample,) + outs0[:cfg.layers_per_block]
            sample = self._up_block(len(self.up_blocks) - 1, deep_cache.to(dtype), skips, ctx)
            out = self._out_head(sample, batch_size, num_frames)
            return (out, deep_cache) if return_deep_feature else out

        res_samples = (sample,)
        for block in self.down_blocks:
            sample, outs = self._down_block(block, sample, ctx)
            res_samples = res_samples + outs
        if down_block_additional_residuals is not None:
            res_samples = tuple(r + add.reshape(r.shape).to(r.dtype) for r, add in
                                zip(res_samples, down_block_additional_residuals))

        sample = self._run(self.mid_block, sample, *ctx)
        if mid_block_additional_residual is not None:
            sample = sample + mid_block_additional_residual.reshape(sample.shape).to(sample.dtype)

        deep_feature = None
        for i, block in enumerate(self.up_blocks):
            n_layers = len(block.resnets)
            skips, res_samples = res_samples[-n_layers:], res_samples[:-n_layers]
            if i == len(self.up_blocks) - 1:
                deep_feature = sample  # the DeepCache boundary: the last up block's input
            sample = self._up_block(i, sample, skips, ctx)

        out = self._out_head(sample, batch_size, num_frames)
        return (out, deep_feature) if return_deep_feature else out

    def _conv_in(self, sample: torch.Tensor, cond2: Optional[torch.Tensor], batch_size: int,
                 num_frames: int) -> torch.Tensor:
        """``conv_in`` of the flattened sample, with the y head's rows or, in the flow
        variant, ``conv_in2`` scaled by ``conv_in2_alpha`` added (the JAX slicing as it
        is: ``conv_in`` takes the first ``in_channels`` channels, ``conv_in2`` the first
        ``in_channels // 2`` joined with ``cond2`` or with the channels past
        ``in_channels``)."""
        cfg = self.config
        if cfg.dual_cond_conv_in:
            h = self.conv_in(sample[..., :cfg.in_channels])
            if cond2 is None:
                second = sample[..., cfg.in_channels:]
            else:
                second = cond2.reshape(batch_size * num_frames, *cond2.shape[2:]).to(h.dtype)
            h2 = self.conv_in2(torch.cat([sample[..., :cfg.in_channels // 2], second], dim=-1))
            return h + h2 * self.conv_in2_alpha.to(h.dtype)
        h = self.conv_in(sample)
        if cfg.y_input_head_mask is not None:
            gate = stream_gate(cfg.y_input_head_mask, h.shape[0], h.dtype, h.device)
            h = torch.where(gate[:, None, None, None] > 0, self.conv_in_y(sample), h)
        return h

    def _down_block(self, block: nn.Module, sample: torch.Tensor, ctx: tuple):
        emb, encoder_hidden_states, image_only_indicator, joint_scale = ctx
        if isinstance(block, CrossAttnDownBlockSpatioTemporal):
            return self._run(block, sample, emb, encoder_hidden_states, image_only_indicator,
                             joint_scale)
        return self._run(block, sample, emb, image_only_indicator)

    def _up_block(self, i: int, sample: torch.Tensor, skips: tuple, ctx: tuple) -> torch.Tensor:
        """Up block ``i`` on ``sample`` and its skips (the JAX module's ``_apply_up_block``)."""
        emb, encoder_hidden_states, image_only_indicator, joint_scale = ctx
        block = self.up_blocks[i]
        if isinstance(block, CrossAttnUpBlockSpatioTemporal):
            return self._run(block, sample, skips, emb, encoder_hidden_states,
                             image_only_indicator, joint_scale)
        return self._run(block, sample, skips, emb, image_only_indicator)

    def _out_head(self, sample: torch.Tensor, batch_size: int, num_frames: int) -> torch.Tensor:
        sample = self.conv_out(self.conv_norm_out(sample))
        return sample.reshape(batch_size, num_frames, *sample.shape[1:])
