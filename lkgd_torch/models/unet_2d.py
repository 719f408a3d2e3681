"""UNet2DCondition, the SD 2D denoiser family (counterpart of ``lkgd_tpu/models/unet_2d.py``):
the SD2 UNet, an image-space conditioning encoder added at ``conv_in``
(``config.cond_embedding_channels``), joint x<->y stream attention with stream-masked LoRA
(``config.joint`` / ``config.lora``, the blocks of ``blocks_svd.py``), ControlNet residuals
and joint-frame track fusion (``config.track_fusion``).

I/O as in the JAX package: ``sample`` ``(B, H, W, C_in)`` channels-last, ``timesteps`` a
scalar or per sample ``(B,)`` (the joint pipelines give each stream its own),
``encoder_hidden_states`` ``(B, L, D)``; returns ``(B, H, W, C_out)``. The module tree
carries diffusers' ``UNet2DConditionModel`` names (``down_blocks.0.resnets.0``,
``down_blocks.0.attentions.0.transformer_blocks.0.attn1``, ``mid_block.attentions.0``,
``up_blocks.1.upsamplers.0.conv``), so an SD2 state dict loads with no renaming and the JAX
params with ``utils/porting.py`` ``unet2d_key_map``.

The spatial self-attention of levels 0 and 1 at 512x512 (4096 and 1024 tokens) runs on the
flash kernels; levels 2 and 3 and the 77-key cross-attention run the plain form, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.blocks_svd import (BasicTransformerBlock, Downsample2D, ResnetBlock2D,
                                          Upsample2D, _skip_channels)
from lkgd_torch.models.configs import (EMPTY_ROUTER, JointAttentionConfig, LoraRouter,
                                       UNet2DConfig)
from lkgd_torch.models.layers import (Conv2d, GroupNorm, TimestepEmbedding, ZeroInitConv2d,
                                      get_timestep_embedding)
from lkgd_torch.ops.track_fusion import quantize_tracks


class Transformer2DModel(nn.Module):
    """GroupNorm (eps 1e-6) + linear ``proj_in`` + BasicTransformerBlocks + linear
    ``proj_out``, with the residual (SD2 style)."""

    def __init__(self, channels: int, num_layers: int, heads: int, cross_attention_dim: int,
                 joint: Optional[JointAttentionConfig] = None, block_path: str = "",
                 lora: LoraRouter = EMPTY_ROUTER, track_fusion: bool = False,
                 temb_channels: int = 1280):
        super().__init__()
        dim_head = channels // heads
        inner = heads * dim_head
        self.track_fusion = track_fusion
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, lora,
                                   f"{block_path}.transformer_blocks.{i}", joint, temb_channels,
                                   track_fusion) for i in range(num_layers)])
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor, joint_scale=1.0,
                temb: Optional[torch.Tensor] = None, tracks=None,
                track_res: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        blk_tracks = None
        if self.track_fusion and tracks is not None:
            # pixel tracks onto this level's grid: downsample = image height / feature height
            src_xy, dst_xy, vis = tracks
            src_idx, dst_idx = quantize_tracks(src_xy, dst_xy, h, w, track_res[0] / h)
            blk_tracks = (src_idx, dst_idx, vis)
        z = self.proj_in(self.norm(x).view(b, h * w, c))
        for block in self.transformer_blocks:
            z = block(z, encoder_hidden_states, 1, joint_scale, temb, blk_tracks, (h, w))
        return self.proj_out(z).view(b, h, w, c) + x


class ConditioningEmbedding(nn.Module):
    """Image-space condition encoder: ``conv_in``, (conv, stride-2 conv) pairs with SiLU and
    a zero-init ``conv_out``; ``(B, H, W, C_cond)`` -> ``(B, h, w, embedding_channels)``."""

    def __init__(self, conditioning_channels: int, embedding_channels: int,
                 block_out_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        chans = block_out_channels
        self.conv_in = Conv2d(conditioning_channels, chans[0], 3, padding=1)
        blocks = []
        for i in range(len(chans) - 1):
            blocks.append(Conv2d(chans[i], chans[i], 3, padding=1))
            blocks.append(Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = ZeroInitConv2d(chans[-1], embedding_channels, 3, padding=1)

    def forward(self, conditioning: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(conditioning.to(self.conv_in.weight.dtype)))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class _Block(nn.Module):
    """Holds one level's ``resnets``, ``attentions`` and ``downsamplers`` / ``upsamplers``
    under diffusers' names."""

    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsamplers = nn.ModuleList(downsamplers) if downsamplers else None
        self.upsamplers = nn.ModuleList(upsamplers) if upsamplers else None


def encoder_blocks(cfg: UNet2DConfig, joint=None, lora: LoraRouter = EMPTY_ROUTER,
                   track_fusion: bool = False) -> Tuple[nn.ModuleList, _Block]:
    """The down blocks and the mid block of ``cfg`` (shared by the UNet and ControlNet-2D,
    which passes no joint, LoRA or track fusion)."""
    chans, temb = cfg.block_out_channels, cfg.time_embed_dim

    def attention(ch, heads, path):
        return Transformer2DModel(ch, cfg.transformer_layers_per_block, heads,
                                  cfg.cross_attention_dim, joint, path, lora, track_fusion, temb)

    down = nn.ModuleList()
    for i, block_type in enumerate(cfg.down_block_types):
        ch, cin = chans[i], chans[max(i - 1, 0)]
        resnets = [ResnetBlock2D(cin if j == 0 else ch, ch, temb)
                   for j in range(cfg.layers_per_block)]
        attentions = None
        if block_type == "CrossAttnDownBlock2D":
            attentions = [attention(ch, cfg.num_attention_heads[i],
                                    f"down_blocks.{i}.attentions.{j}")
                          for j in range(cfg.layers_per_block)]
        elif block_type != "DownBlock2D":
            raise ValueError(block_type)
        samplers = [Downsample2D(ch)] if i < len(chans) - 1 else None
        down.append(_Block(resnets, attentions, downsamplers=samplers))
    ch = chans[-1]
    mid = _Block([ResnetBlock2D(ch, ch, temb) for _ in range(2)],
                 [attention(ch, cfg.num_attention_heads[-1], "mid_block.attentions.0")])
    return down, mid


def run_encoder(down: nn.ModuleList, sample: torch.Tensor, emb: torch.Tensor,
                ehs: torch.Tensor, attn_args: tuple = ()):
    """The down path from ``conv_in``'s output: (the mid block's input, the skips),
    ``attn_args`` passed on to every ``Transformer2DModel`` after the context."""
    res_samples = (sample,)
    for block in down:
        for j, resnet in enumerate(block.resnets):
            sample = resnet(sample, emb)
            if block.attentions is not None:
                sample = block.attentions[j](sample, ehs, *attn_args)
            res_samples = res_samples + (sample,)
        if block.downsamplers is not None:
            sample = block.downsamplers[0](sample)
            res_samples = res_samples + (sample,)
    return sample, res_samples


def run_mid(mid: _Block, sample: torch.Tensor, emb: torch.Tensor, ehs: torch.Tensor,
            attn_args: tuple = ()) -> torch.Tensor:
    sample = mid.resnets[0](sample, emb)
    sample = mid.attentions[0](sample, ehs, *attn_args)
    return mid.resnets[1](sample, emb)


def time_embedding(module: TimestepEmbedding, timesteps, batch: int, channels: int,
                   dtype: torch.dtype, device, flip_sin_to_cos: bool = True,
                   freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoids of scalar or per-sample timesteps broadcast to ``batch`` rows (fp32), cast
    to ``dtype``, through the time MLP."""
    t = torch.as_tensor(timesteps, device=device).reshape(-1).expand(batch)
    t_emb = get_timestep_embedding(t, channels, flip_sin_to_cos=flip_sin_to_cos,
                                   downscale_freq_shift=freq_shift)
    return module(t_emb.to(dtype))


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNet2DConfig = UNet2DConfig()):
        super().__init__()
        self.config = cfg = config
        chans, temb = cfg.block_out_channels, cfg.time_embed_dim
        n_levels = len(chans)
        self.time_embedding = TimestepEmbedding(chans[0], temb)
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        if cfg.cond_embedding_channels is not None:
            self.cond_embedding = ConditioningEmbedding(
                cfg.cond_embedding_channels, chans[0], cfg.cond_embedding_blocks)
        self.down_blocks, self.mid_block = encoder_blocks(cfg, cfg.joint, cfg.lora,
                                                          cfg.track_fusion)
        rev = tuple(reversed(chans))
        rev_heads = tuple(reversed(cfg.num_attention_heads))
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, block_type in enumerate(cfg.up_block_types):
            ch = rev[i]
            n_layers = cfg.layers_per_block + 1
            ins = _skip_channels(rev[min(i + 1, n_levels - 1)], ch, prev, n_layers)
            resnets = [ResnetBlock2D(cin, ch, temb) for cin in ins]
            attentions = None
            if block_type == "CrossAttnUpBlock2D":
                attentions = [Transformer2DModel(
                    ch, cfg.transformer_layers_per_block, rev_heads[i], cfg.cross_attention_dim,
                    cfg.joint, f"up_blocks.{i}.attentions.{j}", cfg.lora, cfg.track_fusion, temb)
                    for j in range(n_layers)]
            elif block_type != "UpBlock2D":
                raise ValueError(block_type)
            samplers = [Upsample2D(ch)] if i < n_levels - 1 else None
            self.up_blocks.append(_Block(resnets, attentions, upsamplers=samplers))
            prev = ch
        self.conv_norm_out = GroupNorm(chans[0], 32, 1e-5, act="silu")
        self.conv_out = Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                cond_image: Optional[torch.Tensor] = None,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None,
                joint_scale=1.0, tracks=None,
                track_image_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``tracks``: (src_xy, dst_xy, visibility) point tracks of the (src, dst) row pairs,
        in pixels of ``track_image_size`` (None: on the latent sample's grid)."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        b = sample.shape[0]
        track_res = track_image_size or tuple(sample.shape[1:3])
        emb = time_embedding(self.time_embedding, timesteps, b, cfg.block_out_channels[0],
                             dtype, sample.device, cfg.flip_sin_to_cos, cfg.freq_shift)
        sample = self.conv_in(sample.to(dtype))
        if cfg.cond_embedding_channels is not None and cond_image is not None:
            sample = sample + self.cond_embedding(cond_image)
        ehs = encoder_hidden_states.to(dtype)
        attn_args = (joint_scale, emb, tracks, track_res)

        sample, res_samples = run_encoder(self.down_blocks, sample, emb, ehs, attn_args)
        if down_block_additional_residuals is not None:
            res_samples = tuple(r + a.reshape(r.shape).to(r.dtype) for r, a in
                                zip(res_samples, down_block_additional_residuals))
        sample = run_mid(self.mid_block, sample, emb, ehs, attn_args)
        if mid_block_additional_residual is not None:
            sample = sample + mid_block_additional_residual.reshape(sample.shape).to(sample.dtype)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                sample = torch.cat([sample, res_samples[-1]], dim=-1)
                res_samples = res_samples[:-1]
                sample = resnet(sample, emb)
                if block.attentions is not None:
                    sample = block.attentions[j](sample, ehs, *attn_args)
            if block.upsamplers is not None:
                sample = block.upsamplers[0](sample)
        return self.conv_out(self.conv_norm_out(sample))
