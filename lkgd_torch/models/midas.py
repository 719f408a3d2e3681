"""DPT depth estimators (counterpart of ``lkgd_tpu/models/midas.py``): DPT-hybrid, the
isl-org MiDaS ``dpt_hybrid-midas-501f0c75.pt`` that ``depth_midas`` runs, and DPT-large,
HF ``DPTForDepthEstimation`` (Intel/dpt-large) that ``depth`` runs, with their processors.

DPT-hybrid: timm's ResNetV2 stem and three stages (weight-standardised convolutions, eps
1e-8 over each output channel's fan-in, TF-"SAME" padding as an explicit asymmetric
``F.pad``, GroupNorm(32) + ReLU through the port's GroupNorm kernels, non-preact
bottlenecks), a ViT-B/16 over the /16 map (the position embedding resampled bilinearly
without antialias for a non-native grid), the 'project' readout at blocks 8 and 11, four
fusion blocks with align-corners x2 upsampling and the monocular head. DPT-large: a
ViT-L/16 with readouts at four layers, transposed-conv reassembles and the same fusion and
head. Both take (B, H, W, 3) normalised to (x - 0.5) / 0.5 and return (B, H, W) inverse
depth. Their ViT attention is the plain matmul-softmax form, as in the JAX module.

Activations are channels-last. Module names are the published checkpoints': isl-org's
(``pretrained.model.*``, ``pretrained.act_postprocess{3,4}.*``, ``scratch.*``) and HF's
(``dpt.*``, ``neck.*``, ``head.head.*``), including the weights their forward never reads
(``pretrained.model.norm``, ``dpt.layernorm`` and the deepest fusion block's first residual
unit), so a checkpoint loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import Conv2d, GroupNorm, init_params, materialize
from lkgd_torch.ops.attention import plain_attention
from lkgd_torch.ops.resize import resize_bilinear
from lkgd_torch.utils.device import require_device


@dataclasses.dataclass(frozen=True)
class MidasConfig:
    image_size: int = 384
    resnet_layers: Tuple[int, ...] = (3, 4, 9)
    stem_width: int = 64
    vit_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    vit_mlp_ratio: int = 4
    hooks: Tuple[int, ...] = (8, 11)  # ViT blocks feeding the neck
    features: int = 256  # fusion width
    neck_channels: Tuple[int, ...] = (256, 512, 768, 768)
    patch_size: int = 16  # DPT-large's patches (the hybrid patches the /16 map)
    vit_ln_eps: float = 1e-6  # timm's ViT; HF's DPTConfig 1e-12

    @classmethod
    def tiny(cls) -> "MidasConfig":
        return cls(image_size=64, resnet_layers=(1, 1, 1), stem_width=8, vit_dim=32,
                   vit_depth=2, vit_heads=2, hooks=(0, 1), features=16,
                   neck_channels=(32, 64, 32, 32))

    @classmethod
    def large(cls) -> "MidasConfig":
        """Intel/dpt-large: ViT-L/16, hooks (5, 11, 17, 23), reassemble (256, 512, 1024,
        1024), fusion width 256."""
        return cls(image_size=384, vit_dim=1024, vit_depth=24, vit_heads=16,
                   hooks=(5, 11, 17, 23), features=256,
                   neck_channels=(256, 512, 1024, 1024), vit_ln_eps=1e-12)

    @classmethod
    def tiny_large(cls) -> "MidasConfig":
        return cls(image_size=64, vit_dim=32, vit_depth=4, vit_heads=2,
                   hooks=(0, 1, 2, 3), features=16, neck_channels=(8, 16, 32, 32),
                   vit_ln_eps=1e-12)


# ------------------------------------------------------------------ primitives
def _same_pad(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """TF "SAME" padding of (B, H, W, C) for a k x k window: the odd pixel at the bottom
    and right."""
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad lists the last dimensions first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0, *pads), value=value)


class StdConv(nn.Conv2d):
    """timm ``StdConv2dSame``: weight standardisation (each output channel's fan-in to zero
    mean and unit variance, eps 1e-8) and TF-"SAME" padding, no bias, on (B, H, W, C)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
        w = ((w - mean) * torch.rsqrt(var + 1e-8)).to(x.dtype)
        x = _same_pad(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride).permute(0, 2, 3, 1)


class GroupNormAct(GroupNorm):
    """timm ``GroupNormAct``: GroupNorm(32, or one group a channel below 32 channels, eps
    1e-5) through the port's kernels, then an optional ReLU."""

    def __init__(self, c: int, act: bool = True):
        super().__init__(c, num_groups=32 if c >= 32 else c, eps=1e-5)
        self.apply_act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return F.relu(y) if self.apply_act else y


def _maxpool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool with TF "SAME" padding (of -inf)."""
    x = _same_pad(x, 3, 2, value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


class _Stem(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv = StdConv(3, width, 7, 2)
        self.norm = GroupNormAct(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _maxpool_same(self.norm(self.conv(x)))


class _Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv = StdConv(cin, cout, 1, stride)
        self.norm = GroupNormAct(cout, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """timm resnetv2's non-preact bottleneck: ReLU after the residual add, a 1x1 + norm
    shortcut where the shape changes."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        mid = cout // 4
        self.downsample = (_Downsample(cin, cout, stride) if cin != cout or stride != 1
                           else None)
        self.conv1, self.norm1 = StdConv(cin, mid, 1), GroupNormAct(mid)
        self.conv2, self.norm2 = StdConv(mid, mid, 3, stride), GroupNormAct(mid)
        self.conv3, self.norm3 = StdConv(mid, cout, 1), GroupNormAct(cout, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


class HybridBackbone(nn.Module):
    """ResNetV2 stem + 3 stages; returns the (/4, /8, /16) feature maps."""

    def __init__(self, cfg: MidasConfig):
        super().__init__()
        self.stem = _Stem(cfg.stem_width)
        stages, cin, width = [], cfg.stem_width, cfg.stem_width * 4
        for si, n_blocks in enumerate(cfg.resnet_layers):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(cin, width, 2 if (bi == 0 and si > 0) else 1))
                cin = width
            stages.append(_Stage(blocks))
            width *= 2
        self.stages = nn.ModuleList(stages)
        self.out_channels = cin

    def forward(self, x: torch.Tensor):
        h = self.stem(x)
        outs = []
        for stage in self.stages:
            h = stage(h)
            outs.append(h)
        return outs


def _vit_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, 3D) fused [q | k | v] -> (B, S, D), plain attention with fp32 logits."""
    b, s, d3 = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, heads, d3 // (3 * heads)).unbind(2)
    return plain_attention(q, k, v).reshape(b, s, d3 // 3)


class _TimmAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(_vit_attention(self.qkv(x), self.heads))


class Mlp(nn.Module):
    """``fc1`` -> exact GELU -> ``fc2`` (timm's and DINOv2's MLP names)."""

    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class TimmBlock(nn.Module):
    """timm's pre-norm ViT block."""

    def __init__(self, d: int, heads: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.attn = _TimmAttention(d, heads)
        self.norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = Mlp(d, mlp_ratio * d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Readout(nn.Module):
    """The 'project' readout: the cls token concatenated onto every token, Linear(2d, d),
    exact GELU, as a (B, gh, gw, d) map."""

    def __init__(self, d: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * d, d), nn.GELU())

    def forward(self, t: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        x = torch.cat([t[:, 1:], t[:, :1].expand_as(t[:, 1:])], dim=-1)
        return self.project(x).reshape(t.shape[0], gh, gw, -1)


def resize_bilinear_ac(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear with align_corners=True on (B, H, W, C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


class ResidualConvUnit(nn.Module):
    """relu -> conv -> relu -> conv, plus the input (DPT's ``ResidualConvUnit_custom``,
    HF's ``DPTPreActResidualLayer``); ``names`` are the two convolutions' names."""

    def __init__(self, f: int, names: Tuple[str, str] = ("conv1", "conv2")):
        super().__init__()
        self.names = names
        for name in names:
            setattr(self, name, Conv2d(f, f, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = (getattr(self, n) for n in self.names)
        return b(F.relu(a(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Fusion: + the skip's residual unit (none for the deepest block, whose first unit is
    built all the same), a residual unit, align-corners x2 upsample, 1x1 projection. isl-org
    names (``resConfUnit1/2``, ``out_conv``) or HF's (``residual_layer1/2``,
    ``projection``)."""

    def __init__(self, f: int, hf: bool = False):
        super().__init__()
        self.hf = hf
        convs = ("convolution1", "convolution2") if hf else ("conv1", "conv2")
        units = ("residual_layer1", "residual_layer2") if hf else ("resConfUnit1", "resConfUnit2")
        self.units = units
        for name in units:
            setattr(self, name, ResidualConvUnit(f, convs))
        setattr(self, "projection" if hf else "out_conv", Conv2d(f, f, 1))

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``size``: the upsample's output (H, W); twice the input's by default."""
        if skip is not None:
            x = x + getattr(self, self.units[0])(skip)
        x = getattr(self, self.units[1])(x)
        x = resize_bilinear_ac(x, *(size or (2 * x.shape[1], 2 * x.shape[2])))
        return getattr(self, "projection" if self.hf else "out_conv")(x)


def _head(f: int) -> nn.Sequential:
    """The monocular head ``(0) conv 3x3 -> x2 up -> (2) conv 3x3 -> ReLU -> (4) conv 1x1 ->
    ReLU`` (indices of the published Sequential; the upsample and ReLUs hold no weights)."""
    return nn.Sequential(Conv2d(f, f // 2, 3, padding=1), nn.Identity(),
                         Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(), Conv2d(32, 1, 1),
                         nn.ReLU())


def _run_head(head: nn.Sequential, p1: torch.Tensor) -> torch.Tensor:
    h = head[0](p1)
    h = resize_bilinear_ac(h, 2 * h.shape[1], 2 * h.shape[2])
    h = F.relu(head[2](h))
    return F.relu(head[4](h))[..., 0]


def _fuse(blocks, rn) -> torch.Tensor:
    """refinenet4(l4) -> refinenet3(., l3) -> ... -> refinenet1(., l1): ``blocks`` and ``rn``
    ordered 1..4."""
    p = blocks[3](rn[3])
    for i in (2, 1, 0):
        p = blocks[i](p, rn[i])
    return p


def resize_pos_embed(pos: torch.Tensor, grid_hw: Tuple[int, int], num_prefix: int = 1
                     ) -> torch.Tensor:
    """MiDaS ``_resize_pos_embed``: the prefix tokens kept, the square grid part resampled
    bilinearly (half-pixel, no antialias) to ``grid_hw``."""
    tok, grid = pos[:, :num_prefix], pos[0, num_prefix:]
    gs = int(round(float(np.sqrt(grid.shape[0]))))
    grid = resize_bilinear(grid.reshape(gs, gs, -1).float(), grid_hw, antialias=False)
    return torch.cat([tok, grid.reshape(1, grid_hw[0] * grid_hw[1], -1).to(pos.dtype)], dim=1)


# ------------------------------------------------------------------ DPT-hybrid
class _PatchEmbed(nn.Module):
    def __init__(self, cfg: MidasConfig):
        super().__init__()
        self.backbone = HybridBackbone(cfg)
        self.proj = Conv2d(self.backbone.out_channels, cfg.vit_dim, 1)


class _HybridViT(nn.Module):
    def __init__(self, cfg: MidasConfig):
        super().__init__()
        native = cfg.image_size // 16
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.vit_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, native * native + 1, cfg.vit_dim))
        self.blocks = nn.ModuleList([TimmBlock(cfg.vit_dim, cfg.vit_heads, cfg.vit_mlp_ratio,
                                               cfg.vit_ln_eps) for _ in range(cfg.vit_depth)])
        self.norm = nn.LayerNorm(cfg.vit_dim, eps=cfg.vit_ln_eps)  # never read by the hooks

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)


class _Pretrained(nn.Module):
    def __init__(self, cfg: MidasConfig):
        super().__init__()
        self.model = _HybridViT(cfg)
        d, nc = cfg.vit_dim, cfg.neck_channels
        self.act_postprocess3 = nn.Sequential(Readout(d), nn.Identity(), nn.Identity(),
                                              Conv2d(d, nc[2], 1))
        self.act_postprocess4 = nn.Sequential(Readout(d), nn.Identity(), nn.Identity(),
                                              Conv2d(d, nc[3], 1),
                                              Conv2d(nc[3], nc[3], 3, stride=2, padding=1))


class _Scratch(nn.Module):
    def __init__(self, cfg: MidasConfig):
        super().__init__()
        for i, nc in enumerate(cfg.neck_channels, start=1):
            setattr(self, f"layer{i}_rn", Conv2d(nc, cfg.features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(cfg.features))
        self.output_conv = _head(cfg.features)


class DPTHybridDepth(nn.Module):
    """isl-org's DPT-hybrid: (B, H, W, 3), H and W multiples of 32 -> (B, H, W)."""

    def __init__(self, config: MidasConfig = MidasConfig()):
        super().__init__()
        self.config = config
        self.pretrained = _Pretrained(config)
        self.scratch = _Scratch(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, vit, sc = self.config, self.pretrained.model, self.scratch
        b = x.shape[0]
        gh, gw = x.shape[1] // 16, x.shape[2] // 16
        native = cfg.image_size // 16
        s0, s1, s2 = vit.patch_embed.backbone(x)
        tokens = vit.patch_embed.proj(s2).reshape(b, gh * gw, cfg.vit_dim)
        pos = vit.pos_embed
        if (gh, gw) != (native, native):
            pos = resize_pos_embed(pos, (gh, gw))
        tokens = torch.cat([vit.cls_token.expand(b, 1, cfg.vit_dim), tokens], dim=1) + pos
        hooks = []
        for i, block in enumerate(vit.blocks):
            tokens = block(tokens)
            if i in cfg.hooks:
                hooks.append(tokens)
        ap3, ap4 = self.pretrained.act_postprocess3, self.pretrained.act_postprocess4
        l3 = ap3[3](ap3[0](hooks[0], gh, gw))
        l4 = ap4[4](ap4[3](ap4[0](hooks[1], gh, gw)))
        rn = [getattr(sc, f"layer{i}_rn")(t) for i, t in enumerate((s0, s1, l3, l4), start=1)]
        p1 = _fuse([getattr(sc, f"refinenet{i}") for i in range(1, 5)], rn)
        return _run_head(sc.output_conv, p1)


# ------------------------------------------------------------------ DPT-large (HF)
class _HFPatchEmbeddings(nn.Module):
    def __init__(self, cfg: MidasConfig):
        super().__init__()
        ps = cfg.patch_size
        self.projection = Conv2d(3, cfg.vit_dim, ps, stride=ps)


class _HFEmbeddings(nn.Module):
    def __init__(self, cfg: MidasConfig):
        super().__init__()
        g = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.vit_dim))
        self.position_embeddings = nn.Parameter(torch.zeros(1, g * g + 1, cfg.vit_dim))
        self.patch_embeddings = _HFPatchEmbeddings(cfg)

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()
        self.position_embeddings.normal_(0.0, 0.02, generator=generator)


class HFSelfAttention(nn.Module):
    """HF's separate ``query``/``key``/``value`` projections with bias (ViT, DINOv2)."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def qkv(self, x: torch.Tensor):
        b, s, d = x.shape
        return (p(x).reshape(b, s, self.heads, d // self.heads)
                for p in (self.query, self.key, self.value))


class Dense(nn.Module):
    """HF's ``dense`` Linear under a named block (``output.dense``, ``intermediate.dense``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)


class HFAttention(nn.Module):
    """HF's ``attention.{query,key,value}`` and ``output.dense`` (ViT, DINOv2)."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.attention = HFSelfAttention(d, heads)
        self.output = Dense(d, d)


class HFViTLayer(nn.Module):
    """HF's ``ViTLayer`` (DPT's encoder layer)."""

    def __init__(self, cfg: MidasConfig):
        super().__init__()
        d = cfg.vit_dim
        self.attention = HFAttention(d, cfg.vit_heads)
        self.intermediate = Dense(d, cfg.vit_mlp_ratio * d)
        self.output = Dense(cfg.vit_mlp_ratio * d, d)
        self.layernorm_before = nn.LayerNorm(d, eps=cfg.vit_ln_eps)
        self.layernorm_after = nn.LayerNorm(d, eps=cfg.vit_ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = self.attention.attention.qkv(self.layernorm_before(x))
        x = x + self.attention.output.dense(plain_attention(q, k, v).reshape(b, s, d))
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class _HFEncoder(nn.Module):
    def __init__(self, cfg: MidasConfig):
        super().__init__()
        self.layer = nn.ModuleList([HFViTLayer(cfg) for _ in range(cfg.vit_depth)])


class _DPT(nn.Module):
    def __init__(self, cfg: MidasConfig):
        super().__init__()
        self.embeddings = _HFEmbeddings(cfg)
        self.encoder = _HFEncoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.vit_dim, eps=cfg.vit_ln_eps)  # never read


class ReassembleLayer(nn.Module):
    """1x1 projection, then ``resize``: a transposed conv of kernel = stride ``factor``
    (> 1), nothing (1) or a 3x3 stride-2 conv (0.5)."""

    def __init__(self, d: int, c: int, factor: float):
        super().__init__()
        self.projection = Conv2d(d, c, 1)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(c, c, int(factor), stride=int(factor))
        elif factor < 1:
            self.resize = Conv2d(c, c, 3, stride=2, padding=1)
        else:
            self.resize = None

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if isinstance(self.resize, nn.ConvTranspose2d):
            w = self.resize.weight
            w.normal_(0.0, w[:, 0].numel() ** -0.5, generator=generator)
            self.resize.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.projection(x)
        if isinstance(self.resize, nn.ConvTranspose2d):
            return self.resize(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x if self.resize is None else self.resize(x)


REASSEMBLE_FACTORS = (4, 2, 1, 0.5)


class _ReassembleStage(nn.Module):
    def __init__(self, d: int, channels, readout: bool):
        super().__init__()
        if readout:
            self.readout_projects = nn.ModuleList([
                nn.Sequential(nn.Linear(2 * d, d), nn.GELU()) for _ in range(4)])
        self.layers = nn.ModuleList([ReassembleLayer(d, c, f)
                                     for c, f in zip(channels, REASSEMBLE_FACTORS)])


class _FusionStage(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.layers = nn.ModuleList([FeatureFusionBlock(f, hf=True) for _ in range(4)])


class DPTNeck(nn.Module):
    """HF's DPT neck: reassemble stage, 3x3 ``convs`` to the fusion width, fusion stage
    (its layer 0 the deepest)."""

    def __init__(self, d: int, channels, f: int, readout: bool):
        super().__init__()
        self.reassemble_stage = _ReassembleStage(d, channels, readout)
        self.convs = nn.ModuleList([Conv2d(c, f, 3, padding=1, bias=False) for c in channels])
        self.fusion_stage = _FusionStage(f)


class _HFHead(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.head = _head(f)


class DPTLargeDepth(nn.Module):
    """HF ``DPTForDepthEstimation`` (Intel/dpt-large): (B, S, S, 3), S = image_size ->
    (B, S, S) non-negative inverse depth."""

    def __init__(self, config: MidasConfig = MidasConfig.large()):
        super().__init__()
        self.config = config
        self.dpt = _DPT(config)
        self.neck = DPTNeck(config.vit_dim, config.neck_channels, config.features, True)
        self.head = _HFHead(config.features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, emb = self.config, self.dpt.embeddings
        b = x.shape[0]
        gh = gw = cfg.image_size // cfg.patch_size
        tokens = emb.patch_embeddings.projection(x).reshape(b, gh * gw, cfg.vit_dim)
        tokens = torch.cat([emb.cls_token.expand(b, 1, cfg.vit_dim), tokens], dim=1)
        tokens = tokens + emb.position_embeddings
        hooks = []
        for i, layer in enumerate(self.dpt.encoder.layer):
            tokens = layer(tokens)
            if i in cfg.hooks:
                hooks.append(tokens)
        stage = self.neck.reassemble_stage
        feats = []
        for j, t in enumerate(hooks):
            x = torch.cat([t[:, 1:], t[:, :1].expand_as(t[:, 1:])], dim=-1)
            x = stage.readout_projects[j](x).reshape(b, gh, gw, cfg.vit_dim)
            feats.append(self.neck.convs[j](stage.layers[j](x)))
        fusion = self.neck.fusion_stage.layers
        p1 = _fuse([fusion[3], fusion[2], fusion[1], fusion[0]], feats)
        return _run_head(self.head.head, p1)


# ------------------------------------------------------------------ processors
def make_depth_processor(model: DPTLargeDepth):
    """The ``depth`` annotator (transformers' depth-estimation pipeline on Intel/dpt-large):
    (H, W, 3) [0, 1] -> (H, W, 3) [0, 1]. A square ``image_size`` cv2 ``INTER_CUBIC``
    resize, (x - 0.5) / 0.5, the model, ``INTER_CUBIC`` back to (H, W), then ``depth * 255 /
    max`` through uint8 and back."""
    size = model.config.image_size
    device = next(model.parameters()).device

    @torch.no_grad()
    def process(image: np.ndarray) -> np.ndarray:
        import cv2

        h, w = image.shape[:2]
        inp = cv2.resize(image, (size, size), interpolation=cv2.INTER_CUBIC)
        x = torch.from_numpy(((inp[None] - 0.5) / 0.5).astype(np.float32)).to(device)
        depth = model(x)[0].cpu().numpy()
        depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_CUBIC)
        formatted = np.clip(depth * 255.0 / (depth.max() + 1e-8), 0, 255).astype(np.uint8)
        return np.repeat((formatted.astype(np.float32) / 255.0)[..., None], 3, axis=-1)

    return process


def midas_resize_shape(h: int, w: int, target: int = 384, multiple: int = 32,
                       method: str = "minimal") -> Tuple[int, int]:
    """MiDaS ``transforms.Resize`` with keep_aspect_ratio and ensure_multiple_of: the height
    or width scale toward ``target`` that changes the image least ('minimal'; 'lower_bound':
    both sides >= target; else both <= target), each side rounded to a multiple."""
    sh, sw = target / h, target / w
    if method == "minimal":
        s = sh if abs(1 - sh) < abs(1 - sw) else sw
    elif method == "lower_bound":
        s = max(sh, sw)
    else:  # upper_bound
        s = min(sh, sw)

    def to_mult(v):
        return max(multiple, int(round(v / multiple) * multiple))

    return to_mult(s * h), to_mult(s * w)


def make_midas_processor(model: DPTHybridDepth):
    """The ``depth_midas`` annotator (controlnet_aux's MidasDetector): (H, W, 3) [0, 1] ->
    (H, W, 3) [0, 1]. cv2 ``INTER_CUBIC`` to ``midas_resize_shape``, (x - 0.5) / 0.5, the
    model, min-max normalised, cv2 ``INTER_LINEAR`` back to (H, W)."""
    target = model.config.image_size
    device = next(model.parameters()).device

    @torch.no_grad()
    def process(image: np.ndarray) -> np.ndarray:
        import cv2

        h, w = image.shape[:2]
        rh, rw = midas_resize_shape(h, w, target=target)
        inp = cv2.resize(image, (rw, rh), interpolation=cv2.INTER_CUBIC)
        x = torch.from_numpy(((inp[None] - 0.5) / 0.5).astype(np.float32)).to(device)
        depth = model(x)[0].cpu().numpy()
        depth = (depth - depth.min()) / (depth.max() - depth.min() + 1e-8)
        depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_LINEAR)
        return np.repeat(depth[..., None], 3, axis=-1).astype(np.float32)

    return process


def build_dpt(kind: str, config: Optional[MidasConfig] = None, device="cuda",
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """A frozen fp32 ``DPTHybridDepth`` (``kind="hybrid"``) or ``DPTLargeDepth``
    (``"large"``) in eval mode on ``device`` (the card unless the CPU is named), random from
    ``generator`` when one is given, else uninitialised for ``load_state_dict``."""
    device = require_device(device)
    if kind == "hybrid":
        factory = lambda: DPTHybridDepth(config or MidasConfig())  # noqa: E731
    elif kind == "large":
        factory = lambda: DPTLargeDepth(config or MidasConfig.large())  # noqa: E731
    else:
        raise ValueError(f"unknown DPT {kind!r}; expected hybrid|large")
    model = materialize(factory, device, torch.float32)
    if generator is not None:
        init_params(model, generator)
    return model.eval().requires_grad_(False)
