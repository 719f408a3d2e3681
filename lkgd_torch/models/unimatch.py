"""UniMatch / GMFlow optical flow, stereo and depth (counterpart of
``lkgd_tpu/models/unimatch.py``, in the same order).

A residual CNN encoder with a weight-shared two-stride trident convolution, single-head
transformer blocks with Swin-style split-window self and cross attention, global and local
correlation-softmax matching, self-attention flow propagation, RAFT-style convex upsampling
and the SepConvGRU regression refinement. The LKGD conditioning path runs
``UniMatchConfig.lkgd()``: 128 channels, 2 scales, splits (2, 8), correlation radius (-1, 4),
propagation radius (-1, 1), one refinement iteration, upsample factor 4.

Activations are channels-last ``(B, H, W, C)`` as in the JAX module; convolutions run on the
``(B, C, H, W)`` view (``layers.Conv2d``). Attention and correlations are plain matmuls and
softmaxes with fp32 logits, as the JAX module leaves them to XLA: there is no kernel here.
``bilinear_sample`` is ``F.grid_sample`` with ``align_corners=True`` and zero padding, the
sampling the JAX function transcribes.

The learnable parameters depend on the task only through the refinement block (one output
channel for stereo disparity and inverse depth, no mask head for depth) and the convex
upsampler (built for models without refinement and for depth), so a model is built for one
``task``. Submodule names are the JAX module's (``backbone``, ``transformer``,
``feature_flow_attn``, ``upsampler``, ``refine_proj``, ``refine`` and theirs), except that
the transformer's blocks are the list ``transformer.layers.<i>.{self_attn,cross_attn_ffn}``;
``lkgd_torch.utils.porting.unimatch_state_dict`` carries JAX params across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import Conv2d, init_params, materialize
from lkgd_torch.utils.device import require_device

TASKS = ("flow", "stereo", "depth")


@dataclasses.dataclass(frozen=True)
class UniMatchConfig:
    feature_channels: int = 128
    num_scales: int = 2
    upsample_factor: int = 4
    num_transformer_layers: int = 6
    ffn_dim_expansion: int = 4
    reg_refine: bool = True
    attn_splits_list: Tuple[int, ...] = (2, 8)
    corr_radius_list: Tuple[int, ...] = (-1, 4)
    prop_radius_list: Tuple[int, ...] = (-1, 1)
    num_reg_refine: int = 1

    @classmethod
    def lkgd(cls) -> "UniMatchConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "UniMatchConfig":
        return cls(feature_channels=32, num_scales=2, num_transformer_layers=2,
                   attn_splits_list=(2, 2), corr_radius_list=(-1, 2),
                   prop_radius_list=(-1, 1), num_reg_refine=1)


# ------------------------------------------------------------------ functional helpers
def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.InstanceNorm2d``'s default on ``(B, H, W, C)``: per sample and channel over H, W,
    biased variance, no affine."""
    var, mean = torch.var_mean(x, dim=(1, 2), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def coords_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(H, W, 2) pixel coordinates in (x, y) order."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``img`` (B, H, W, C) sampled at pixel-space (x, y) ``coords`` (B, ..., 2): bilinear,
    with a zero for each corner outside the image (``grid_sample(align_corners=True,
    padding_mode="zeros")``; an axis of size 1 is padded with a zero row or column first, so
    that its positions keep their pixel scale). Returns (B, ..., C)."""
    b, h, w, c = img.shape
    if h == 1 or w == 1:  # a zero row or column, where align_corners=True has no scale
        img = F.pad(img, (0, 0, 0, int(w == 1), 0, int(h == 1)))
        b, h, w, c = img.shape
    scale = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], device=coords.device)
    grid = coords.reshape(b, -1, 1, 2).float() / scale - 1.0  # fp32 positions in any dtype
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)  # (B, C, N, 1)
    return out[..., 0].transpose(1, 2).reshape(*coords.shape[:-1], c).to(img.dtype)


def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``feature`` (B, H, W, C) by ``flow`` (B, H, W, 2)."""
    _, h, w, _ = feature.shape
    return bilinear_sample(feature, coords_grid(h, w, feature.device)[None] + flow)


def position_embedding_sine(h: int, w: int, num_pos_feats: int, temperature: int = 10000,
                            device=None) -> torch.Tensor:
    """DETR's sine embedding, channels-last (H, W, 2 * num_pos_feats): y features first."""
    scale = 2 * math.pi
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    y_embed, x_embed = ones.cumsum(0), ones.cumsum(1)
    eps = 1e-6
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


def split_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*k*k, H/k, W/k, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of ``split_windows``."""
    bk, hk, wk, c = x.shape
    x = x.reshape(bk // (k * k), k, k, hk, wk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bk // (k * k), k * hk, k * wk, c)


def shift_window_attn_mask(h: int, w: int, k: int, device=None) -> torch.Tensor:
    """The Swin shifted-window mask, (k*k, win, win): -100 between tokens that the cyclic
    shift brought from different regions, 0 elsewhere."""
    win_h, win_w = h // k, w // k
    shift_h, shift_w = win_h // 2, win_w // 2
    img_mask = torch.zeros((h, w), device=device)
    cnt = 0
    h_slices = (slice(0, -win_h), slice(-win_h, -shift_h), slice(-shift_h, None))
    w_slices = (slice(0, -win_w), slice(-win_w, -shift_w), slice(-shift_w, None))
    for hs in h_slices:
        for ws in w_slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    windows = split_windows(img_mask[None, :, :, None], k).reshape(-1, win_h * win_w)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _single_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L, C) single-head softmax attention with fp32 logits."""
    logits = torch.einsum("blc,bmc->blm", q.float(), k.float()) / q.shape[-1] ** 0.5
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("blm,bmc->blc", probs, v)


def split_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_splits: int,
                           h: int, w: int, with_shift: bool,
                           attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Swin split-window single-head attention, (B, H*W, C) in and out; with ``with_shift``
    the windows move by half a window (cyclic roll) and ``attn_mask`` keeps regions apart."""
    b, _, c = q.shape
    qs, ks, vs = (x.reshape(b, h, w, c) for x in (q, k, v))
    sh, sw = (h // num_splits) // 2, (w // num_splits) // 2
    if with_shift:
        qs, ks, vs = (torch.roll(x, (-sh, -sw), dims=(1, 2)) for x in (qs, ks, vs))
    qw, kw, vw = (split_windows(x, num_splits).reshape(b * num_splits ** 2, -1, c)
                  for x in (qs, ks, vs))
    mask = attn_mask.repeat(b, 1, 1) if with_shift and attn_mask is not None else None
    out = _single_head_attention(qw, kw, vw, mask)
    out = merge_windows(out.reshape(b * num_splits ** 2, h // num_splits, w // num_splits, c),
                        num_splits)
    if with_shift:
        out = torch.roll(out, (sh, sw), dims=(1, 2))
    return out.reshape(b, -1, c)


# ------------------------------------------------------------------ modules
class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.downsample = (Conv2d(in_planes, planes, 1, stride=stride)
                           if stride != 1 or in_planes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    """Residual backbone at 1/8 (one scale) or 1/4 resolution, then the trident convolution:
    ONE 3x3 weight applied at strides 1, 2, ..., high to low resolution."""

    def __init__(self, output_dim: int = 128, num_scales: int = 2):
        super().__init__()
        dims = (64, 96, 128)
        self.num_scales = num_scales
        self.conv1 = Conv2d(3, dims[0], 7, stride=2, padding=3, bias=False)
        self.layer1_0 = ResidualBlock(dims[0], dims[0])
        self.layer1_1 = ResidualBlock(dims[0], dims[0])
        self.layer2_0 = ResidualBlock(dims[0], dims[1], 2)
        self.layer2_1 = ResidualBlock(dims[1], dims[1])
        self.layer3_0 = ResidualBlock(dims[1], dims[2], 2 if num_scales == 1 else 1)
        self.layer3_1 = ResidualBlock(dims[2], dims[2])
        self.conv2 = Conv2d(dims[2], output_dim, 1)
        if num_scales > 1:  # (O, I, 3, 3), no bias
            self.trident_weight = nn.Parameter(torch.empty(output_dim, output_dim, 3, 3))

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        if self.num_scales > 1:
            w = self.trident_weight
            w.normal_(0.0, w[0].numel() ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(instance_norm(self.conv1(x)))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1", "layer3_0", "layer3_1"):
            x = getattr(self, name)(x)
        x = self.conv2(x)
        if self.num_scales == 1:
            return [x]
        xc = x.permute(0, 3, 1, 2)
        return [F.conv2d(xc, self.trident_weight.to(x.dtype), stride=2 ** i,
                         padding=1).permute(0, 2, 3, 1) for i in range(self.num_scales)]


class TransformerLayer(nn.Module):
    """Single-head attention with a post-norm, and (unless ``no_ffn``) an FFN over the
    concatenated source and message."""

    def __init__(self, d_model: int, no_ffn: bool = False, ffn_dim_expansion: int = 4):
        super().__init__()
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.no_ffn = no_ffn
        if not no_ffn:
            hidden = 2 * d_model * ffn_dim_expansion
            self.mlp_0 = nn.Linear(2 * d_model, hidden, bias=False)
            self.mlp_2 = nn.Linear(hidden, d_model, bias=False)
            self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, source, target, h: int, w: int, attn_num_splits: int, with_shift: bool,
                attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        q, k, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        if attn_num_splits > 1:
            message = split_window_attention(q, k, v, attn_num_splits, h, w, with_shift,
                                             attn_mask)
        else:
            message = _single_head_attention(q, k, v)
        message = self.norm1(self.merge(message))
        if not self.no_ffn:
            hidden = F.gelu(self.mlp_0(torch.cat([source, message], dim=-1)))
            message = self.norm2(self.mlp_2(hidden))
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, ffn_dim_expansion: int):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, True, ffn_dim_expansion)
        self.cross_attn_ffn = TransformerLayer(d_model, False, ffn_dim_expansion)


class FeatureTransformer(nn.Module):
    """Blocks of (self attention, cross attention + FFN); both images go through as one
    batch, each attending across to the other. Shifted windows on odd blocks."""

    def __init__(self, d_model: int = 128, num_layers: int = 6, ffn_dim_expansion: int = 4):
        super().__init__()
        self.layers = nn.ModuleList([TransformerBlock(d_model, ffn_dim_expansion)
                                     for _ in range(num_layers)])

    def forward(self, feature0: torch.Tensor, feature1: torch.Tensor, attn_num_splits: int):
        b, h, w, c = feature0.shape
        f0, f1 = feature0.reshape(b, h * w, c), feature1.reshape(b, h * w, c)
        attn_mask = (shift_window_attn_mask(h, w, attn_num_splits, feature0.device)
                     if attn_num_splits > 1 else None)
        for i, block in enumerate(self.layers):
            with_shift = attn_num_splits > 1 and i % 2 == 1
            src = torch.cat([f0, f1], dim=0)
            src = block.self_attn(src, src, h, w, attn_num_splits, with_shift, attn_mask)
            f0s, f1s = src.chunk(2, dim=0)
            src = block.cross_attn_ffn(src, torch.cat([f1s, f0s], dim=0), h, w,
                                       attn_num_splits, with_shift, attn_mask)
            f0, f1 = src.chunk(2, dim=0)
        return f0.reshape(b, h, w, c), f1.reshape(b, h, w, c)


def _window_offsets(radius: int, device, x_only: bool = False) -> torch.Tensor:
    """((2r+1)^2, 2) (x, y) offsets of a square window, row-major, or the (2r+1, 2) offsets
    of a horizontal one."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    if x_only:
        return torch.stack([r, torch.zeros_like(r)], dim=-1)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx, dy], dim=-1).reshape(-1, 2)


def _in_image(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return ((coords[..., 0] >= 0) & (coords[..., 0] <= w - 1)
            & (coords[..., 1] >= 0) & (coords[..., 1] <= h - 1))


def global_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor) -> torch.Tensor:
    """Global matching: (B, H, W, C) features -> flow (B, H, W, 2)."""
    b, h, w, c = feature0.shape
    corr = torch.einsum("blc,bmc->blm", feature0.reshape(b, h * w, c).float(),
                        feature1.reshape(b, h * w, c).float()) / c ** 0.5
    prob = torch.softmax(corr, dim=-1)
    grid = coords_grid(h, w, feature0.device).reshape(1, h * w, 2)
    correspondence = torch.einsum("blm,mx->blx", prob, grid[0])
    return (correspondence - grid).reshape(b, h, w, 2)


def local_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """Matching in a (2r+1)^2 window around each pixel; positions outside the image get
    logit -1e4. (B, H, W, C) -> flow (B, H, W, 2)."""
    b, h, w, c = feature0.shape
    grid = coords_grid(h, w, feature0.device).reshape(1, h * w, 1, 2)
    coords = (grid + _window_offsets(radius, feature0.device)[None, None]).expand(b, -1, -1, -1)
    sampled = bilinear_sample(feature1, coords)  # (B, HW, win^2, C)
    corr = torch.einsum("blc,blyc->bly", feature0.reshape(b, h * w, c).float(),
                        sampled.float()) / c ** 0.5
    corr = torch.where(_in_image(coords, h, w), corr, -1e4)
    prob = torch.softmax(corr, dim=-1)
    correspondence = torch.einsum("bly,blyx->blx", prob, coords)
    return (correspondence - grid[:, :, 0]).reshape(b, h, w, 2)


def global_correlation_softmax_stereo(feature0: torch.Tensor,
                                      feature1: torch.Tensor) -> torch.Tensor:
    """Horizontal global matching of rectified views: candidates right of the query are
    masked so that disparity (x_query - x_match) stays positive. -> (B, H, W, 1)."""
    b, h, w, c = feature0.shape
    corr = torch.einsum("bhic,bhjc->bhij", feature0.float(), feature1.float()) / c ** 0.5
    xg = torch.arange(w, dtype=torch.float32, device=feature0.device)
    corr = torch.where(xg[None, :] > xg[:, None], -1e9, corr)
    prob = torch.softmax(corr, dim=-1)
    correspondence = torch.einsum("bhij,j->bhi", prob, xg)
    return (xg[None, None, :] - correspondence)[..., None]


def local_correlation_softmax_stereo(feature0: torch.Tensor, feature1: torch.Tensor,
                                     radius: int) -> torch.Tensor:
    """Matching in a horizontal (2r+1) window. -> disparity (B, H, W, 1)."""
    b, h, w, c = feature0.shape
    grid = coords_grid(h, w, feature0.device).reshape(1, h * w, 1, 2)
    coords = (grid + _window_offsets(radius, feature0.device, x_only=True)[None, None]
              ).expand(b, -1, -1, -1)
    sampled = bilinear_sample(feature1, coords)  # (B, HW, 2r+1, C)
    corr = torch.einsum("blc,blyc->bly", feature0.reshape(b, h * w, c).float(),
                        sampled.float()) / c ** 0.5
    corr = torch.where(_in_image(coords, h, w), corr, -1e9)
    prob = torch.softmax(corr, dim=-1)
    correspondence = torch.einsum("bly,blyx->blx", prob, coords)
    return -(correspondence - grid[:, :, 0])[..., 0].reshape(b, h, w, 1)


def _rays(intrinsics: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """K^-1 [x, y, 1]^T of every pixel: (B, 3, H*W)."""
    grid = coords_grid(h, w, intrinsics.device).reshape(-1, 2).to(intrinsics.dtype)
    homo = torch.cat([grid, torch.ones_like(grid[:, :1])], dim=-1).T
    return torch.einsum("bij,jn->bin", torch.linalg.inv(intrinsics), homo)


def warp_with_pose_depth_candidates(feature1: torch.Tensor, intrinsics: torch.Tensor,
                                    pose: torch.Tensor, depth: torch.Tensor,
                                    clamp_min_depth: float = 1e-3) -> torch.Tensor:
    """Plane sweep: back-project every pixel at each depth candidate, move it by the
    relative pose, reproject and sample ``feature1``. ``feature1`` (B, H, W, C),
    ``intrinsics`` (B, 3, 3), ``pose`` (B, 4, 4) source -> target, ``depth`` (B, D, H, W)
    ACTUAL depths. Returns (B, D, H*W, C)."""
    b, d, h, w = depth.shape
    rot = torch.einsum("bij,bjn->bin", pose[:, :3, :3], _rays(intrinsics, h, w))
    pts = rot[:, :, None, :] * depth.reshape(b, 1, d, h * w) + pose[:, :3, 3][:, :, None, None]
    proj = torch.einsum("bij,bjdn->bidn", intrinsics, pts)  # (B, 3, D, HW)
    pix = proj[:, :2] / torch.clamp(proj[:, 2:3], min=clamp_min_depth)
    return bilinear_sample(feature1, pix.movedim(1, -1))


def correlation_softmax_depth(feature0: torch.Tensor, feature1: torch.Tensor,
                              intrinsics: torch.Tensor, pose: torch.Tensor,
                              depth_candidates: torch.Tensor,
                              depth_from_argmax: bool = False) -> torch.Tensor:
    """Plane-sweep matching over INVERSE-depth candidates (B, D, H, W); returns the matched
    inverse depth (B, H, W, 1): the softmax-weighted mean, or the arg max."""
    b, h, w, c = feature0.shape
    d = depth_candidates.shape[1]
    warped = warp_with_pose_depth_candidates(feature1, intrinsics, pose,
                                             1.0 / depth_candidates)  # (B, D, HW, C)
    corr = torch.einsum("bnc,bdnc->bdn", feature0.reshape(b, h * w, c).float(),
                        warped.float()) / c ** 0.5
    prob = torch.softmax(corr, dim=1)  # over the candidates
    cand = depth_candidates.reshape(b, d, h * w)
    if depth_from_argmax:
        depth = torch.gather(cand, 1, prob.argmax(dim=1, keepdim=True))[:, 0]
    else:
        depth = (prob * cand).sum(dim=1)
    return depth.reshape(b, h, w, 1)


def compute_flow_with_depth_pose(depth: torch.Tensor, intrinsics: torch.Tensor,
                                 pose: torch.Tensor) -> torch.Tensor:
    """The rigid flow that depth (B, H, W, ACTUAL depth) and a relative pose induce:
    (B, H, W, 2)."""
    b, h, w = depth.shape
    rot = torch.einsum("bij,bjn->bin", pose[:, :3, :3], _rays(intrinsics, h, w))
    pts = rot * depth.reshape(b, 1, h * w) + pose[:, :3, 3][:, :, None]
    proj = torch.einsum("bij,bjn->bin", intrinsics, pts)
    pix = proj[:, :2] / torch.clamp(proj[:, 2:3], min=1e-3)
    return pix.movedim(1, -1).reshape(b, h, w, 2) - coords_grid(h, w, depth.device)[None]


def local_correlation_with_flow(feature0: torch.Tensor, feature1: torch.Tensor,
                                flow: torch.Tensor, radius: int) -> torch.Tensor:
    """The correlation volume in (2r+1)^2 windows displaced by ``flow``: (B, H, W, (2r+1)^2),
    in ``feature0``'s dtype."""
    b, h, w, c = feature0.shape
    coords = (coords_grid(h, w, feature0.device).reshape(1, h * w, 1, 2)
              + _window_offsets(radius, feature0.device)[None, None]
              + flow.reshape(b, h * w, 1, 2))
    sampled = bilinear_sample(feature1, coords)
    corr = torch.einsum("blc,blyc->bly", feature0.reshape(b, h * w, c).float(),
                        sampled.float()) / c ** 0.5
    return corr.reshape(b, h, w, -1).to(feature0.dtype)


class SelfAttnPropagation(nn.Module):
    """Flow propagation by self attention: queries and keys from the features, the flow as
    the value, over the whole image or a (2r+1)^2 window (zero outside the image). The key
    is ``k_proj(q_proj(x))``, a quirk of the reference kept for its weights."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature0: torch.Tensor, flow: torch.Tensor,
                local_window_radius: int = -1) -> torch.Tensor:
        b, h, w, c = feature0.shape
        vc = flow.shape[-1]  # 2 for flow, 1 for disparity or inverse depth
        q = self.q_proj(feature0.reshape(b, h * w, c))
        k = self.k_proj(q)
        if local_window_radius > 0:
            coords = (coords_grid(h, w, feature0.device).reshape(1, h * w, 1, 2)
                      + _window_offsets(local_window_radius, feature0.device)[None, None]
                      ).expand(b, -1, -1, -1)
            k_win = bilinear_sample(k.reshape(b, h, w, c), coords)  # (B, HW, win^2, C)
            v_win = bilinear_sample(flow, coords)  # (B, HW, win^2, vc)
            logits = torch.einsum("blc,blyc->bly", q.float(), k_win.float()) / c ** 0.5
            prob = torch.softmax(logits, dim=-1).to(v_win.dtype)
            out = torch.einsum("bly,blyx->blx", prob, v_win)
        else:
            out = _single_head_attention(q, k, flow.reshape(b, h * w, vc).to(q.dtype))
        return out.reshape(b, h, w, vc)


class ConvexUpsampler(nn.Module):
    """RAFT's convex-upsampling mask head and its application."""

    def __init__(self, in_channels: int, upsample_factor: int):
        super().__init__()
        self.upsample_factor = upsample_factor
        self.conv1 = Conv2d(in_channels, 256, 3, padding=1)
        self.conv2 = Conv2d(256, upsample_factor ** 2 * 9, 1)

    def forward(self, flow: torch.Tensor, feature: torch.Tensor,
                is_depth: bool = False) -> torch.Tensor:
        x = torch.cat([flow.to(feature.dtype), feature], dim=-1)
        mask = self.conv2(F.relu(self.conv1(x)))
        return upsample_flow_with_mask(flow, mask, self.upsample_factor,
                                       scale_magnitude=not is_depth)


def upsample_flow_with_mask(flow: torch.Tensor, mask: torch.Tensor, k: int,
                            scale_magnitude: bool = True) -> torch.Tensor:
    """(B, H, W, C), (B, H, W, 9*k*k) -> (B, k*H, k*W, C): each fine pixel a convex
    combination (softmax weights) of the 3x3 zero-padded neighbourhood of its coarse pixel.
    Flow and disparity magnitudes scale by k with the resolution, depth does not."""
    b, h, w, c = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, k, k).float(), dim=3)
    fpad = F.pad(flow * k if scale_magnitude else flow, (0, 0, 1, 1, 1, 1))
    neighbors = torch.stack([fpad[:, i:i + h, j:j + w] for i in range(3) for j in range(3)],
                            dim=3)  # (B, H, W, 9, C)
    up = torch.einsum("bhwnkl,bhwnx->bhwklx", mask, neighbors.float())
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * k, w * k, c)


class SepConvGRU(nn.Module):
    """A GRU of a horizontal (1x5) then a vertical (5x1) convolutional pass."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("convz", "convr", "convq"):
                setattr(self, gate + suffix, Conv2d(cin, hidden_dim, ks, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=-1)
            z = torch.sigmoid(getattr(self, "convz" + suffix)(hx))
            r = torch.sigmoid(getattr(self, "convr" + suffix)(hx))
            q = torch.tanh(getattr(self, "convq" + suffix)(torch.cat([r * h, x], dim=-1)))
            h = (1 - z) * h + z * q
        return h


class BasicUpdateBlock(nn.Module):
    """The RAFT-style refinement: a motion encoder of the correlation and the flow, the
    GRU, a flow head, and (unless ``bilinear_up``, the depth model) a convex-mask head."""

    def __init__(self, corr_channels: int, downsample_factor: int, flow_dim: int = 2,
                 bilinear_up: bool = False):
        super().__init__()
        self.bilinear_up = bilinear_up
        self.convc1 = Conv2d(corr_channels, 256, 1)
        self.convc2 = Conv2d(256, 192, 3, padding=1)
        self.convf1 = Conv2d(flow_dim, 128, 7, padding=3)
        self.convf2 = Conv2d(128, 64, 3, padding=1)
        self.conv = Conv2d(192 + 64, 128 - flow_dim, 3, padding=1)
        self.gru = SepConvGRU(128, 128 + 128)
        self.flow_head_conv1 = Conv2d(128, 256, 3, padding=1)
        self.flow_head_conv2 = Conv2d(256, flow_dim, 3, padding=1)
        if not bilinear_up:
            self.mask_conv1 = Conv2d(128, 256, 3, padding=1)
            self.mask_conv2 = Conv2d(256, downsample_factor ** 2 * 9, 1)

    def forward(self, net, inp, corr, flow):
        flow = flow.to(net.dtype)
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        m = F.relu(self.conv(torch.cat([c, f], dim=-1)))
        inp = torch.cat([inp, m, flow], dim=-1)
        net = self.gru(net, inp)
        dflow = self.flow_head_conv2(F.relu(self.flow_head_conv1(net)))
        if self.bilinear_up:
            return net, None, dflow
        mask = self.mask_conv2(F.relu(self.mask_conv1(net)))
        return net, mask, dflow


def _bilinear_resize_flow(flow: torch.Tensor, scale: int) -> torch.Tensor:
    """x``scale`` bilinear upsample with align-corners sampling, the magnitude scaled."""
    b, h, w, _ = flow.shape
    ys = torch.linspace(0.0, h - 1.0, h * scale, device=flow.device)
    xs = torch.linspace(0.0, w - 1.0, w * scale, device=flow.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy], dim=-1)[None].expand(b, -1, -1, -1)
    return bilinear_sample(flow, coords) * scale


class UniMatch(nn.Module):
    """``forward(img0, img1, ...)``: images (B, H, W, 3) in [0, 255] (normalised inside for
    every task) -> for the ``task`` the model was built for, "flow": flow (B, H, W, 2) in
    pixels; "stereo": positive disparity
    (B, H, W), ``img1`` the right view; "depth": depth (B, H, W), given ``intrinsics``
    (B, 3, 3) and the relative ``pose`` (B, 4, 4), ``min_depth``/``max_depth`` the
    INVERSE-depth range of ``num_depth_candidates`` candidates. H and W: multiples of
    ``upsample_factor * 2 ** (num_scales - 1) * max(attn_splits_list)`` (the wrappers of
    ``utils/optical_flow.py`` pad to 16 for the default config)."""

    def __init__(self, config: UniMatchConfig = UniMatchConfig(), task: str = "flow"):
        super().__init__()
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}; expected flow|stereo|depth")
        if task == "depth" and config.num_scales != 1:
            raise ValueError("the depth task runs one scale (num_scales=1)")
        self.config, self.task = config, task
        c = config.feature_channels
        self.backbone = CNNEncoder(c, config.num_scales)
        self.transformer = FeatureTransformer(c, config.num_transformer_layers,
                                              config.ffn_dim_expansion)
        self.feature_flow_attn = SelfAttnPropagation(c)
        if not config.reg_refine or task == "depth":
            self.upsampler = ConvexUpsampler(2 + c, config.upsample_factor)
        if config.reg_refine:
            self.refine_proj = Conv2d(c, 256, 1)
            self.refine = BasicUpdateBlock((2 * 4 + 1) ** 2, config.upsample_factor,
                                           flow_dim=2 if task == "flow" else 1,
                                           bilinear_up=task == "depth")

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                intrinsics: Optional[torch.Tensor] = None, pose: Optional[torch.Tensor] = None,
                min_depth: float = 1.0 / 0.5, max_depth: float = 1.0 / 10,
                num_depth_candidates: int = 64, depth_from_argmax: bool = False
                ) -> torch.Tensor:
        cfg, task = self.config, self.task
        if task == "depth":
            if intrinsics is None or pose is None:
                raise ValueError("the depth task needs intrinsics and pose")
            inv_lo, inv_hi = min(min_depth, max_depth), max(min_depth, max_depth)
        dtype = self.backbone.conv1.weight.dtype
        mean = torch.tensor([0.485, 0.456, 0.406], device=img0.device) * 255
        std = torch.tensor([0.229, 0.224, 0.225], device=img0.device) * 255
        img0 = (img0.float() - mean) / std
        img1 = (img1.float() - mean) / std

        feats = self.backbone(torch.cat([img0, img1], dim=0).to(dtype))[::-1]  # low to high

        flow = None
        for scale_idx in range(cfg.num_scales):
            feature0, feature1 = feats[scale_idx].chunk(2, dim=0)
            feature0_ori, feature1_ori = feature0, feature1
            if scale_idx > 0:
                flow = _bilinear_resize_flow(flow, 2)
            if flow is not None:
                flow = flow.detach()
                if task == "stereo":  # disparity -> a horizontal displacement
                    feature1 = flow_warp(feature1, torch.cat([-flow, torch.zeros_like(flow)],
                                                             dim=-1))
                else:
                    feature1 = flow_warp(feature1, flow)

            attn_splits = cfg.attn_splits_list[scale_idx]
            corr_radius = cfg.corr_radius_list[scale_idx]
            prop_radius = cfg.prop_radius_list[scale_idx]

            # the positional encoding, repeated in every split window
            b, h, w, c = feature0.shape
            if attn_splits > 1:
                pos = position_embedding_sine(h // attn_splits, w // attn_splits, c // 2,
                                              device=feature0.device)
                pos = pos.repeat(attn_splits, attn_splits, 1)[None]
            else:
                pos = position_embedding_sine(h, w, c // 2, device=feature0.device)[None]
            feature0 = feature0 + pos.to(feature0.dtype)
            feature1 = feature1 + pos.to(feature1.dtype)

            feature0, feature1 = self.transformer(feature0, feature1, attn_splits)

            if task == "depth":
                ds = cfg.upsample_factor * 2 ** (cfg.num_scales - 1 - scale_idx)
                intrinsics_curr = torch.cat([intrinsics[:, :2] / ds, intrinsics[:, 2:]], dim=1)
                cands = torch.linspace(min_depth, max_depth, num_depth_candidates,
                                       device=feature0.device).reshape(1, -1, 1, 1).expand(
                                           b, num_depth_candidates, h, w)
                flow_pred = correlation_softmax_depth(feature0, feature1, intrinsics_curr,
                                                      pose, cands, depth_from_argmax)
            elif corr_radius == -1:
                flow_pred = (global_correlation_softmax_stereo(feature0, feature1)
                             if task == "stereo"
                             else global_correlation_softmax(feature0, feature1))
            else:
                flow_pred = (local_correlation_softmax_stereo(feature0, feature1, corr_radius)
                             if task == "stereo"
                             else local_correlation_softmax(feature0, feature1, corr_radius))
            flow = flow + flow_pred if flow is not None else flow_pred
            if task == "stereo":
                flow = flow.clamp(min=0.0)  # disparity is positive

            flow = self.feature_flow_attn(feature0, flow.detach(),
                                          local_window_radius=prop_radius)

            if scale_idx < cfg.num_scales - 1:
                continue
            up_mask = None
            if cfg.reg_refine:
                for _ in range(cfg.num_reg_refine):
                    flow = flow.detach()
                    if task == "stereo":
                        displace = torch.cat([-flow, torch.zeros_like(flow)], dim=-1)
                    elif task == "depth":
                        displace = compute_flow_with_depth_pose(1.0 / flow[..., 0],
                                                                intrinsics_curr, pose)
                    else:
                        displace = flow
                    correlation = local_correlation_with_flow(feature0_ori, feature1_ori,
                                                              displace, radius=4)
                    net, inp = self.refine_proj(feature0).chunk(2, dim=-1)
                    net, up_mask, residual = self.refine(torch.tanh(net), F.relu(inp),
                                                         correlation, flow)
                    if task == "depth":
                        flow = torch.clamp(flow - residual.float(), inv_lo, inv_hi)
                    else:
                        flow = flow + residual.float()
                    if task == "stereo":
                        flow = flow.clamp(min=0.0)

            # the final upsample to the image's resolution
            if task == "stereo":
                if cfg.reg_refine:
                    flow_up = upsample_flow_with_mask(flow, up_mask, cfg.upsample_factor)
                else:
                    pad = torch.cat([-flow, torch.zeros_like(flow)], dim=-1)
                    flow_up = -self.upsampler(pad, feature0)[..., :1]
                return flow_up[..., 0]
            if task == "depth":
                pad = torch.cat([flow, torch.zeros_like(flow)], dim=-1)
                inv_up = self.upsampler(pad, feature0, is_depth=True)[..., :1]
                # the convex unfold's zero padding can pull values out of range
                return 1.0 / torch.clamp(inv_up, inv_lo, inv_hi)[..., 0]
            if cfg.reg_refine:
                return upsample_flow_with_mask(flow, up_mask, cfg.upsample_factor)
            return self.upsampler(flow, feature0)


def build_unimatch(config: UniMatchConfig = UniMatchConfig.lkgd(), task: str = "flow",
                   device="cuda", dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None) -> UniMatch:
    """A frozen UniMatch in eval mode on ``device`` (the card unless the CPU is named), its
    weights random from ``generator`` (on ``device``) when one is given, else uninitialised
    for ``load_state_dict``."""
    device = require_device(device)
    model = materialize(lambda: UniMatch(config, task), device, dtype)
    if generator is not None:
        init_params(model, generator)
    return model.eval().requires_grad_(False)
