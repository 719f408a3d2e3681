"""Track-guided frame-pair feature fusion (counterpart of ``lkgd_tpu/ops/track_fusion.py``),
the joint-frame mechanism of the 2D transformer block: point tracks align features between
the paired frames of a (src, dst) batch. The dst features are gathered at the dst track
points and visibility-averaged onto the src coordinates, fused with the src features
through a zero-init 3x3 convolution, and the dst half of the fusion output is routed back
through the same tracks onto the dst coordinates. Both streams receive their fusion as a
residual add.

Plain PyTorch: ``take_along_axis`` is ``torch.gather`` and ``.at[idx].add`` is
``scatter_add_``, batched over the pairs. On the card ``scatter_add_`` adds with atomics in
an order that changes from run to run, so two runs agree to rounding, not to the bit.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def quantize_tracks(src_tracks: torch.Tensor, dst_tracks: torch.Tensor, feat_h: int,
                    feat_w: int, downsample: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-space tracks (B, Nt, 2) xy -> flat token indices (B, Nt) int64 on the feature
    grid: divide by ``downsample``, truncate toward zero, clamp, ``x + y * W``."""

    def flat(tr):
        t = (tr / downsample).to(torch.int32)
        x = torch.clamp(t[..., 0], 0, feat_w - 1)
        y = torch.clamp(t[..., 1], 0, feat_h - 1)
        return (x + y * feat_w).long()

    return flat(src_tracks), flat(dst_tracks)


def _scatter_mean(vals: torch.Tensor, idx: torch.Tensor, vis: torch.Tensor,
                  n_tokens: int) -> torch.Tensor:
    """Visibility-masked scatter-add of (B, Nt, C) onto (B, n_tokens, C), divided by the
    per-token visibility count plus 1e-6."""
    b, _, c = vals.shape
    vals = vals * vis[..., None]
    canvas = vals.new_zeros((b, n_tokens, c)).scatter_add_(
        1, idx[..., None].expand(-1, -1, c), vals)
    count = vals.new_zeros((b, n_tokens, 1)).scatter_add_(1, idx[..., None], vis[..., None])
    return canvas / (count + 1e-6)


def track_scatter_fusion(hidden: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor,
                         visibility: torch.Tensor,
                         conv_fuse: Callable[[torch.Tensor], torch.Tensor],
                         feat_h: int, feat_w: int) -> torch.Tensor:
    """``hidden`` (2B, N, C) with the src frames at ::2 and the dst frames at 1::2;
    ``src_idx`` / ``dst_idx`` (B, Nt) flat token ids; ``visibility`` (B, Nt) in {0, 1};
    ``conv_fuse`` maps (B, H, W, 2C) -> 2C. Returns ``hidden`` with both streams' fusion
    residuals added."""
    src, dst = hidden[::2], hidden[1::2]
    b, n, c = src.shape
    vis = visibility.to(src.dtype)

    def gather(x, idx):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    aligned = _scatter_mean(gather(dst, dst_idx), src_idx, vis, n)
    cat = torch.cat([src, aligned], dim=-1).reshape(b, feat_h, feat_w, 2 * c)
    fused = conv_fuse(cat).reshape(b, n, 2 * c)
    src_fused, dst_scattered = fused.chunk(2, dim=-1)
    dst_fused = _scatter_mean(gather(dst_scattered, src_idx), dst_idx, vis, n)
    return torch.stack([src + src_fused, dst + dst_fused], dim=1).reshape(hidden.shape)
