"""Chained-flow point tracker (counterpart of ``lkgd_tpu/utils/point_tracker.py``): the
track pseudo-labels that ``utils/track_helpers.py`` reads for ``ops/track_fusion.py``.

Grid queries on frame 0 are carried through the clip by the bidirectional RAFT flow of each
consecutive pair, sampled bilinearly at the sub-pixel track positions (clamped into the
frame). A point is visible in a frame when the forward-backward cycle of its step is under
``fb_thresh`` pixels and it lies inside the frame; positions integrate the flow either way,
so a point that comes back validates again. Frame 0 is all visible. Frames are padded at
the bottom and right edge to a multiple of 8 for RAFT. The JAX ``lax.scan`` over frame
pairs is a Python loop over them here.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from lkgd_torch.models.raft import RAFT, raft_bidirectional_flow


def grid_queries(height: int, width: int, grid_size: Tuple[int, int] | int,
                 margin: Optional[float] = None) -> np.ndarray:
    """(N, 2) xy query points on a uniform grid, row-major; the margin defaults to half a
    cell's height."""
    if isinstance(grid_size, int):
        grid_size = (grid_size, grid_size)
    gh, gw = grid_size
    if margin is None:
        margin = height // gh // 2
    ys = np.linspace(margin, height - margin, gh)
    xs = np.linspace(margin, width - margin, gw)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gx, gy], axis=-1).reshape(-1, 2).astype(np.float32)


def sample_bilinear(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(H, W, C) sampled at (N, 2) xy positions clamped into the field -> (N, C); the
    top-left corner is clamped to (w-2, h-2), so the right and bottom edges interpolate."""
    h, w = field.shape[:2]
    x = pts[:, 0].clamp(0.0, w - 1.0)
    y = pts[:, 1].clamp(0.0, h - 1.0)
    x0 = torch.floor(x).clamp(0, w - 2).long()
    y0 = torch.floor(y).clamp(0, h - 2).long()
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    f00, f01 = field[y0, x0], field[y0, x0 + 1]
    f10, f11 = field[y0 + 1, x0], field[y0 + 1, x0 + 1]
    return (1 - fy) * ((1 - fx) * f00 + fx * f01) + fy * ((1 - fx) * f10 + fx * f11)


def make_track_fn(model: Optional[RAFT] = None, fb_thresh: float = 2.0,
                  flow_fn: Optional[Callable] = None) -> Callable:
    """``track(frames (T, H, W, 3) in [0, 1], queries (N, 2)) -> (tracks (T, N, 2) xy
    float32, visibility (T, N) bool)``, on the device of ``frames``. ``flow_fn(f1 (1, H, W,
    3), f2) -> (forward (1, H, W, 2), backward)`` replaces RAFT (the tests inject exact
    flows)."""
    if flow_fn is None:
        flow_fn = lambda f1, f2: raft_bidirectional_flow(model, f1, f2)  # noqa: E731

    @torch.no_grad()
    def track(frames: torch.Tensor, queries: torch.Tensor):
        t, h, w = frames.shape[:3]
        ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
        if (ph, pw) != (h, w):
            frames = torch.cat([frames, frames[:, :, -1:].expand(t, h, pw - w, 3)], dim=2)
            frames = torch.cat([frames, frames[:, -1:].expand(t, ph - h, pw, 3)], dim=1)
        pts = queries.float()
        tracks = [pts]
        vis = [torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)]
        for i in range(t - 1):
            fwd, bwd = flow_fn(frames[i:i + 1], frames[i + 1:i + 2])
            dflow = sample_bilinear(fwd[0], pts)
            pts = pts + dflow
            # forward-backward cycle: fwd(p) + bwd(p + fwd(p)) ~ 0 where p stays visible
            cyc = dflow + sample_bilinear(bwd[0], pts)
            consistent = torch.linalg.norm(cyc, dim=-1) < fb_thresh
            inside = ((pts[:, 0] >= 0) & (pts[:, 0] <= w - 1)
                      & (pts[:, 1] >= 0) & (pts[:, 1] <= h - 1))
            tracks.append(pts)
            vis.append(consistent & inside)
        return torch.stack(tracks), torch.stack(vis)

    return track


def track_video(model: RAFT, frames: np.ndarray, grid_size: int = 16,
                fb_thresh: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Grid queries on frame 0 carried through the whole clip on the model's device; numpy
    outputs."""
    device = next(model.parameters()).device
    h, w = frames.shape[1:3]
    queries = torch.from_numpy(grid_queries(h, w, grid_size)).to(device)
    tracks, vis = make_track_fn(model, fb_thresh)(
        torch.as_tensor(frames, dtype=torch.float32).to(device), queries)
    return tracks.cpu().numpy(), vis.cpu().numpy()
