"""Point-track conditioning helpers (the port's own numpy copy of
``lkgd_tpu/utils/track_helpers.py``, held equal to it by a test): a uniform query grid,
the filter that keeps tracks that move, points and track arrows rendered as RGBA maps, and
``TrackDataset`` (frame pairs with their tracks rendered), which reads videos through the
port's ``data/video_io.py``. It imports nothing of the JAX package."""

from __future__ import annotations

from typing import Optional

import numpy as np


def grid_queries(grid_size: int, height: int, width: int, t: int = 0) -> np.ndarray:
    """Uniform query grid (t, x, y) rows (reference util.py get_points_on_a_grid :441)."""
    ys = np.linspace(height / (grid_size + 1), height * grid_size / (grid_size + 1), grid_size)
    xs = np.linspace(width / (grid_size + 1), width * grid_size / (grid_size + 1), grid_size)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    pts = np.stack([np.full(gx.size, t), gx.reshape(-1), gy.reshape(-1)], axis=-1)
    return pts.astype(np.float32)


def filter_tracks_by_distance(tracks: np.ndarray, visibility: Optional[np.ndarray] = None,
                              min_dist: float = 8.0) -> np.ndarray:
    """Keep tracks that actually move (total displacement >= min_dist) and are visible
    (reference filter_dist/filter_tracks semantics). tracks: (T, N, 2)."""
    disp = np.linalg.norm(tracks[-1] - tracks[0], axis=-1)
    keep = disp >= min_dist
    if visibility is not None:
        keep &= visibility.all(axis=0)
    return keep


def draw_points(height: int, width: int, points: np.ndarray, radius: int = 4,
                colors: Optional[np.ndarray] = None) -> np.ndarray:
    """Render points as an RGBA map (reference draw_points :489): gaussian-soft dots,
    alpha marks presence. points: (N, 2) xy. Returns (H, W, 4) float32."""
    out = np.zeros((height, width, 4), np.float32)
    yy, xx = np.mgrid[:height, :width]
    if colors is None:
        rng = np.random.default_rng(0)
        colors = rng.uniform(0.3, 1.0, size=(len(points), 3)).astype(np.float32)
    for (x, y), c in zip(points, colors):
        d2 = (xx - x) ** 2 + (yy - y) ** 2
        a = np.exp(-d2 / (2.0 * radius**2)).astype(np.float32)
        mask = a > 0.05
        out[..., :3] = np.where(mask[..., None], c * a[..., None] +
                                out[..., :3] * (1 - a[..., None]), out[..., :3])
        out[..., 3] = np.maximum(out[..., 3], a)
    return out


def draw_tracks(height: int, width: int, tracks: np.ndarray, radius: int = 3
                ) -> np.ndarray:
    """Render tracks as arrows start->end in an RGBA map (reference draw_tracks :456).
    tracks: (T, N, 2). Returns (H, W, 4)."""
    import cv2

    canvas = np.zeros((height, width, 4), np.float32)
    img = np.zeros((height, width, 3), np.uint8)
    rng = np.random.default_rng(1)
    for n in range(tracks.shape[1]):
        color = tuple(int(v) for v in rng.integers(80, 255, 3))
        p0 = tuple(int(v) for v in tracks[0, n])
        p1 = tuple(int(v) for v in tracks[-1, n])
        cv2.arrowedLine(img, p0, p1, color, thickness=radius, tipLength=0.2)
    canvas[..., :3] = img.astype(np.float32) / 255.0
    canvas[..., 3] = (img.sum(-1) > 0).astype(np.float32)
    return canvas


class TrackDataset:
    """Frame pairs + point tracks rendered as RGBA point maps (reference
    `utils/dataset.py:997-1220`, proc_frame_with_tracks :1060-1113). Tracks come from
    precomputed annotations (npz with 'tracks' (T,N,2) [+ 'visibility']) per video —
    the reference generates them with CoTracker."""

    def __init__(self, video_folder: str, tracks_folder: str, sample_size=512,
                 pair_stride: int = 8, min_track_dist: float = 8.0):
        import glob
        import os

        self.videos = sorted(glob.glob(os.path.join(video_folder, "*.mp4")))
        self.tracks_folder = tracks_folder
        self.sample_size = (sample_size, sample_size) if isinstance(sample_size, int) \
            else tuple(sample_size)
        self.pair_stride = pair_stride
        self.min_track_dist = min_track_dist

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx: int):
        import os

        from lkgd_torch.data.video_io import process_frames, read_video_frames

        path = self.videos[idx]
        frames, fps = read_video_frames(path)
        rng = np.random.default_rng()
        t0 = int(rng.integers(0, max(len(frames) - self.pair_stride, 1)))
        t1 = min(t0 + self.pair_stride, len(frames) - 1)
        pair = process_frames(frames[[t0, t1]], *self.sample_size)

        name = os.path.splitext(os.path.basename(path))[0]
        track_path = os.path.join(self.tracks_folder, f"{name}.npz")
        h, w = self.sample_size
        if os.path.exists(track_path):
            data = np.load(track_path)
            tracks = data["tracks"]  # (T, N, 2) in original resolution
            vis = data.get("visibility")
            sy = h / frames.shape[1]
            sx = w / frames.shape[2]
            tracks = tracks * np.asarray([sx, sy], np.float32)
            keep = filter_tracks_by_distance(tracks[[t0, t1]], None, self.min_track_dist)
            sel = tracks[:, keep]
            point_map = draw_points(h, w, sel[t0]) if keep.any() else np.zeros((h, w, 4), np.float32)
            track_map = draw_tracks(h, w, sel[[t0, t1]]) if keep.any() else point_map
        else:
            point_map = np.zeros((h, w, 4), np.float32)
            track_map = point_map
        return {"pixel_values": pair * 2.0 - 1.0, "point_map": point_map,
                "track_map": track_map, "fps": np.float32(fps)}
