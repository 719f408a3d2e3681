"""OpenPose body (counterpart of ``lkgd_tpu/models/openpose.py``): the CMU two-branch CPM of
controlnet_aux (``bodypose_model``, ``body_pose_model.pth``), the ``openpose`` annotator.

A VGG-19 front (``model0``: ten 3x3 convolutions with ReLU and three 2x2 max pools, stride 8)
and six stages of two branches, 38 part-affinity-field channels (``L1``) and 19 keypoint
heatmaps (``L2``); stage 1 is three 3x3 convolutions at 128, a 1x1 at 512 and a 1x1 out, each
later stage five 7x7 convolutions at 128, a 1x1 at 128 and a 1x1 out over the concatenated
[PAFs, heatmaps, front features]. Module names are the checkpoint's
(``model0.conv1_1``, ``model1_1.conv5_1_CPM_L1``, ``model6_2.Mconv7_stage6_L2``), so it loads
with ``load_state_dict(strict=True)``. Activations are channels-last at the boundary.

The decoding is host cv2 and numpy, as in the JAX package (copies of its ``find_peaks``,
``match_limbs``, ``assemble_people`` and ``draw_bodypose``): Gaussian-smoothed heatmap peaks,
greedy PAF line-integral limb matching, people assembled from the limbs, the skeleton drawn
as coloured ellipses and dots on black.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lkgd_torch.models.layers import build_frozen

# (name, output channels, kernel) of each front layer; "pool" a 2x2 max pool
_BACKBONE: Tuple = (
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), "pool",
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), "pool",
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3), ("conv3_4", 256, 3),
    "pool",
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
)

# the 18 COCO keypoints' limbs and the PAF channel pair that scores each (0-indexed)
LIMB_SEQ = ((1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
            (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
            (2, 16), (5, 17))
MAP_IDX = ((12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1), (2, 3),
           (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35), (32, 33),
           (36, 37), (18, 19), (26, 27))
_COLORS = ((255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
           (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
           (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
           (255, 0, 255), (255, 0, 170), (255, 0, 85))


@dataclasses.dataclass(frozen=True)
class OpenPoseConfig:
    stages: int = 6
    paf_channels: int = 38
    heatmap_channels: int = 19
    stride: int = 8  # three pools


class _Branch(nn.Module):
    """One stage's branch ``l`` (1: PAFs, 2: heatmaps), its convolutions named as the
    checkpoint names them; ReLU after each but the last."""

    def __init__(self, stage: int, l_idx: int, cin: int, cout: int):
        super().__init__()
        if stage == 1:
            specs = [(f"conv5_{i}_CPM_L{l_idx}", 128, 3) for i in (1, 2, 3)]
            specs += [(f"conv5_4_CPM_L{l_idx}", 512, 1), (f"conv5_5_CPM_L{l_idx}", cout, 1)]
        else:
            specs = [(f"Mconv{i}_stage{stage}_L{l_idx}", 128, 7) for i in range(1, 6)]
            specs += [(f"Mconv6_stage{stage}_L{l_idx}", 128, 1),
                      (f"Mconv7_stage{stage}_L{l_idx}", cout, 1)]
        self.names = [name for name, _, _ in specs]
        for name, c, k in specs:
            self.add_module(name, nn.Conv2d(cin, c, k, padding=k // 2))
            cin = c

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for name in self.names[:-1]:
            h = F.relu(getattr(self, name)(h))
        return getattr(self, self.names[-1])(h)


class BodyPoseModel(nn.Module):
    """(B, H, W, 3) in [-0.5, 0.5] -> (PAFs (B, H/8, W/8, 38), heatmaps (B, H/8, W/8, 19))."""

    def __init__(self, config: OpenPoseConfig = OpenPoseConfig()):
        super().__init__()
        self.config = config
        self.model0 = nn.Module()
        cin = 3
        for spec in _BACKBONE:
            if spec != "pool":
                name, c, k = spec
                self.model0.add_module(name, nn.Conv2d(cin, c, k, padding=k // 2))
                cin = c
        cat = config.paf_channels + config.heatmap_channels + cin
        for stage in range(1, config.stages + 1):
            for l_idx, cout in ((1, config.paf_channels), (2, config.heatmap_channels)):
                self.add_module(f"model{stage}_{l_idx}",
                                _Branch(stage, l_idx, cin if stage == 1 else cat, cout))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        for spec in _BACKBONE:
            h = F.max_pool2d(h, 2, 2) if spec == "pool" else F.relu(
                getattr(self.model0, spec[0])(h))
        feats = h
        paf, heat = self.model1_1(feats), self.model1_2(feats)
        for stage in range(2, self.config.stages + 1):
            h = torch.cat([paf, heat, feats], dim=1)
            paf = getattr(self, f"model{stage}_1")(h)
            heat = getattr(self, f"model{stage}_2")(h)
        return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ host decoding
def find_peaks(heatmaps: np.ndarray, threshold: float = 0.1) -> List[List[Tuple]]:
    """The local maxima above ``threshold`` of each part channel of (H, W, 19) heatmaps
    (background dropped) after a sigma-3 Gaussian blur: per part a list of
    (x, y, score, global peak id)."""
    import cv2

    all_peaks: List[List[Tuple]] = []
    peak_id = 0
    for part in range(heatmaps.shape[-1] - 1):
        m = cv2.GaussianBlur(heatmaps[..., part], (0, 0), 3)
        up = np.zeros_like(m)
        up[1:, :] = m[:-1, :]
        down = np.zeros_like(m)
        down[:-1, :] = m[1:, :]
        left = np.zeros_like(m)
        left[:, 1:] = m[:, :-1]
        right = np.zeros_like(m)
        right[:, :-1] = m[:, 1:]
        is_peak = ((m >= up) & (m >= down) & (m >= left) & (m >= right)
                   & (m > threshold))
        ys, xs = np.nonzero(is_peak)
        peaks = []
        for x, y in zip(xs, ys):
            peaks.append((int(x), int(y), float(heatmaps[y, x, part]), peak_id))
            peak_id += 1
        all_peaks.append(peaks)
    return all_peaks


def match_limbs(pafs: np.ndarray, all_peaks: List[List[Tuple]], image_h: int,
                n_samples: int = 10, score_threshold: float = 0.05):
    """Greedy PAF line-integral matching (controlnet_aux ``util.py``): per limb a list of
    (peak id a, peak id b, score, index a, index b)."""
    connection_all = []
    for limb, (ka, kb) in enumerate(LIMB_SEQ):
        cand_a, cand_b = all_peaks[ka], all_peaks[kb]
        if not cand_a or not cand_b:
            connection_all.append([])
            continue
        candidates = []
        for ia, a in enumerate(cand_a):
            for ib, b in enumerate(cand_b):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float32)
                norm = max(float(np.linalg.norm(vec)), 1e-4)
                vec = vec / norm
                xs = np.round(np.linspace(a[0], b[0], n_samples)).astype(int)
                ys = np.round(np.linspace(a[1], b[1], n_samples)).astype(int)
                scores = (pafs[ys, xs, MAP_IDX[limb][0]] * vec[0]
                          + pafs[ys, xs, MAP_IDX[limb][1]] * vec[1])
                prior = min(0.5 * image_h / norm - 1, 0.0)  # long limbs need more support
                mean_score = float(scores.mean()) + prior
                if (scores > score_threshold).sum() > 0.8 * n_samples and mean_score > 0:
                    candidates.append((ia, ib, mean_score, mean_score + a[2] + b[2]))
        candidates.sort(key=lambda c: c[2], reverse=True)
        used_a, used_b, conns = set(), set(), []
        for ia, ib, score, _total in candidates:
            if ia not in used_a and ib not in used_b:
                conns.append((cand_a[ia][3], cand_b[ib][3], score, ia, ib))
                used_a.add(ia)
                used_b.add(ib)
                if len(conns) >= min(len(cand_a), len(cand_b)):
                    break
        connection_all.append(conns)
    return connection_all


def assemble_people(all_peaks, connection_all):
    """The limbs grouped into people: each a row of 18 peak ids (-1 missing), the summed
    score and the part count; weak or small groups dropped."""
    candidate = np.array([p for peaks in all_peaks for p in peaks], np.float32)
    subsets: List[np.ndarray] = []
    for limb, conns in enumerate(connection_all):
        ka, kb = LIMB_SEQ[limb]
        for pid_a, pid_b, score, _ia, _ib in conns:
            found = [s for s in subsets if s[ka] == pid_a or s[kb] == pid_b]
            if len(found) == 1:
                s = found[0]
                if s[kb] != pid_b:
                    s[kb] = pid_b
                    s[19] += 1
                    s[18] += candidate[int(pid_b), 2] + score
                elif s[ka] != pid_a:
                    s[ka] = pid_a
                    s[19] += 1
                    s[18] += candidate[int(pid_a), 2] + score
            elif len(found) == 2:  # two halves of one person
                s1, s2 = found
                if not np.any((s1[:18] >= 0) & (s2[:18] >= 0)):
                    s1[:18] = np.where(s2[:18] >= 0, s2[:18], s1[:18])
                    s1[18:] += s2[18:]
                    s1[18] += score
                    subsets.remove(s2)
                else:
                    s1[kb] = pid_b
                    s1[19] += 1
                    s1[18] += candidate[int(pid_b), 2] + score
            else:
                s = np.full(20, -1.0)
                s[ka], s[kb] = pid_a, pid_b
                s[19] = 2
                s[18] = candidate[int(pid_a), 2] + candidate[int(pid_b), 2] + score
            if len(found) == 0:
                subsets.append(s)
    subsets = [s for s in subsets if s[19] >= 4 and s[18] / s[19] >= 0.4]
    return candidate, subsets


def draw_bodypose(h: int, w: int, candidate: np.ndarray,
                  subsets: Sequence[np.ndarray]) -> np.ndarray:
    """The ControlNet skeleton: coloured limb ellipses at 60% and joint dots on black,
    (H, W, 3) [0, 1]."""
    import cv2

    canvas = np.zeros((h, w, 3), np.uint8)
    for limb in range(17):
        ka, kb = LIMB_SEQ[limb]
        for s in subsets:
            if s[ka] < 0 or s[kb] < 0:
                continue
            xa, ya = candidate[int(s[ka]), :2]
            xb, yb = candidate[int(s[kb]), :2]
            mx, my = (xa + xb) / 2, (ya + yb) / 2
            length = float(np.hypot(xa - xb, ya - yb))
            angle = float(np.degrees(np.arctan2(ya - yb, xa - xb)))
            poly = cv2.ellipse2Poly((int(mx), int(my)), (int(length / 2), 4), int(angle),
                                    0, 360, 1)
            cv2.fillConvexPoly(canvas, poly, _COLORS[limb])
    canvas = (canvas * 0.6).astype(np.uint8)
    for part in range(18):
        for s in subsets:
            if s[part] < 0:
                continue
            x, y = candidate[int(s[part]), :2]
            cv2.circle(canvas, (int(x), int(y)), 4, _COLORS[part], thickness=-1)
    return canvas.astype(np.float32) / 255.0


def build_openpose(config: OpenPoseConfig = OpenPoseConfig(), device="cuda",
                   generator: Optional[torch.Generator] = None) -> BodyPoseModel:
    """A frozen fp32 ``BodyPoseModel`` on ``device`` (the card unless the CPU is named),
    random from ``generator`` when one is given, else uninitialised for
    ``load_state_dict``."""
    return build_frozen(lambda: BodyPoseModel(config), device, generator)


def openpose_maps(model: BodyPoseModel, image: np.ndarray, detect_resolution: int = 368):
    """(H, W, 3) [0, 1] -> the PAFs (H, W, 38) and heatmaps (H, W, 19) at the image's size:
    cv2 ``INTER_LINEAR`` to ``detect_resolution`` rows (both sides rounded up to the stride),
    the model on ``x - 0.5``, cv2 ``INTER_CUBIC`` back."""
    import cv2

    stride = model.config.stride
    device = next(model.parameters()).device
    h, w = image.shape[:2]
    scale = detect_resolution / h
    nh = -(-int(h * scale) // stride) * stride
    nw = -(-int(w * scale) // stride) * stride
    small = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    with torch.no_grad():
        x = torch.from_numpy(np.asarray(small, np.float32)[None]).to(device) - 0.5
        paf, heat = (y[0].cpu().numpy() for y in model(x))
    return (cv2.resize(paf, (w, h), interpolation=cv2.INTER_CUBIC),
            cv2.resize(heat, (w, h), interpolation=cv2.INTER_CUBIC))


def make_openpose_processor(model: BodyPoseModel, detect_resolution: int = 368
                            ) -> Callable[[np.ndarray], np.ndarray]:
    """The ``openpose`` annotator, (H, W, 3) [0, 1] -> (H, W, 3) [0, 1] skeleton map."""

    def process(image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        paf, heat = openpose_maps(model, image, detect_resolution)
        peaks = find_peaks(heat)
        candidate, subsets = assemble_people(peaks, match_limbs(paf, peaks, h))
        return draw_bodypose(h, w, candidate, subsets)

    return process
