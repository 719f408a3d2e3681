"""Motion-bucket <-> flow-magnitude calibration (a numpy copy of
``lkgd_tpu/utils/motion.py``, itself a port of the reference ``utils/motion_helper.py``:
the linear fits between SVD's ``motion_bucket_id``, the frame rate and the mean optical-flow
magnitude of a clip)."""

from __future__ import annotations

import numpy as np

MOTION_PARAM = np.array([0.07218373, 2.6522603, 0.00323807, 0.2210316])
MOTION_PARAM_SIMPLE = (0.06741976, 1.15129627)


def motion2flow(fps: float, motion_bucket_id: float) -> float:
    v = np.array([motion_bucket_id / fps, 1.0 / fps, motion_bucket_id, 1.0])
    return float((v * MOTION_PARAM).sum())


def flow2motion(fps: float, motion_score: float) -> int:
    mb = (motion_score - MOTION_PARAM[3] - MOTION_PARAM[1] / fps) / (
        MOTION_PARAM[0] / fps + MOTION_PARAM[2])
    return int(np.clip(mb, 0, 255))


def bucket2motion(motion_bucket_id: float) -> float:
    return motion_bucket_id * MOTION_PARAM_SIMPLE[0] + MOTION_PARAM_SIMPLE[1]


def motion2bucket(motion_score: float) -> int:
    return int(np.clip((motion_score - MOTION_PARAM_SIMPLE[1]) / MOTION_PARAM_SIMPLE[0],
                       0, 255))


def cal_motion_bucket_ids(flows) -> np.ndarray:
    """Per-clip motion buckets from the mean |flow| of each clip."""
    return np.array([motion2bucket(float(np.abs(np.asarray(f)).mean())) for f in flows],
                    np.int32)
