"""Control-image preprocessors (counterpart of ``lkgd_tpu/utils/control_preprocess.py``):
the classical ones run here with cv2 and numpy (imported when one is called); model-based
ones (depth, pose, line art, flow) are callables registered at run time. Users of
``--mode controlnet`` prepare their ``--control-video`` with them."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def canny(image: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """[0,1] (H,W,3) -> [0,1] (H,W,3) canny edge map."""
    import cv2

    edges = cv2.Canny((image * 255).astype(np.uint8), low, high)
    return np.repeat(edges[..., None], 3, axis=-1).astype(np.float32) / 255.0


def tile(image: np.ndarray, down: int = 8) -> np.ndarray:
    """Tile control: blur by down/up scaling."""
    import cv2

    h, w = image.shape[:2]
    small = cv2.resize(image, (w // down, h // down), interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


def ip2p(image: np.ndarray) -> np.ndarray:
    """InstructPix2Pix control = the raw image."""
    return image


def softedge_sobel(image: np.ndarray) -> np.ndarray:
    """Classical soft edges (an HED stand-in): the normalised Sobel magnitude."""
    import cv2

    gray = cv2.cvtColor((image * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0, ksize=3)
    gy = cv2.Sobel(gray, cv2.CV_32F, 0, 1, ksize=3)
    mag = np.sqrt(gx**2 + gy**2)
    mag = mag / (mag.max() + 1e-8)
    return np.repeat(mag[..., None], 3, axis=-1).astype(np.float32)


_PROCESSORS: Dict[str, Callable] = {
    "canny": canny,
    "tile": tile,
    "ip2p": ip2p,
    "softedge": softedge_sobel,
}

# model-based processors registered at run time (depth, openpose, lineart, flow, ...)
_EXTERNAL: Dict[str, Callable] = {}


def register_processor(name: str, fn: Callable) -> None:
    _EXTERNAL[name] = fn


def control_preprocess(images: np.ndarray, control_type: str) -> np.ndarray:
    """(T, H, W, 3) [0,1] -> control maps, one per frame."""
    fn = _EXTERNAL.get(control_type) or _PROCESSORS.get(control_type)
    if fn is None:
        raise KeyError(f"unknown control type {control_type!r}; classical: "
                       f"{sorted(_PROCESSORS)}, registered: {sorted(_EXTERNAL)}")
    return np.stack([fn(img) for img in np.asarray(images)])
