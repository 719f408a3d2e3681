"""Flow, stereo and depth estimation around the port's UniMatch (counterpart of
``lkgd_tpu/utils/optical_flow.py``): frames resized to a multiple of the padding factor,
the model run on consecutive frame pairs as one batch (optionally both ways), the flow
resized back with its components rescaled.

The resizes are ``ops/resize.py`` ``resize_bilinear``, JAX's ``jax.image.resize(...,
"bilinear")``, which antialiases when it downsamples (``F.interpolate`` does not). Every
function runs under ``torch.no_grad()`` on the model's device, in fp32.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from lkgd_torch.models.unimatch import UniMatch
from lkgd_torch.ops.resize import resize_bilinear

FLOW_MEAN = -0.010683227330446243  # the reference's flow statistics
FLOW_STD = 5.01635217666626
PADDING_FACTOR = 16


def _padded(image_hw: Tuple[int, int]) -> Tuple[int, int]:
    h, w = image_hw
    return -(-h // PADDING_FACTOR) * PADDING_FACTOR, -(-w // PADDING_FACTOR) * PADDING_FACTOR


def _model_device(model: UniMatch) -> torch.device:
    return next(model.parameters()).device


def make_flow_fn(model: UniMatch, image_hw: Tuple[int, int]) -> Callable:
    """``flow_fn(frames)``: frames (T, H, W, 3) in [0, 1] -> forward flow (T-1, H, W, 2) in
    pixels of the (H, W) frames."""
    h, w = image_hw
    ph, pw = _padded(image_hw)

    @torch.no_grad()
    def flow_fn(frames: torch.Tensor) -> torch.Tensor:
        frames = frames.to(_model_device(model), torch.float32) * 255.0
        img0, img1 = frames[:-1], frames[1:]
        if (ph, pw) != (h, w):
            img0, img1 = resize_bilinear(img0, (ph, pw)), resize_bilinear(img1, (ph, pw))
        flow = model(img0, img1)  # (T-1, ph, pw, 2)
        if (ph, pw) != (h, w):
            flow = resize_bilinear(flow, (h, w))
            flow = flow * torch.tensor([w / pw, h / ph], device=flow.device)
        return flow

    return flow_fn


def make_bidirectional_flow_fn(model: UniMatch, image_hw: Tuple[int, int]) -> Callable:
    """(T, H, W, 3) -> (forward flow (T-1, ...), backward flow (T-1, ...)): the backward
    flow of pair i maps frame i+1 to frame i."""
    fwd = make_flow_fn(model, image_hw)

    def bidir(frames: torch.Tensor):
        return fwd(frames), fwd(frames.flip(0)).flip(0)

    return bidir


def flow_normalize(flow: torch.Tensor) -> torch.Tensor:
    """The identity, as in the reference's shipped code (kept for its API)."""
    return flow


def make_stereo_fn(model: UniMatch, image_hw: Tuple[int, int]) -> Callable:
    """``stereo_fn(left, right)``: (B, H, W, 3) views in [0, 1] -> disparity (B, H, W) in
    pixels of the (H, W) views. ``model`` is built for ``task="stereo"``."""
    h, w = image_hw
    ph, pw = _padded(image_hw)

    @torch.no_grad()
    def stereo_fn(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        device = _model_device(model)
        l, r = (x.to(device, torch.float32) * 255.0 for x in (left, right))
        if (ph, pw) != (h, w):
            l, r = resize_bilinear(l, (ph, pw)), resize_bilinear(r, (ph, pw))
        disp = model(l, r)[..., None]
        if (ph, pw) != (h, w):
            disp = resize_bilinear(disp, (h, w)) * (w / pw)
        return disp[..., 0]

    return stereo_fn


def make_depth_fn(model: UniMatch, image_hw: Tuple[int, int], min_depth: float = 0.5,
                  max_depth: float = 10.0, num_depth_candidates: int = 64) -> Callable:
    """``depth_fn(img0, img1, intrinsics (B, 3, 3), pose (B, 4, 4))`` -> depth (B, H, W),
    images in [0, 1], plane-sweep matching between METRIC depths ``min_depth`` and
    ``max_depth``. The resolution must be a multiple of 16: the intrinsics describe the
    images as given, so nothing is resized. ``model`` is built for ``task="depth"``."""
    h, w = image_hw
    if h % PADDING_FACTOR or w % PADDING_FACTOR:
        raise ValueError("depth task: pass an intrinsics-consistent multiple-of-16 resolution")

    @torch.no_grad()
    def depth_fn(img0, img1, intrinsics, pose):
        device = _model_device(model)
        img0, img1, intrinsics, pose = (x.to(device, torch.float32)
                                        for x in (img0, img1, intrinsics, pose))
        return model(img0 * 255.0, img1 * 255.0, intrinsics=intrinsics, pose=pose,
                     min_depth=1.0 / min_depth, max_depth=1.0 / max_depth,
                     num_depth_candidates=num_depth_candidates)

    return depth_fn
