"""Pseudo-label generation over a folder of videos and images (counterpart of
``lkgd_tpu/cli/annotate.py``).

  python -m lkgd_torch.cli.annotate --input data/videos --annotation canny --output labels/
  python -m lkgd_torch.cli.annotate --input data/videos --annotation flow --output labels/
  python -m lkgd_torch.cli.annotate --input data/videos --annotation tracks \
      --weights raft_large.pth --output labels/
  python -m lkgd_torch.cli.annotate --input imgs --annotation depth_anything \
      --model-size base --weights depth_anything_base.safetensors --output labels/

Every ``*.mp4``, ``*.gif``, ``*.png`` and ``*.jpg`` of ``--input`` (at most
``--max-frames`` frames each) becomes ``<name>_<annotation>.gif``, a label map a frame:

* ``canny``, ``softedge`` (Sobel), ``tile`` and ``ip2p``: ``utils/control_preprocess.py``'s
  classical processors;
* ``flow``: UniMatch (``UniMatchConfig.lkgd()``) flow images of consecutive frames, the
  last repeated, ``FLOW_PAIRS`` pairs a batch; its weights are random from seed 0, as the
  JAX CLI initialises its UniMatch from ``PRNGKey(0)`` with no file;
* ``depth`` (HF Intel/dpt-large), ``depth_midas`` (isl-org DPT-hybrid) and
  ``depth_anything`` (HF Depth-Anything, ``--model-size small|base``): their checkpoints,
  loaded strictly from ``--weights``.

``tracks`` writes ``<name>.npz`` of the videos alone: ``tracks`` (T, N, 2) xy float32 and
``visibility`` (T, N) bool of a ``--grid-size``^2 query grid carried by chained RAFT flow
(torchvision ``raft_large`` from ``--weights``, loaded strictly), the labels
``utils/track_helpers.py`` reads. An annotation that needs ``--weights`` exits without it.
The annotators of HED, PiDiNet, OpenPose, line art and SegFormer are not ported yet
(ROADMAP.md Queue 1, item 14d): they are refused.

It runs on the card: ``--device`` defaults to ``cuda`` and a machine without one fails
unless ``--device cpu`` is given, in fp32 (``precision``). The models are
built by ``build_flow_processor``, ``build_tracker`` and ``build_depth_processor`` at their
published widths.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
from typing import Callable

import numpy as np
import torch

from lkgd_torch.models.depth_anything import DepthAnythingConfig
from lkgd_torch.models.raft import RAFTConfig
from lkgd_torch.models.unimatch import UniMatchConfig, build_unimatch
from lkgd_torch.utils import control_preprocess as cp
from lkgd_torch.utils.device import require_device
from lkgd_torch.utils.porting import load_state_dict

WEIGHTS = {"tracks": "torchvision raft_large state dict",
           "depth": "HF Intel/dpt-large state dict",
           "depth_midas": "isl-org dpt_hybrid-midas-501f0c75.pt",
           "depth_anything": "HF depth-anything state dict"}
# consecutive frame pairs in one UniMatch batch: its local correlations hold (2r+1)^2 = 81
# shifted copies of a 128-channel quarter-resolution map a pair, ~1.5 GB at 576 x 1024
FLOW_PAIRS = 4
NOT_PORTED = ("softedge_pidinet", "softedge_pidsafe", "scribble_pidinet", "softedge_hed",
              "scribble_hed", "softedge_hedsafe", "scribble_hedsafe", "lineart",
              "lineart_coarse", "lineart_anime", "segmentation", "openpose")


@contextlib.contextmanager
def precision():
    """The annotators' arithmetic: fp32 throughout, the precision at which the port's tests
    hold each annotator to the JAX package. PyTorch's default runs cuDNN's convolutions in
    TF32, which on an H100 moves a random UniMatch's flow image by up to its full scale and
    DPT-hybrid's depth by 16 levels of 8 bits (PERF.md); so the switch is set here, whatever
    the caller's. The price: cuDNN runs DPT-large's head convolution as an FFT (ROADMAP.md
    Queue 2)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--annotation", default="canny")
    p.add_argument("--max-frames", type=int, default=64)
    p.add_argument("--weights", default=None,
                   help="checkpoint of a model-based annotator (.safetensors, .pth, .pt)")
    p.add_argument("--model-size", default="small", choices=("small", "base"))
    p.add_argument("--grid-size", type=int, default=16,
                   help="tracks: the query grid's side")
    p.add_argument("--fb-thresh", type=float, default=2.0,
                   help="tracks: the forward-backward cycle's visibility threshold (px)")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    return p


def _load_strictly(model: torch.nn.Module, path: str) -> torch.nn.Module:
    model.load_state_dict(load_state_dict(path), strict=True)
    return model


def build_flow_processor(args) -> Callable:
    """``frames (T, H, W, 3) [0, 1] -> (T, H, W, 3)`` flow images (the last repeated), from a
    UniMatch random from seed 0 on ``args.device``."""
    from lkgd_torch.utils.flow_codec import flow_to_image_naive
    from lkgd_torch.utils.optical_flow import make_flow_fn

    device = require_device(args.device)
    model = build_unimatch(UniMatchConfig.lkgd(), device=device,
                           generator=torch.Generator(device=device).manual_seed(0))
    flow_fns = {}

    def process(frames: np.ndarray) -> np.ndarray:
        hw = frames.shape[1:3]
        if hw not in flow_fns:
            flow_fns[hw] = make_flow_fn(model, hw)
        flows = [flow_fns[hw](torch.from_numpy(frames[i:i + FLOW_PAIRS + 1]))
                 for i in range(0, len(frames) - 1, FLOW_PAIRS)]
        img = flow_to_image_naive(torch.cat(flows)).cpu().numpy()
        return np.concatenate([img, img[-1:]], axis=0)

    return process


def build_tracker(args) -> Callable:
    """``frames (T, H, W, 3) [0, 1] -> (tracks, visibility)`` numpy, through RAFT loaded
    strictly from ``args.weights`` on ``args.device``."""
    from lkgd_torch.models.raft import build_raft
    from lkgd_torch.utils.point_tracker import track_video

    model = _load_strictly(build_raft(RAFTConfig(), device=args.device), args.weights)
    return lambda frames: track_video(model, frames, grid_size=args.grid_size,
                                      fb_thresh=args.fb_thresh)


def build_depth_processor(args) -> Callable:
    """The ``args.annotation`` depth annotator, ``(H, W, 3) [0, 1] -> (H, W, 3) [0, 1]``,
    its model loaded strictly from ``args.weights`` on ``args.device``."""
    if args.annotation == "depth_anything":
        from lkgd_torch.models import depth_anything as da

        cfg = getattr(DepthAnythingConfig, args.model_size)()
        model = da.build_depth_anything(cfg, device=args.device)
        return da.make_depth_processor(_load_strictly(model, args.weights))
    from lkgd_torch.models import midas

    if args.annotation == "depth":
        model = midas.build_dpt("large", device=args.device)
        return midas.make_depth_processor(_load_strictly(model, args.weights))
    model = midas.build_dpt("hybrid", device=args.device)
    return midas.make_midas_processor(_load_strictly(model, args.weights))


def _files(folder: str, exts) -> list:
    return sorted(sum([glob.glob(os.path.join(folder, e)) for e in exts], []))


@precision()
def main(argv=None) -> None:
    from lkgd_torch.data.video_io import load_input, write_video

    args = make_parser().parse_args(argv)
    if args.annotation in NOT_PORTED:
        raise SystemExit(f"--annotation {args.annotation}: its model is not ported yet "
                         f"(ROADMAP.md Queue 1, item 14d)")
    if args.annotation in WEIGHTS and not args.weights:
        raise SystemExit(f"--annotation {args.annotation} needs --weights "
                         f"({WEIGHTS[args.annotation]}; external)")
    require_device(args.device)
    os.makedirs(args.output, exist_ok=True)

    if args.annotation == "tracks":
        track = build_tracker(args)
        for f in _files(args.input, ("*.mp4", "*.gif")):
            tracks, vis = track(load_input(f, max_frames=args.max_frames))
            out = os.path.join(args.output, os.path.splitext(os.path.basename(f))[0] + ".npz")
            np.savez(out, tracks=tracks, visibility=vis)
            print(f"{f} -> {out}: tracks {tracks.shape}, {float(vis.mean()) * 100:.0f}% visible")
        return

    if args.annotation == "flow":
        label = build_flow_processor(args)
    else:
        if args.annotation in WEIGHTS:
            cp.register_processor(args.annotation, build_depth_processor(args))
        label = lambda frames: cp.control_preprocess(frames, args.annotation)  # noqa: E731
    for f in _files(args.input, ("*.mp4", "*.gif", "*.png", "*.jpg")):
        labels = label(load_input(f, max_frames=args.max_frames))
        name = os.path.splitext(os.path.basename(f))[0]
        out = os.path.join(args.output, f"{name}_{args.annotation}.gif")
        write_video(out, labels, fps=7)
        print(f"{f} -> {out}")


if __name__ == "__main__":
    main()
