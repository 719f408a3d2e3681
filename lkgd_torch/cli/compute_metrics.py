"""Offline evaluation of generated media against references (counterpart of
``lkgd_tpu/cli/compute_metrics.py``).

  python -m lkgd_torch.cli.compute_metrics --generated outdir/ --reference refdir/ \
      [--weights ckpts/] [--inception-weights pt_inception.pth] [--i3d-weights i3d.pt] \
      [--pred-depth d1/ --gt-depth d2/] [--output metrics.json]

Media are the ``*.png``, ``*.jpg``, ``*.gif`` and ``*.mp4`` of each folder, sorted, at most
``--max-items``. The JSON holds:

* ``psnr`` and ``ssim``: the mean over the pairs of the two lists, when the first two
  items have one shape;
* ``clip_fid`` over every frame's CLIP-H features, and ``clip_fvd`` over each video's mean
  feature when each side has two or more videos. CLIP-H is random from ``--seed`` unless
  ``--weights`` holds ``image_encoder.safetensors`` (transformers names, loaded strictly):
  without it they are smoke numbers;
* ``fid`` with ``--inception-weights`` (pytorch-fid's InceptionV3 state dict) and ``fvd``
  with ``--i3d-weights`` (pytorch-i3d's Kinetics-400 state dict) and two or more videos a
  side, each video resized to 224 x 224 with antialiasing. ``.pth``/``.pt`` files are read
  with ``torch.load(weights_only=True)``, ``.safetensors`` with numpy; both load strictly;
* ``abs_rel``, ``delta1``-``delta3`` with ``--pred-depth`` and ``--gt-depth`` (the first
  frame of each file, channels averaged).

It runs on the card: ``--device`` defaults to ``cuda`` and a machine without one fails
unless ``--device cpu`` is given. The Frechet fits run on the host. The steps are functions
of their own (``load_dir``, ``build_clip``, ``video_features``, ``i3d_features``,
``evaluate``) and ``main`` takes ``widths=`` for tiny CLIP widths in tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Callable, List

import numpy as np
import torch

from lkgd_torch.eval import metrics as M
from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection
from lkgd_torch.models.configs import CLIPVisionConfig
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.ops.resize import resize_with_antialiasing
from lkgd_torch.utils.device import require_device
from lkgd_torch.utils.porting import load_state_dict

I3D_SIZE = 224


@dataclasses.dataclass(frozen=True)
class Widths:
    """CLIP's widths: CLIP-H by default; the CPU tests pass tiny ones."""

    clip: CLIPVisionConfig = CLIPVisionConfig()


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--generated", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--weights", help="folder with image_encoder.safetensors (CLIP-H)")
    p.add_argument("--inception-weights",
                   help="pytorch-fid InceptionV3 state dict (.pth/.pt/.safetensors) -> fid")
    p.add_argument("--i3d-weights", help="pytorch-i3d Kinetics-400 state dict -> fvd")
    p.add_argument("--pred-depth")
    p.add_argument("--gt-depth")
    p.add_argument("--max-items", type=int, default=256)
    p.add_argument("--output", default="metrics.json")
    p.add_argument("--seed", type=int, default=0, help="CLIP-H's random weights without --weights")
    p.add_argument("--device", default="cuda",
                   help="the card by default; a run without one fails unless cpu is named")
    return p


def load_dir(path: str, max_items: int) -> List[np.ndarray]:
    """The media of a folder as (T, H, W, 3) float32 [0, 1] arrays (T = 1 for an image)."""
    from lkgd_torch.data.video_io import load_input

    files = sorted(sum([glob.glob(os.path.join(path, e))
                        for e in ("*.png", "*.jpg", "*.gif", "*.mp4")], []))[:max_items]
    return [load_input(f) for f in files]


def build_clip(args, widths: Widths = Widths()) -> CLIPVisionModelWithProjection:
    """CLIP-H in fp32 on ``args.device``: random from ``args.seed``, or strictly from
    ``args.weights``/image_encoder.safetensors."""
    device = require_device(args.device)
    clip = materialize(lambda: CLIPVisionModelWithProjection(widths.clip), device,
                       torch.float32)
    if args.weights:
        clip.load_state_dict(load_state_dict(os.path.join(args.weights,
                                                          "image_encoder.safetensors")),
                             strict=True)
    else:
        init_params(clip, torch.Generator(device=device).manual_seed(args.seed))
    return clip.eval()


def video_features(extract: Callable, videos: List[np.ndarray], device):
    """Per-frame features of every video, concatenated (N_frames, D), and each video's mean
    feature (N_videos, D), as numpy."""
    frame_feats, video_feats = [], []
    for v in videos:
        f = extract(torch.from_numpy(v).to(device)).cpu().numpy()
        frame_feats.append(f)
        video_feats.append(f.mean(0))
    return np.concatenate(frame_feats), np.stack(video_feats)


def i3d_input(video: np.ndarray, device) -> torch.Tensor:
    """(T, H, W, 3) -> (1, T, 224, 224, 3): the antialiased resize FVD's I3D expects."""
    x = resize_with_antialiasing(torch.from_numpy(video).to(device), (I3D_SIZE, I3D_SIZE))
    return x[None]


def i3d_features(net: Callable, videos: List[np.ndarray], device) -> np.ndarray:
    """Each video's I3D features (N_videos, 400), as numpy."""
    return torch.cat([net(i3d_input(v, device)) for v in videos]).cpu().numpy()


def evaluate(args, gen: List[np.ndarray], ref: List[np.ndarray],
             widths: Widths = Widths()) -> dict:
    device = require_device(args.device)
    results = {}
    pairs = min(len(gen), len(ref))
    if pairs and gen[0].shape == ref[0].shape:
        ps, ss = [], []
        for g, r in zip(gen[:pairs], ref[:pairs]):
            g, r = torch.from_numpy(g).to(device), torch.from_numpy(r).to(device)
            ps.append(float(M.psnr(g, r)))
            ss.append(float(M.ssim(g, r)))
        results["psnr"] = float(np.mean(ps))
        results["ssim"] = float(np.mean(ss))

    if gen and ref:
        extract = M.make_clip_feature_extractor(build_clip(args, widths))
        gf, gv = video_features(extract, gen, device)
        rf, rv = video_features(extract, ref, device)
        results["clip_fid"] = M.fid_from_features(rf, gf)
        if len(gv) > 1 and len(rv) > 1:
            results["clip_fvd"] = M.fvd_from_features(rv, gv)

    if gen and ref and args.inception_weights:
        from lkgd_torch.eval import fid_inception

        inception = fid_inception.build_inception(device)
        fid_inception.load_torch_state_dict(inception, load_state_dict(args.inception_weights))
        gf, _ = video_features(inception, gen, device)
        rf, _ = video_features(inception, ref, device)
        results["fid"] = M.fid_from_features(rf, gf)
    if gen and ref and args.i3d_weights and len(gen) > 1 and len(ref) > 1:
        from lkgd_torch.eval import i3d

        net = i3d.build_i3d(device)
        i3d.load_torch_state_dict(net, load_state_dict(args.i3d_weights))
        results["fvd"] = M.fvd_from_features(i3d_features(net, ref, device),
                                             i3d_features(net, gen, device))

    if args.pred_depth and args.gt_depth:
        pred = np.stack([x[0].mean(-1) for x in load_dir(args.pred_depth, args.max_items)])
        gt = np.stack([x[0].mean(-1) for x in load_dir(args.gt_depth, args.max_items)])
        results.update(M.depth_metrics(torch.from_numpy(pred).to(device),
                                       torch.from_numpy(gt).to(device)))
    return results


def main(argv=None, widths: Widths = Widths()) -> dict:
    args = make_parser().parse_args(argv)
    require_device(args.device)
    gen = load_dir(args.generated, args.max_items)
    ref = load_dir(args.reference, args.max_items)
    results = evaluate(args, gen, ref, widths)
    print(json.dumps(results, indent=2))
    with open(args.output, "w") as f:
        json.dump(results, f)
    return results


if __name__ == "__main__":
    main()
