"""Exact checkpoint key manifests of the published weights the port's modules load: the
port's own copy of ``lkgd_tpu/utils/checkpoint_manifest.py`` (which it does not import).

A manifest is ``{state_dict key: shape}`` of one checkpoint, in the names of the
diffusers / transformers model code that wrote it. The port's modules carry those names
themselves, so a manifest here is the ``state_dict`` of the port's full-width module, built
on the meta device (no memory, no values):

* ``svd_xt_unet``: stabilityai/stable-video-diffusion-img2vid-xt ``unet`` (1.525 B);
* ``svd_vae``: its ``vae``, AutoencoderKLTemporalDecoder (97.7 M);
* ``clip_vit_h``: its ``image_encoder``, CLIP ViT-H/14 vision tower and projection (632 M);
* ``cogvideox_5b_transformer``: THUDM/CogVideoX-5b-I2V ``transformer`` (5.57 B), built
  without knowledge fusion as the JAX package builds it for its manifest;
* ``raft_large``: torchvision's ``raft_large`` (5.26 M), the point tracker's flow.

The JSON files under ``manifests/`` are the JAX package's, copied byte for byte; the tests
hold the port's modules to them, so that a checkpoint loaded later has a fixed target.

  python -m lkgd_torch.utils.checkpoint_manifest            # keys and totals
  python -m lkgd_torch.utils.checkpoint_manifest --check    # the modules = the JSON files
  python -m lkgd_torch.utils.checkpoint_manifest --write    # rewrite the JSON files
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Tuple

import torch

MANIFEST_DIR = os.path.join(os.path.dirname(__file__), "manifests")

Manifest = Dict[str, Tuple[int, ...]]


def manifest_of(factory: Callable[[], torch.nn.Module]) -> Manifest:
    """``{key: shape}`` of the ``state_dict`` of ``factory()`` built on the meta device."""
    with torch.device("meta"):
        module = factory()
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def svd_xt_unet_manifest() -> Manifest:
    from lkgd_torch.models.configs import SVDUNetConfig
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition

    return manifest_of(lambda: UNetSpatioTemporalCondition(SVDUNetConfig(num_frames=14)))


def svd_vae_manifest() -> Manifest:
    from lkgd_torch.models.configs import TemporalVAEConfig
    from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder

    return manifest_of(lambda: AutoencoderKLTemporalDecoder(TemporalVAEConfig()))


def clip_vit_h_manifest() -> Manifest:
    from lkgd_torch.models.clip_vision import CLIPVisionModelWithProjection
    from lkgd_torch.models.configs import CLIPVisionConfig

    return manifest_of(lambda: CLIPVisionModelWithProjection(CLIPVisionConfig()))


def cogvideox_5b_manifest() -> Manifest:
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.models.configs import CogVideoXConfig

    return manifest_of(lambda: CogVideoXTransformer3D(
        CogVideoXConfig.cogvideox_5b_i2v(knowledge_fusion=False)))


def raft_large_manifest() -> Manifest:
    from lkgd_torch.models.raft import RAFT, RAFTConfig

    return manifest_of(lambda: RAFT(RAFTConfig.large()))


GENERATORS = {
    "svd_xt_unet": svd_xt_unet_manifest,
    "svd_vae": svd_vae_manifest,
    "clip_vit_h": clip_vit_h_manifest,
    "cogvideox_5b_transformer": cogvideox_5b_manifest,
    "raft_large": raft_large_manifest,
}


def load_manifest(name: str) -> Manifest:
    with open(os.path.join(MANIFEST_DIR, name + ".json")) as f:
        return {k: tuple(v) for k, v in json.load(f).items()}


def param_total(manifest: Manifest) -> int:
    return sum(torch.Size(s).numel() for s in manifest.values())


def synthetic_state_dict(manifest: Manifest) -> Dict[str, torch.Tensor]:
    """A state dict of exactly the manifest's keys and shapes that holds no memory (zeros
    broadcast from one element): for ``load_state_dict(..., strict=True, assign=True)``
    into a module built on the meta device, a full-coverage audit of the names."""
    zero = torch.zeros(())
    return {k: zero.expand(s) for k, s in manifest.items()}


def write_manifest(name: str, manifest: Manifest) -> str:
    """The JSON file as the JAX package writes it: sorted keys, shapes as lists."""
    path = os.path.join(MANIFEST_DIR, name + ".json")
    with open(path, "w") as f:
        json.dump({k: list(v) for k, v in sorted(manifest.items())}, f, indent=0)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write", action="store_true", help="(re)generate manifests/*.json")
    p.add_argument("--check", action="store_true",
                   help="fail unless every module matches its checked-in manifest")
    args = p.parse_args(argv)
    for name, gen in GENERATORS.items():
        m = gen()
        if args.write:
            path = write_manifest(name, m)
            print(f"{name}: {len(m)} keys, {param_total(m) / 1e9:.4f}B params -> {path}")
        elif args.check:
            ok = load_manifest(name) == m
            print(f"{name}: {'OK' if ok else 'DRIFT'}")
            if not ok:
                raise SystemExit(1)
        else:
            print(f"{name}: {len(m)} keys, {param_total(m) / 1e9:.4f}B params")


if __name__ == "__main__":
    main()
