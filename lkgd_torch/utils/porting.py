"""Flax parameter trees -> the port's state dicts (diffusers / transformers names).

A numpy transcription of the export rules of ``lkgd_tpu/utils/porting.py``
(``export_state_dict`` :161-203 and the key maps ``vae_export_key_map`` /
``clip_export_key_map`` :379-412), needing no jax: the input is the flax tree flattened
to ``/``-joined paths (``params/down_blocks_0/resnets_0/.../kernel``) holding numpy
arrays. The result loads into the port's modules with ``load_state_dict(strict=True)``.

Rules: Dense kernels (in, out) -> Linear (out, in); Conv kernels (kh, kw, I, O) ->
(O, I, kh, kw); temporal (3, 1, I, O) kernels -> Conv3d (O, I, 3, 1, 1); ``scale`` ->
``weight``; list children ``name_3`` -> ``name.3``; ``to_out`` -> ``to_out.0``;
``ff.net_0.proj`` / ``ff.net_2`` -> ``ff.net.0.proj`` / ``ff.net.2``. Every other leaf keeps
its name and layout: the LoRA factors ``lora_<name>_A`` (in, rank) / ``lora_<name>_B``
(rank, out), and the knowledge fusion's depthwise ``weight``, quaternion factors and
``texts*`` (its Dense kernels follow the kernel rule), exactly as the JAX exporter writes
them.

``save_safetensors`` writes a state dict in the safetensors format with numpy alone (the
card's machine has no ``safetensors`` package).
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

_LISTS = re.compile(
    r"\b(down_blocks|up_blocks|resnets|attentions|transformer_blocks|"
    r"temporal_transformer_blocks|downsamplers|upsamplers|blocks|controlnet_down_blocks|"
    r"layers)_(\d+)")


def _torch_layout(leaf: str, x: np.ndarray):
    if leaf == "kernel":
        if x.ndim == 2:
            return "weight", x.T
        if x.ndim == 4 and x.shape[:2] == (3, 1):
            return "weight", x.transpose(3, 2, 0, 1)[..., None]  # temporal conv -> Conv3d
        if x.ndim == 4:
            return "weight", x.transpose(3, 2, 0, 1)
        return "weight", x
    if leaf == "scale":
        return "weight", x
    return leaf, x


def _diffusers_name(path: str) -> str:
    name = _LISTS.sub(r"\1.\2", path.replace("/", "."))
    name = re.sub(r"\bto_out\b", "to_out.0", name)
    name = name.replace("ff.net_0.proj", "ff.net.0.proj").replace("ff.net_2", "ff.net.2")
    return name.replace("ff_in.net_0.proj", "ff_in.net.0.proj").replace("ff_in.net_2",
                                                                        "ff_in.net.2")


def vae_key_map(key: str) -> str:
    """Generic export names -> diffusers ``AutoencoderKLTemporalDecoder`` names."""
    k = key.replace("mid_block_resnets_", "mid_block.resnets.")
    k = k.replace("mid_block_attentions_", "mid_block.attentions.")
    k = re.sub(r"up_blocks\.(\d+)_resnets_(\d+)", r"up_blocks.\1.resnets.\2", k)
    k = re.sub(r"up_blocks\.(\d+)_upsamplers_0", r"up_blocks.\1.upsamplers.0.conv", k)
    k = re.sub(r"down_blocks\.(\d+)\.downsamplers\.0\b", r"down_blocks.\1.downsamplers.0.conv",
               k)
    return re.sub(r"(resnets\.\d+)\.mix_factor", r"\1.time_mixer.mix_factor", k)


def clip_key_map(key: str) -> str:
    """Generic export names -> transformers ``CLIPVisionModelWithProjection`` names."""
    if key.startswith("layers."):
        parts = key.split(".")
        rest = ".".join(parts[2:])
        if rest.startswith(("q_proj", "k_proj", "v_proj", "out_proj")):
            rest = "self_attn." + rest
        elif rest.startswith(("fc1", "fc2")):
            rest = "mlp." + rest
        return f"vision_model.encoder.layers.{parts[1]}.{rest}"
    if key == "class_embedding":
        return "vision_model.embeddings.class_embedding"
    if key == "position_embedding":
        return "vision_model.embeddings.position_embedding.weight"
    if key.startswith("patch_embedding"):
        return "vision_model.embeddings.patch_embedding.weight"
    if key.startswith(("pre_layrnorm", "post_layernorm")):
        return f"vision_model.{key}"
    return key  # visual_projection.*


def vit_key_map(key: str) -> str:
    """Generic export names of the JAX ViT -> timm ``vit_base_patch16_384`` names (the
    inverse of ``lkgd_tpu/models/vit_mae.py`` ``timm_vit_key_map``)."""
    if key.startswith("patch_embed."):
        return key.replace("patch_embed.", "patch_embed.proj.", 1)
    parts = key.split(".")
    if parts[0] == "blocks" and parts[2] in ("qkv", "proj"):
        return ".".join(parts[:2] + ["attn"] + parts[2:])
    if parts[0] == "blocks" and parts[2] in ("fc1", "fc2"):
        return ".".join(parts[:2] + ["mlp"] + parts[2:])
    return key


def from_flax_params(flat: Mapping[str, np.ndarray],
                     key_map: Optional[Callable[[str], str]] = None) -> Dict[str, torch.Tensor]:
    """``/``-path flax leaves -> the port's state dict. ``key_map``: ``vae_key_map`` for the
    temporal VAE, ``clip_key_map`` for CLIP, ``vit_key_map`` for the knowledge ViT, None
    for the UNet (LoRA and knowledge fusion included)."""
    out = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        leaf, x = _torch_layout(parts[-1], np.asarray(value))
        name = _diffusers_name("/".join(parts[:-1] + [leaf]))
        if key_map is not None:
            name = key_map(name)
        out[name] = torch.from_numpy(np.array(x, copy=True, order="C"))
    return out


def save_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write ``name -> float32 array`` as a safetensors file: an 8-byte little-endian header
    length, a JSON header of dtype, shape and byte offsets (space-padded to 8 bytes), then
    the arrays' little-endian bytes, back to back in name order."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        x = np.ascontiguousarray(tensors[name])
        if x.dtype != np.float32:
            raise TypeError(f"save_safetensors: {name} has dtype {x.dtype}, not float32")
        data = x.astype("<f4", copy=False).tobytes()
        header[name] = {"dtype": "F32", "shape": list(x.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for data in chunks:
            f.write(data)
