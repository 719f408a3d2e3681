"""Flax parameter trees -> the port's state dicts (diffusers / transformers names).

A numpy transcription of the export rules of ``lkgd_tpu/utils/porting.py``
(``export_state_dict`` :161-203 and the key maps ``vae_export_key_map`` /
``clip_export_key_map`` :379-412), needing no jax: the input is the flax tree flattened
to ``/``-joined paths (``params/down_blocks_0/resnets_0/.../kernel``) holding numpy
arrays. The result loads into the port's modules with ``load_state_dict(strict=True)``.

Rules: Dense kernels (in, out) -> Linear (out, in); Conv kernels (kh, kw, I, O) ->
(O, I, kh, kw); temporal (3, 1, I, O) kernels -> Conv3d (O, I, 3, 1, 1); 3D kernels
(kt, kh, kw, I, O) -> Conv3d (O, I, kt, kh, kw) (the CogVideoX VAE's; the JAX exporter
leaves these in flax's layout, which no torch module takes); ``scale`` ->
``weight``; list children ``name_3`` -> ``name.3``; ``to_out`` -> ``to_out.0``;
``ff.net_0.proj`` / ``ff.net_2`` -> ``ff.net.0.proj`` / ``ff.net.2``. Every other leaf keeps
its name and layout: the LoRA factors ``lora_<name>_A`` (in, rank) / ``lora_<name>_B``
(rank, out), and the knowledge fusion's depthwise ``weight``, quaternion factors and
``texts*`` (its Dense kernels follow the kernel rule), exactly as the JAX exporter writes
them. The joint branch's ``joint`` scope is dropped, as the JAX exporter drops it:
``attn1n``, ``conv1n``, ``scale1n`` and ``norm1n`` sit directly on the transformer block.
The same rules carry the ControlNet (``controlnet_cond_embedding.blocks.N``,
``controlnet_down_blocks.N``: ``key_map=None``, as the UNet) and the UNet's y head and flow
input (``conv_in_y``, ``*_embedding_y``, ``conv_in2``, the scalar ``conv_in2_alpha``).
``cogvideox_key_map`` gives the CogVideoX transformer diffusers' names, as the JAX
package's ``cogvideox_export_key_map`` does; the CogVideoX VAE keeps the generic names
(``key_map=None``), which its JAX CLI reads from ``vae_3d.safetensors``.

The SD-2D family: ``unet2d_key_map`` gives the JAX 2D UNet's and ControlNet-2D's
flat block names (``down_blocks_0_resnets_0``) diffusers' nesting, as the JAX package's
``unet2d_export_key_map`` does (the joint branch, LoRA factors, ``cond_embedding`` and
``conv_fuse`` by the rules above); the image VAE takes ``vae_key_map``; ``clip_text_key_map``
gives the CLIP text tower transformers' ``CLIPTextModel`` names.

``cogvideox_export_name`` runs the other way for the CogVideoX transformer's parameter
names: the port's module names -> the JAX package's default export names (no key map, as
its ``train_cogvideox_lora`` exports its trainables), for ``export_trainable_safetensors``.

``t5_state_dict`` carries the JAX T5 encoder's params into the port's ``T5Encoder`` under
transformers' ``T5EncoderModel`` names (the names ``port_t5_encoder`` reads).

``unimatch_state_dict`` carries the JAX UniMatch's params: the same kernel rules, its names
kept but for the transformer's blocks (``layers_<i>_self_attn`` -> ``layers.<i>.self_attn``),
and the trident convolution's HWIO ``trident_weight`` turned OIHW.

The pseudo-label models carry the published checkpoints' names, each with its converter
from the JAX module's flat params: ``raft_state_dict`` (torchvision ``raft_large``, the
inverse of the JAX package's ``raft_key_map``), ``rife_state_dict`` (IFNet_HDv3, the inverse
of ``rife_key_map``: a ``tkernel`` is a ConvTranspose weight, (kh, kw, in, out) ->
(in, out, kh, kw)), ``dpt_hybrid_state_dict`` (isl-org MiDaS, the inverse of
``midas_key_map``), ``dpt_large_state_dict`` (HF Intel/dpt-large, the fused ``qkv`` split
into ``query``/``key``/``value``) and ``depth_anything_state_dict`` (HF Depth-Anything, the
inverse of ``hf_depth_anything_key_map``; its transposed-convolution kernels mirrored, as
flax applies them). Weights the published models hold but never read (a final encoder norm,
the deepest fusion block's first residual unit, DINOv2's ``mask_token``) are filled with
ones or zeros, so that the result loads strictly.

``lora_key_map`` / ``port_lora_safetensors`` read a LoRA state dict in diffusers, peft or
kohya spelling into a module's ``lora_<name>_A/B`` parameters: the inverse of
``export_lora_state_dict`` and the counterpart of the JAX package's functions of the same
names.

``inception_state_dict`` and ``i3d_state_dict`` carry the nested parameter dicts of the JAX
package's FID InceptionV3 and FVD I3D (``lkgd_tpu/eval/fid_inception.py``,
``lkgd_tpu/eval/i3d.py``) into pytorch-fid's and pytorch-i3d's ``state_dict`` names, the
inverse of their ``port_torch_state_dict``: HWIO convolution kernels -> OIHW, DHWIO -> OIDHW,
BatchNorm's ``mean`` and ``var`` -> ``running_mean`` and ``running_var`` as they are.

``load_state_dict`` reads a checkpoint file of any of the formats the CLIs take.

``save_safetensors`` and ``load_safetensors`` write and read a state dict in the
safetensors format with numpy alone (the card's machine has no ``safetensors`` package).
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
        if x.ndim == 5:
            return "weight", x.transpose(4, 3, 0, 1, 2)
        return "weight", x
    if leaf == "scale":
        return "weight", x
    return leaf, x


def _diffusers_name(path: str) -> str:
    name = _LISTS.sub(r"\1.\2", path.replace("/", ".")).replace("joint.", "")
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


def unet2d_key_map(key: str) -> str:
    """Generic export names of the JAX 2D UNet and ControlNet-2D, whose blocks are flat
    (``down_blocks_0_resnets_0``) -> diffusers ``UNet2DConditionModel`` names
    (``down_blocks.0.resnets.0``, ``mid_block.attentions.0``): the JAX package's
    ``unet2d_export_key_map``."""
    k = re.sub(r"\b(down_blocks|up_blocks)\.(\d+)_(resnets|attentions|downsamplers|"
               r"upsamplers)_(\d+)", r"\1.\2.\3.\4", key)
    k = k.replace("mid_block_resnets_", "mid_block.resnets.")
    return k.replace("mid_block_attentions_", "mid_block.attentions.")


def clip_text_key_map(key: str) -> str:
    """Generic export names of the JAX CLIP text tower -> transformers ``CLIPTextModel``
    names."""
    if key.startswith("layers."):
        parts = key.split(".")
        rest = ".".join(parts[2:])
        if rest.startswith(("q_proj", "k_proj", "v_proj", "out_proj")):
            rest = "self_attn." + rest
        elif rest.startswith(("fc1", "fc2")):
            rest = "mlp." + rest
        return f"text_model.encoder.layers.{parts[1]}.{rest}"
    if key in ("token_embedding", "position_embedding"):
        return f"text_model.embeddings.{key}.weight"
    return f"text_model.{key}"  # final_layer_norm.*


def cogvideox_key_map(key: str) -> str:
    """Generic export names -> diffusers ``CogVideoXTransformer3DModel`` names, the
    knowledge fusion as the LKGD checkpoint's top-level ``quaternion_lora_*`` modules."""
    k = key.replace("patch_embed_proj", "patch_embed.proj")
    k = k.replace("patch_embed_text_proj", "patch_embed.text_proj")
    k = k.replace("norm_out_linear", "norm_out.linear").replace("norm_out_norm", "norm_out.norm")
    k = k.replace(".ff_0.", ".ff.net.0.proj.").replace(".ff_2.", ".ff.net.2.")
    if k.startswith("knowledge_fusion."):
        k = k[len("knowledge_fusion."):].replace("fuse_sf_0", "fuse_sf.0")
        return "quaternion_lora_" + k.replace("fuse_sf_2", "fuse_sf.2")
    return k


def cogvideox_export_name(name: str) -> str:
    """A parameter name of the port's CogVideoX transformer -> the name the JAX package's
    ``export_state_dict`` gives the same parameter with no key map (``patch_embed_proj``,
    ``norm_out_linear``, ``ff_0``, ``ff_2``; the fusion under ``knowledge_fusion.*`` and the
    LoRA factors keep their names)."""
    k = name.replace("patch_embed.proj", "patch_embed_proj")
    k = k.replace("patch_embed.text_proj", "patch_embed_text_proj")
    k = k.replace("norm_out.linear", "norm_out_linear")
    return k.replace(".ff.net.0.proj.", ".ff_0.").replace(".ff.net.2.", ".ff_2.")


def t5_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``/``-path flax leaves of ``lkgd_tpu.models.t5_text.T5Encoder`` -> the state dict of
    ``lkgd_torch.models.t5_text.T5Encoder`` (transformers' ``T5EncoderModel`` names, the
    embedding under ``shared`` and its tied ``encoder.embed_tokens``), for
    ``load_state_dict(strict=True)``: the inverse of the JAX package's ``port_t5_encoder``."""
    out = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        x = np.asarray(value)
        if parts[0] == "shared_embedding":
            out["shared.weight"] = out["encoder.embed_tokens.weight"] = x
            continue
        if parts[0] == "final_layer_norm":
            out["encoder.final_layer_norm.weight"] = x
            continue
        block = f"encoder.block.{int(parts[0].removeprefix('block_'))}.layer"
        rest = "/".join(parts[1:])
        if rest == "SelfAttention/relative_attention_bias":
            name = f"{block}.0.SelfAttention.relative_attention_bias.weight"
        elif rest.startswith("SelfAttention/"):
            name, x = f"{block}.0.SelfAttention.{parts[2]}.weight", x.T
        elif rest == "attn_layer_norm/weight":
            name = f"{block}.0.layer_norm.weight"
        elif rest == "ff_layer_norm/weight":
            name = f"{block}.1.layer_norm.weight"
        else:  # wi_0, wi_1, wo kernels
            name, x = f"{block}.1.DenseReluDense.{parts[1]}.weight", x.T
        out[name] = x
    return {k: torch.from_numpy(np.array(v, copy=True, order="C")) for k, v in out.items()}


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
    temporal VAE and the SD image VAE, ``clip_key_map`` for CLIP, ``vit_key_map`` for the
    knowledge ViT, ``cogvideox_key_map`` for the CogVideoX transformer, ``unet2d_key_map``
    for the 2D UNet and ControlNet-2D, ``clip_text_key_map`` for the CLIP text tower, None
    for the SVD UNet (LoRA and knowledge fusion included) and the CogVideoX VAE."""
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


def unimatch_key_map(key: str) -> str:
    """Generic export names of the JAX UniMatch -> the port's: the transformer's blocks are
    a list of (``self_attn``, ``cross_attn_ffn``) pairs."""
    return re.sub(r"\blayers\.(\d+)_(self_attn|cross_attn_ffn)\b", r"layers.\1.\2", key)


def unimatch_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``/``-path flax leaves of ``lkgd_tpu.models.unimatch.UniMatch`` (or of one of its
    submodules) -> the state dict of ``lkgd_torch.models.unimatch.UniMatch`` built for the
    same task (or of the same submodule), for ``load_state_dict(strict=True)``."""
    out = from_flax_params(flat, key_map=unimatch_key_map)
    for name in out:
        if name.rsplit(".", 1)[-1] == "trident_weight":  # a raw (3, 3, I, O) param
            out[name] = out[name].permute(3, 2, 0, 1).contiguous()
    return out


def lora_key_map(adapter_name: str) -> Callable[[str], Optional[str]]:
    """LoRA state-dict names -> the port's adapter parameter names, or None for a tensor
    that is no LoRA factor. Takes diffusers' ``unet.<path>.to_q.lora_A.weight`` (with the
    optional ``base_model.model.``, ``unet.`` or ``transformer.`` prefixes), peft's
    ``...lora_A.<adapter>.weight`` and kohya's ``...lora.down.weight`` / ``lora.up.weight``."""

    def map_key(key: str) -> Optional[str]:
        k = key
        for prefix in ("base_model.model.", "unet.", "transformer."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        k = k.replace(f".lora_A.{adapter_name}.weight", ".lora_A.weight")
        k = k.replace(f".lora_B.{adapter_name}.weight", ".lora_B.weight")
        k = k.replace(".lora.down.weight", ".lora_A.weight")
        k = k.replace(".lora.up.weight", ".lora_B.weight")
        if k.endswith(".lora_A.weight"):
            return k[: -len(".lora_A.weight")] + f".lora_{adapter_name}_A"
        if k.endswith(".lora_B.weight"):
            return k[: -len(".lora_B.weight")] + f".lora_{adapter_name}_B"
        return None

    return map_key


def export_lora_state_dict(module: torch.nn.Module, adapter_name: str) -> Dict[str, np.ndarray]:
    """The adapter ``adapter_name`` of ``module`` in diffusers' LoRA layout:
    ``unet.<path>.lora_A.weight`` (rank, in) and ``lora_B.weight`` (out, rank), float32."""
    out = {}
    for name, p in module.named_parameters():
        for side in ("A", "B"):
            suffix = f".lora_{adapter_name}_{side}"
            if name.endswith(suffix):
                out[f"unet.{name[: -len(suffix)]}.lora_{side}.weight"] = \
                    p.detach().float().cpu().numpy().T.copy()
    return out


def port_lora_safetensors(state_dict: Mapping[str, np.ndarray], module: torch.nn.Module,
                          adapter_name: str, strict: bool = False) -> int:
    """Load a LoRA state dict (diffusers, peft or kohya names; torch layout ``lora_A``
    (rank, in), ``lora_B`` (out, rank)) into the ``lora_<adapter_name>_A/B`` parameters of
    ``module``, whose router already declares the adapter. Every other parameter keeps its
    value. Returns the number of tensors loaded; ``strict`` raises on a LoRA tensor with no
    parameter to take it and on an adapter parameter left unfilled."""
    params = dict(module.named_parameters())
    key_map = lora_key_map(adapter_name)
    loaded, unused = set(), []
    with torch.no_grad():
        for key, value in state_dict.items():
            name = key_map(key)
            if name is None:
                continue
            if name not in params:
                unused.append(key)
                continue
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(value).T))
            if x.shape != params[name].shape:
                raise ValueError(f"{key}: cannot fit shape {np.shape(value)} into "
                                 f"{tuple(params[name].shape)} at {name}")
            params[name].copy_(x)
            loaded.add(name)
    missing = [n for n in params if f".lora_{adapter_name}_" in n and n not in loaded]
    if strict and (missing or unused):
        raise ValueError(f"missing {len(missing)} adapter params, e.g. {missing[:5]}; unused "
                         f"{len(unused)} LoRA keys, e.g. {unused[:5]}")
    return len(loaded)


_BN_NAMES = {"weight": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _feature_state_dict(params: Mapping, conv: str, layout) -> Dict[str, torch.Tensor]:
    """Nested ``{unit: {conv: {"kernel", ["bias"]}, ["bn": {...}]}}`` -> flat torch names;
    ``layout`` turns a kernel into torch's layout."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        if conv in node:
            for name, x in node[conv].items():
                x = np.asarray(x, np.float32)
                out[f"{prefix}{conv}.{'weight' if name == 'kernel' else name}"] = (
                    layout(x) if name == "kernel" else x)
            for name, x in node.get("bn", {}).items():
                out[f"{prefix}bn.{_BN_NAMES[name]}"] = np.asarray(x, np.float32)
            return
        for key, child in node.items():
            walk(child, f"{prefix}{key}.")

    walk(params, "")
    return {k: torch.from_numpy(np.array(v, copy=True, order="C")) for k, v in out.items()}


def inception_state_dict(jax_params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX FID InceptionV3's params (nested dicts of arrays) -> pytorch-fid names."""
    return _feature_state_dict(jax_params, "conv", lambda x: x.transpose(3, 2, 0, 1))


def i3d_state_dict(jax_params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX I3D's params (nested dicts of arrays) -> pytorch-i3d names."""
    return _feature_state_dict(jax_params, "conv3d", lambda x: x.transpose(4, 3, 0, 1, 2))


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


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file (``.safetensors``, read with numpy, or a torch
    ``.pth``/``.pt``/``.bin``/``.pkl`` with a nested ``{"state_dict": ...}`` unwrapped) ->
    name -> tensor."""
    if path.endswith(".safetensors"):
        return {k: torch.from_numpy(v) for k, v in load_safetensors(path).items()}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2"}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a safetensors file of F32, F16 or BF16 tensors as ``name -> float32 array``
    (exactly: each widens without rounding), with numpy alone."""
    with open(path, "rb") as f:
        size = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(size))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = data[start:end]
        if info["dtype"] == "BF16":
            x = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            x = np.frombuffer(raw, _SAFETENSORS_DTYPES[info["dtype"]]).astype(np.float32)
        out[name] = x.reshape(info["shape"])
    return out


# ---------------------------------------------------------------- pseudo-label models
def _flat_items(flat: Mapping[str, np.ndarray]):
    """``(dotted module path, leaf name, array)`` of each flax leaf, ``params/`` dropped."""
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        yield ".".join(parts[:-1]), parts[-1], np.asarray(value, np.float32)


def _tensors(out: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32, copy=True, order="C"))
            for k, v in out.items()}


def _torch_leaf(leaf: str, x: np.ndarray):
    """A flax leaf in torch's layout and name: Dense (in, out) -> (out, in), Conv HWIO ->
    OIHW, ``scale`` -> ``weight``."""
    if leaf == "kernel":
        return "weight", x.T if x.ndim == 2 else x.transpose(3, 2, 0, 1)
    return ("weight" if leaf == "scale" else leaf), x


def raft_export_key_map(key: str) -> str:
    """Generic export names of the JAX RAFT -> torchvision ``raft_large`` names (a copy of
    ``lkgd_tpu/utils/porting.py`` ``raft_export_key_map``)."""
    k = re.sub(r"\blayer(\d)_(\d)\b", r"layer\1.\2", key)
    k = k.replace("mask_conv1.", "mask_predictor.convrelu.0.")
    k = k.replace("mask_conv2.", "mask_predictor.conv.")
    k = re.sub(r"update_block\.flow_head_conv(\d)\.", r"update_block.flow_head.conv\1.", k)
    k = re.sub(r"update_block\.conv([zrq])(\d)\.",
               r"update_block.recurrent_block.convgru\2.conv\1.", k)
    k = re.sub(r"update_block\.(conv(?:corr|flow)\d)\.", r"update_block.motion_encoder.\1.0.", k)
    k = k.replace("update_block.conv.", "update_block.motion_encoder.conv.0.")
    k = re.sub(r"\b(feature_encoder|context_encoder)\.conv2\.", r"\1.conv.", k)
    norm_leaf = {"scale": "weight", "weight": "weight", "bias": "bias", "mean": "running_mean",
                 "var": "running_var"}
    k = re.sub(r"(layer\d\.\d\.)norm([12])_(scale|weight|bias|mean|var)$",
               lambda m: m.group(1) + f"convnormrelu{m.group(2)}.1." + norm_leaf[m.group(3)], k)
    k = re.sub(r"(encoder\.)norm1_(scale|weight|bias|mean|var)$",
               lambda m: m.group(1) + "convnormrelu.1." + norm_leaf[m.group(2)], k)
    k = re.sub(r"norm3_(scale|weight|bias|mean|var)$",
               lambda m: "downsample.1." + norm_leaf[m.group(1)], k)
    k = re.sub(r"(layer\d\.\d\.)conv([12])\.", r"\1convnormrelu\2.0.", k)
    k = re.sub(r"\b(feature_encoder|context_encoder)\.conv1\.", r"\1.convnormrelu.0.", k)
    return re.sub(r"(layer\d\.\d\.)downsample\.weight$", r"\1downsample.0.weight", k)


def raft_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``RAFT``'s flat params -> ``lkgd_torch.models.raft.RAFT``'s state dict
    (torchvision's names)."""
    out = {}
    for module, leaf, x in _flat_items(flat):
        name, x = _torch_leaf(leaf, x)
        out[raft_export_key_map(f"{module}.{name}")] = x
    return _tensors(out)


def rife_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``IFNet``'s flat params -> ``lkgd_torch.models.rife.IFNet``'s state dict
    (IFNet_HDv3's names)."""
    out = {}
    for module, leaf, x in _flat_items(flat):
        block, part = module.split(".")[:2]
        m = re.match(r"(conv0|convblock\d|conv[12])_(\d)$", part)
        head, idx = m.groups()
        if leaf == "alpha":  # PReLU
            name = f"{head}.1.weight" if head in ("conv1", "conv2") else f"{head}.{idx}.1.weight"
        elif head in ("conv1", "conv2"):  # (conv1_0: deconv + PReLU, conv1_1: deconv)
            t = "weight" if leaf == "tkernel" else leaf
            x = x.transpose(2, 3, 0, 1) if leaf == "tkernel" else x
            name = f"{head}.{'0' if idx == '0' else '2'}.{t}"
        else:
            t, x = _torch_leaf(leaf, x)
            name = f"{head}.{idx}.0.{t}"
        out[f"{block}.{name}"] = x
    return _tensors(out)


def _dead_fusion_unit(prefix: str, f: int, convs) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{c}.{leaf}": np.zeros((f, f, 3, 3) if leaf == "weight" else (f,),
                                             np.float32)
            for c in convs for leaf in ("weight", "bias")}


def dpt_hybrid_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``DPTHybridDepth``'s flat params -> ``lkgd_torch.models.midas.DPTHybridDepth``'s
    state dict (isl-org MiDaS names)."""
    out = {}
    vit = "pretrained.model."
    for module, leaf, x in _flat_items(flat):
        leaf, x = _torch_leaf(leaf, x)
        parts = module.split(".") if module else []
        if parts and parts[0] == "backbone":
            rest = ".".join(parts[1:])
            rest = rest.replace("stem_conv", "stem.conv").replace("stem_norm", "stem.norm")
            rest = re.sub(r"stages_(\d+)_blocks_(\d+)", r"stages.\1.blocks.\2", rest)
            rest = rest.replace("downsample_conv", "downsample.conv").replace(
                "downsample_norm", "downsample.norm")
            name = f"{vit}patch_embed.backbone.{rest}.{leaf}"
        elif module == "":
            name = vit + leaf  # cls_token, pos_embed
        elif module == "patch_embed_proj":
            name = f"{vit}patch_embed.proj.{leaf}"
        elif parts[0].startswith("blocks_"):
            sub = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
                   "fc2": "mlp.fc2"}.get(parts[1], parts[1])
            name = f"{vit}blocks.{parts[0][len('blocks_'):]}.{sub}.{leaf}"
        elif parts[0].startswith("readout_"):
            name = f"pretrained.act_postprocess{parts[0].split('_')[1]}.0.project.0.{leaf}"
        elif parts[0].startswith("act_postprocess"):
            n, what = re.match(r"act_postprocess(\d)_(conv|down)", parts[0]).groups()
            name = f"pretrained.act_postprocess{n}.{3 if what == 'conv' else 4}.{leaf}"
        elif parts[0].startswith("head_conv"):
            name = f"scratch.output_conv.{2 * (int(parts[0][-1]) - 1)}.{leaf}"
        else:  # layer<i>_rn, refinenet<n>.*
            name = f"scratch.{module}.{leaf}"
        out[name] = x
    d = out[vit + "cls_token"].shape[-1]
    f = out["scratch.layer1_rn.weight"].shape[0]
    out[vit + "norm.weight"], out[vit + "norm.bias"] = np.ones(d, np.float32), np.zeros(d, np.float32)
    out.update(_dead_fusion_unit("scratch.refinenet4.resConfUnit1", f, ("conv1", "conv2")))
    return _tensors(out)


def _hf_fusion_name(j: int, rest: str) -> str:
    """A fusion block's inner names -> HF's (``resConfUnit``/``res`` -> ``residual_layer``,
    ``conv`` -> ``convolution``, ``out_conv`` -> ``projection``) under fusion layer ``j``."""
    rest = re.sub(r"^(resConfUnit|res)(\d)", r"residual_layer\2", rest)
    rest = re.sub(r"\bconv(\d)\b", r"convolution\1", rest)
    rest = rest.replace("out_conv", "projection")
    return f"neck.fusion_stage.layers.{j}.{rest}"


def dpt_large_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``DPTLargeDepth``'s flat params -> ``lkgd_torch.models.midas.DPTLargeDepth``'s
    state dict (HF ``DPTForDepthEstimation`` names)."""
    out = {}
    for module, leaf, x in _flat_items(flat):
        parts = module.split(".") if module else []
        if re.match(r"reassemble[12]_resize$", module) and leaf == "kernel":
            # the block upsample's (s, s, in, out) kernel -> ConvTranspose2d (in, out, s, s)
            name, x = "weight", x.transpose(2, 3, 0, 1)
        else:
            name, x = _torch_leaf(leaf, x)
        if module == "":
            out[{"cls_token": "dpt.embeddings.cls_token",
                 "pos_embed": "dpt.embeddings.position_embeddings"}[leaf]] = x
        elif module == "patch_embed_proj":
            out[f"dpt.embeddings.patch_embeddings.projection.{name}"] = x
        elif parts[0].startswith("blocks_"):
            layer = f"dpt.encoder.layer.{parts[0][len('blocks_'):]}."
            if parts[1] == "qkv":
                for part, y in zip(("query", "key", "value"), np.split(x, 3, axis=0)):
                    out[f"{layer}attention.attention.{part}.{name}"] = y
                continue
            sub = {"norm1": "layernorm_before", "norm2": "layernorm_after",
                   "proj": "attention.output.dense", "fc1": "intermediate.dense",
                   "fc2": "output.dense"}[parts[1]]
            out[f"{layer}{sub}.{name}"] = x
        elif parts[0].startswith("readout_"):
            i = int(parts[0].split("_")[1]) - 1
            out[f"neck.reassemble_stage.readout_projects.{i}.0.{name}"] = x
        elif parts[0].startswith("reassemble"):
            i, what = re.match(r"reassemble(\d)_(proj|resize|down)", parts[0]).groups()
            part = "projection" if what == "proj" else "resize"
            out[f"neck.reassemble_stage.layers.{int(i) - 1}.{part}.{name}"] = x
        elif parts[0].endswith("_rn"):
            out[f"neck.convs.{int(parts[0][len('layer')]) - 1}.{name}"] = x
        elif parts[0].startswith("refinenet"):
            out[_hf_fusion_name(4 - int(parts[0][-1]), ".".join(parts[1:]) + "." + name)] = x
        else:  # head_conv<k>
            out[f"head.head.{2 * (int(parts[0][-1]) - 1)}.{name}"] = x
    d = out["dpt.embeddings.cls_token"].shape[-1]
    f = out["neck.convs.0.weight"].shape[0]
    out["dpt.layernorm.weight"], out["dpt.layernorm.bias"] = (np.ones(d, np.float32),
                                                              np.zeros(d, np.float32))
    out.update(_dead_fusion_unit("neck.fusion_stage.layers.0.residual_layer1", f,
                                 ("convolution1", "convolution2")))
    return _tensors(out)


def depth_anything_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``DepthAnything``'s flat params -> ``lkgd_torch.models.depth_anything``'s
    state dict (HF ``DepthAnythingForDepthEstimation`` names). flax's ``ConvTranspose``
    applies its kernel mirrored against torch's ``ConvTranspose2d``: the reassemble kernels
    are flipped here, so that the port computes what the JAX module computes."""
    out = {}
    emb = "backbone.embeddings."
    for module, leaf, x in _flat_items(flat):
        parts = module.split(".") if module else []
        if re.match(r"reassemble_[01]_resize$", module) and leaf == "kernel":
            name, x = "weight", x[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            name, x = _torch_leaf(leaf, x)
        if module == "":
            out[emb + leaf] = x  # cls_token, position_embeddings
        elif module == "patch_embed":
            out[f"{emb}patch_embeddings.projection.{name}"] = x
        elif parts[0].startswith("layer_"):
            layer = f"backbone.encoder.layer.{parts[0][len('layer_'):]}."
            if len(parts) == 1:  # layer_scale1, layer_scale2
                out[f"{layer}{leaf}.lambda1"] = x
                continue
            sub = {"q": "attention.attention.query", "k": "attention.attention.key",
                   "v": "attention.attention.value", "proj": "attention.output.dense",
                   "fc1": "mlp.fc1", "fc2": "mlp.fc2"}.get(parts[1], parts[1])
            out[f"{layer}{sub}.{name}"] = x
        elif module == "backbone_norm":
            out[f"backbone.layernorm.{name}"] = x
        elif parts[0].startswith("reassemble_"):
            j, what = re.match(r"reassemble_(\d)_(projection|resize)", parts[0]).groups()
            out[f"neck.reassemble_stage.layers.{j}.{what}.{name}"] = x
        elif parts[0].startswith("neck_convs_"):
            out[f"neck.convs.{parts[0][-1]}.{name}"] = x
        elif parts[0].startswith("fusion_"):
            j, rest = re.match(r"fusion_(\d)_(\w+)", parts[0]).groups()
            out[_hf_fusion_name(3 - int(j), ".".join([rest, *parts[1:], name]))] = x
        else:  # head_conv<k>
            out[f"head.conv{parts[0][-1]}.{name}"] = x
    d = out[emb + "cls_token"].shape[-1]
    f = out["neck.convs.0.weight"].shape[0]
    out[emb + "mask_token"] = np.zeros((1, d), np.float32)
    out.update(_dead_fusion_unit("neck.fusion_stage.layers.0.residual_layer1", f,
                                 ("convolution1", "convolution2")))
    return _tensors(out)


def _conv_items(flat: Mapping[str, np.ndarray]):
    """``(module path, torch leaf name, array in torch's layout)`` of each flax leaf. A
    transposed convolution's kernel (flax ``transpose_kernel=True``, (kh, kw, out, in)) takes
    the convolution rule to torch's (in, out, kh, kw)."""
    for module, leaf, x in _flat_items(flat):
        name, x = _torch_leaf(leaf, x)
        yield module, name, x


def hed_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``ControlNetHED``'s flat params -> ``lkgd_torch.models.hed.ControlNetHED``'s
    state dict (``ControlNetHED.pth``'s names: ``norm`` (1, 3, 1, 1), ``blockN.convs.i``)."""
    out = {}
    for module, name, x in _conv_items(flat):
        if module == "":
            out[name] = x.reshape(1, 3, 1, 1)
        else:
            out[re.sub(r"\.convs_(\d+)$", r".convs.\1", module) + "." + name] = x
    return _tensors(out)


def pidinet_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``PiDiNet``'s flat params (plain, converted kernels) ->
    ``lkgd_torch.models.pidinet.PiDiNet``'s state dict (``table5_pidinet.pth``'s names, the
    kernels as ``port_pidinet`` leaves them)."""
    out = {}
    for module, name, x in _conv_items(flat):
        module = re.sub(r"^(dilations|attentions|conv_reduces)_(\d)", r"\1.\2", module)
        out[f"{module}.{name}"] = x
    return _tensors(out)


def lineart_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``LineartGenerator``'s flat params -> ``lkgd_torch.models.lineart``'s state
    dict (Informative-Drawings' ``model0`` ... ``model4`` names, the inverse of
    ``lineart_key_map``)."""
    table = {"stem": "model0.1", "down0": "model1.0", "down1": "model1.3", "up0": "model3.0",
             "up1": "model3.3", "head": "model4.1"}
    out = {}
    for module, name, x in _conv_items(flat):
        m = re.match(r"res(\d+)\.conv([12])$", module)
        prefix = (f"model2.{m.group(1)}.conv_block.{1 if m.group(2) == '1' else 5}" if m
                  else table[module])
        out[f"{prefix}.{name}"] = x
    return _tensors(out)


def lineart_anime_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``LineartAnimeGenerator``'s flat params -> ``lkgd_torch.models.lineart_anime``'s
    state dict (pix2pix's nested names, the inverse of ``port_lineart_anime``)."""
    from lkgd_torch.models.lineart_anime import lineart_anime_key

    items = list(_conv_items(flat))
    num_downs = len({module.split(".")[0] for module, _, _ in items})
    out = {}
    for module, name, x in items:
        level, updown = module.split(".")
        out[f"{lineart_anime_key(int(level[len('level_'):]), num_downs, updown)}.{name}"] = x
    return _tensors(out)


def openpose_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``BodyPoseModel``'s flat params -> ``lkgd_torch.models.openpose``'s state dict
    (controlnet_aux's ``model0.conv1_1`` ... ``model6_2.Mconv7_stage6_L2``)."""
    out = {}
    for module, name, x in _conv_items(flat):
        block, conv = re.match(r"(model0|model\d_\d)_(\w+)$", module).groups()
        out[f"{block}.{conv}.{name}"] = x
    return _tensors(out)


def segformer_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX SegFormer's flat params -> ``lkgd_torch.models.segformer``'s state dict (HF
    ``SegformerForSemanticSegmentation`` names, the inverse of ``segformer_key_map``; the
    decode head's ``num_batches_tracked``, which the JAX module does not hold, 0)."""
    enc = "segformer.encoder."
    block_parts = {"norm1": "layer_norm_1", "norm2": "layer_norm_2",
                   "attn.query": "attention.self.query", "attn.key": "attention.self.key",
                   "attn.value": "attention.self.value", "attn.sr": "attention.self.sr",
                   "attn.sr_norm": "attention.self.layer_norm",
                   "attn.out": "attention.output.dense", "mlp.dense1": "mlp.dense1",
                   "mlp.dwconv": "mlp.dwconv.dwconv", "mlp.dense2": "mlp.dense2"}
    bn = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
          "bn_var": "running_var"}
    out = {}
    for module, name, x in _conv_items(flat):
        if module == "":
            out[f"decode_head.batch_norm.{bn[name]}"] = x
            continue
        m = re.match(r"(patch_embed|patch_norm|stage_norm|linear_c)_(\d)$", module)
        if m:
            kind, i = m.groups()
            prefix = {"patch_embed": f"{enc}patch_embeddings.{i}.proj",
                      "patch_norm": f"{enc}patch_embeddings.{i}.layer_norm",
                      "stage_norm": f"{enc}layer_norm.{i}",
                      "linear_c": f"decode_head.linear_c.{i}.proj"}[kind]
        elif module in ("linear_fuse", "classifier"):
            prefix = f"decode_head.{module}"
        else:
            i, j, part, rest = re.match(r"block_(\d)_(\d+)_(norm1|norm2|attn|mlp)(.*)$",
                                        module).groups()
            prefix = f"{enc}block.{i}.{j}.{block_parts[part + rest]}"
        out[f"{prefix}.{name}"] = x
    out["decode_head.batch_norm.num_batches_tracked"] = np.zeros((), np.float32)
    return _tensors(out)


def blip_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``BlipCaptioner``'s flat params -> ``lkgd_torch.models.blip``'s state dict (HF
    ``BlipForConditionalGeneration`` names, the inverse of ``port_blip``; the prediction
    bias under both names HF ties it to)."""
    vis, txt = "vision_model.", "text_decoder."
    vision_parts = {"qkv": "self_attn.qkv", "projection": "self_attn.projection",
                    "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    text_top = {"word_embeddings": "bert.embeddings.word_embeddings",
                "position_embeddings": "bert.embeddings.position_embeddings",
                "embeddings_LayerNorm": "bert.embeddings.LayerNorm",
                "transform_dense": "cls.predictions.transform.dense",
                "transform_LayerNorm": "cls.predictions.transform.LayerNorm",
                "decoder": "cls.predictions.decoder"}
    layer_parts = {"intermediate": "intermediate.dense", "output": "output.dense",
                   "output_LayerNorm": "output.LayerNorm"}
    out = {}
    for module, leaf, x in _flat_items(flat):
        name, x = _torch_leaf(leaf, x)
        if name == "embedding":
            name = "weight"
        tower, *parts = module.split(".")
        if tower == "vision_model":
            if not parts:  # class_embedding (1, 1, D), position_embedding (1, N, D)
                out[f"{vis}embeddings.{leaf}"] = x
            elif parts[0] == "patch_embedding":
                out[f"{vis}embeddings.patch_embedding.{name}"] = x
            elif parts[0] == "post_layernorm":
                out[f"{vis}post_layernorm.{name}"] = x
            else:
                i = parts[0][len("layers_"):]
                out[f"{vis}encoder.layers.{i}.{vision_parts.get(parts[1], parts[1])}.{name}"] = x
        elif parts[0] in text_top:
            out[f"{txt}{text_top[parts[0]]}.{name}"] = x
        else:
            i = parts[0][len("layer_"):]
            if parts[1] in ("attention", "crossattention"):
                sub = {"dense": "output.dense", "LayerNorm": "output.LayerNorm"}.get(
                    parts[2], f"self.{parts[2]}")
                part = f"{parts[1]}.{sub}"
            else:
                part = layer_parts[parts[1]]
            out[f"{txt}bert.encoder.layer.{i}.{part}.{name}"] = x
    out[f"{txt}cls.predictions.bias"] = out[f"{txt}cls.predictions.decoder.bias"]
    return _tensors(out)


def cogvlm_export_name(path: str) -> str:
    """A flat JAX ``CogVLMVideoCaptioner`` param path (``params/`` dropped) -> its THUDM
    ``modeling_cogvlm.py`` / ``visual.py`` name, the inverse of ``cogvlm_key_map``."""
    parts = path.split("/")
    leaf = parts[-1]
    if parts[0] in ("boi", "eoi"):
        return f"model.vision.{parts[0]}"
    if parts[0] == "final_norm":
        return "model.norm.weight"
    if parts[0] == "lm_head":
        return "lm_head.weight"
    if parts[0] == "embed_tokens":
        return "model.embed_tokens.weight"
    name = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
    if parts[0] == "vision":
        v = parts[1:-1]
        if v == []:
            return {"cls_embedding": "model.vision.patch_embedding.cls_embedding",
                    "position_embedding":
                        "model.vision.patch_embedding.position_embedding.weight"}[leaf]
        if v[0] == "patch_embedding":
            return f"model.vision.patch_embedding.proj.{name}"
        if v[0] == "conv":
            return f"model.vision.conv.{name}"
        if v[0].startswith("layers_"):
            sub = {"query_key_value": "attention.query_key_value", "dense": "attention.dense",
                   "fc1": "mlp.fc1", "fc2": "mlp.fc2"}.get(v[1], v[1])
            return f"model.vision.transformer.layers.{v[0][len('layers_'):]}.{sub}.{name}"
        return f"model.vision.linear_proj.{v[0]}.{name}"  # the GLU adapter
    i = parts[0][len("layers_"):]
    if len(parts) == 2:  # input_layernorm, post_attention_layernorm
        return f"model.layers.{i}.{leaf}.weight"
    proj, expert = parts[1], parts[2]
    if proj in ("qkv", "dense"):
        what = "query_key_value" if proj == "qkv" else "dense"
        return f"model.layers.{i}.self_attn.{expert}_expert_{what}.{name}"
    return f"model.layers.{i}.mlp.{expert}_mlp.{proj}.{name}"


def cogvlm_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``CogVLMVideoCaptioner``'s flat params -> ``lkgd_torch.models.cogvlm``'s state
    dict (THUDM's names: Dense kernels transposed, convolutions OIHW, the cls embedding
    (1, D), the position embedding's table (N, D))."""
    out = {}
    for path, value in flat.items():
        path = path[len("params/"):] if path.startswith("params/") else path
        x = np.asarray(value, np.float32)
        name = cogvlm_export_name(path)
        if path.endswith("/kernel"):
            x = x.T if x.ndim == 2 else x.transpose(3, 2, 0, 1)
        elif path in ("vision/cls_embedding", "vision/position_embedding"):
            x = x.reshape(-1, x.shape[-1])
        out[name] = x
    return _tensors(out)
