"""Static model configurations of the port.

Counterparts of ``lkgd_tpu/models/configs.py`` ``LoraRule`` / ``LoraRouter`` (:58-93) and
``SVDUNetConfig`` (:96-160), ``lkgd_tpu/models/vae_temporal.py`` ``TemporalVAEConfig``
(:30-37) and ``lkgd_tpu/models/clip_vision.py`` ``CLIPVisionConfig`` (:22-41). The JAX
configs cannot be imported here (they reach flax), so the port carries its own with the
same field names and defaults. Of the LKGD extensions of the JAX UNet config, knowledge
fusion, LoRA routing and remat are ported; joint attention is a field that raises
``NotImplementedError`` when set; the rest (dual conditioning, a y input head) are absent.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple

from lkgd_torch.models.layers import LoraSpec


@dataclasses.dataclass(frozen=True)
class LoraRule:
    """Route an adapter onto the projections whose diffusers-style path matches
    ``pattern`` (fnmatch, or a plain substring). ``streams`` is the static row mask."""

    pattern: str
    name: str
    rank: int = 4
    alpha: float = 4.0
    streams: Tuple[int, ...] = ()
    projections: Tuple[str, ...] = ("to_q", "to_k", "to_v")

    def matches(self, path: str, projection: str) -> bool:
        if projection not in self.projections:
            return False
        full = f"{path}.{projection}"
        return fnmatch.fnmatch(full, self.pattern) or self.pattern in full


@dataclasses.dataclass(frozen=True)
class LoraRouter:
    rules: Tuple[LoraRule, ...] = ()

    def resolve(self, path: str, projection: str) -> Tuple[LoraSpec, ...]:
        """The adapters of one projection (the joint branch's inverted stream masks come
        with joint attention, which is not ported)."""
        return tuple(LoraSpec(rule.name, rule.rank, rule.alpha, rule.streams)
                     for rule in self.rules if rule.matches(path, projection))

    def adapters(self, path: str) -> dict:
        """The specs of every projection of the attention at ``path``, keyed by name."""
        return {proj: self.resolve(path, proj) for proj in ("to_q", "to_k", "to_v", "to_out")}


EMPTY_ROUTER = LoraRouter()


@dataclasses.dataclass(frozen=True)
class SVDUNetConfig:
    """UNetSpatioTemporalCondition (HF svd/svd-xt checkpoint values)."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: int = 1
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    num_frames: int = 25
    sample_size: int = 96
    # GroupNorm eps inside spatio-temporal resblocks: the JAX package's uniform 1e-5 and
    # its per-block-type overrides (lkgd_tpu/models/configs.py:126-142), kept as they are
    resnet_eps: float = 1e-5
    resnet_eps_cross: Optional[float] = None  # CrossAttn{Down,Up} blocks (None -> resnet_eps)
    resnet_eps_up: Optional[float] = None     # plain UpBlockSpatioTemporal (None -> resnet_eps)
    # LKGD extensions
    knowledge_fusion: bool = False  # quaternion latent-knowledge fusion on the context
    lora: LoraRouter = EMPTY_ROUTER
    # gradient checkpointing: recompute each down, mid and up block in the backward pass
    remat: bool = False
    joint: None = None  # joint attention: not ported yet, only the default is accepted

    def __post_init__(self):
        if self.joint:
            raise NotImplementedError("SVDUNetConfig.joint (joint attention, the trans API) is "
                                      "not ported to lkgd_torch yet (ROADMAP.md Queue 1, item 8)")

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class TemporalVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """laion/CLIP-ViT-H-14 as SVD uses it: patch 14, width 1280, 32 layers, 16 heads."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    projection_dim: int = 1024
    hidden_act: str = "gelu"  # laion ViT-H; openai models use quick_gelu
    layer_norm_eps: float = 1e-5

    @classmethod
    def vit_h_14(cls) -> "CLIPVisionConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=2,
                   intermediate_size=128, projection_dim=32)
