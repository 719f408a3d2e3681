"""Static model configurations of the port (base fields only).

Counterparts of ``lkgd_tpu/models/configs.py`` ``SVDUNetConfig`` (:96-160),
``lkgd_tpu/models/vae_temporal.py`` ``TemporalVAEConfig`` (:30-37) and
``lkgd_tpu/models/clip_vision.py`` ``CLIPVisionConfig`` (:22-41). The JAX configs cannot
be imported here (they reach flax), so the port carries its own with the same field names
and defaults. Of the LKGD extensions of the JAX UNet config, knowledge fusion, joint
attention and LoRA routing are fields that raise ``NotImplementedError`` when set; the
rest (dual conditioning, a y input head, remat) are absent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
    # LKGD extensions of the JAX config, not ported yet: only the defaults are accepted
    knowledge_fusion: bool = False
    joint: None = None
    lora: None = None

    def __post_init__(self):
        for name in ("knowledge_fusion", "joint", "lora"):
            if getattr(self, name):
                raise NotImplementedError(f"SVDUNetConfig.{name} is not ported to lkgd_torch yet")

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
