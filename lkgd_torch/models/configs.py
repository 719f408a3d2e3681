"""Static model configurations of the port.

Counterparts of ``lkgd_tpu/models/configs.py`` ``JointAttentionConfig`` (:19-55),
``LoraRule`` / ``LoraRouter`` (:58-93), ``SVDUNetConfig`` (:96-160) and
``halve_stream_masks`` (:162-184), ``lkgd_tpu/models/vae_temporal.py``
``TemporalVAEConfig`` (:30-37), ``lkgd_tpu/models/clip_vision.py`` ``CLIPVisionConfig``
(:22-41), ``lkgd_tpu/models/cogvideox.py`` ``CogVideoXConfig`` (:33-102) and
``lkgd_tpu/models/vae_cogvideox.py`` ``CogVideoXVAEConfig`` (:26-39) and
``lkgd_tpu/models/t5_text.py`` ``T5Config`` (:26-45), and the SD-2D family's
``lkgd_tpu/models/unet_2d.py`` ``UNet2DConfig`` (:29-59), ``vae_2d.py`` ``VAE2DConfig``
(:19-21), ``controlnet_2d.py`` ``ControlNet2DConfig`` (:17-21) and ``clip_text.py``
``CLIPTextConfig`` (:20-38). The port imports nothing of the JAX
package, so it carries its own configs with the same field names and defaults, every LKGD
extension of the JAX UNet config included. ``CogVideoXConfig`` leaves out the JAX fields
that only multi-chip code reads (``sequence_parallel``, ``sp_axis``).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple

from lkgd_torch.models.layers import LoraSpec


@dataclasses.dataclass(frozen=True)
class JointAttentionConfig:
    """Static description of the joint x<->y stream attention: a second self-attention
    branch ``attn1n`` whose K and V come from the partner stream, followed by a zero-init
    post projection, added to the main attention output (scaled by ``joint_scale`` in the
    spatial blocks).

    ``mask``: one 0/1 per stream of the stream-major batch; 1 marks the "y" streams. It
    must hold as many 0s as 1s: the i-th 0-stream and the i-th 1-stream are partners. The
    CFG-doubled trans batch uses ``(0, 1, 0, 1)``. ``flip``: reverse the partner's frame
    axis before attending to it (spatial branch only). ``spatial`` / ``temporal``: which
    transformer blocks carry the branch."""

    post: str = "conv"  # conv | scale | conv_fuse
    add_norm: bool = False
    flip: bool = False
    mask: Tuple[int, ...] = (0, 1)
    spatial: bool = True
    temporal: bool = False

    def __post_init__(self):
        if self.post not in ("conv", "scale", "conv_fuse"):
            raise ValueError(f"unknown post processing type {self.post}")
        if sum(self.mask) * 2 != len(self.mask):
            raise ValueError(f"joint mask must be balanced, got {self.mask}")

    @property
    def partner_perm(self) -> Tuple[int, ...]:
        """The permutation sending each stream to its partner."""
        zeros = [i for i, m in enumerate(self.mask) if not m]
        ones = [i for i, m in enumerate(self.mask) if m]
        perm = [0] * len(self.mask)
        for a, b in zip(zeros, ones):
            perm[a], perm[b] = b, a
        return tuple(perm)


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

    def resolve(self, path: str, projection: str,
                invert_streams: bool = False) -> Tuple[LoraSpec, ...]:
        """The adapters of one projection. ``invert_streams``: each adapter's stream mask
        becomes ``1 - streams`` (the joint branch's K and V act on the partner stream)."""
        specs = []
        for rule in self.rules:
            if rule.matches(path, projection):
                streams = rule.streams
                if invert_streams and streams:
                    streams = tuple(1 - int(s) for s in streams)
                specs.append(LoraSpec(rule.name, rule.rank, rule.alpha, streams))
        return tuple(specs)

    def adapters(self, path: str, invert_kv: bool = False) -> dict:
        """The specs of every projection of the attention at ``path``, keyed by name;
        ``invert_kv`` inverts the stream masks of ``to_k`` and ``to_v``."""
        return {proj: self.resolve(path, proj, invert_kv and proj in ("to_k", "to_v"))
                for proj in ("to_q", "to_k", "to_v", "to_out")}


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
    joint: Optional[JointAttentionConfig] = None  # joint x<->y stream attention
    # flow variant: a second input convolution ``conv_in2`` scaled by ``conv_in2_alpha``,
    # both zero at init (lkgd_tpu/models/unet_svd.py:107-122)
    dual_cond_conv_in: bool = False
    # a second input head (``conv_in_y``, ``time_embedding_y``, ``add_embedding_y``) whose
    # rows are chosen by this static stream mask (1 = the y head); None = one head
    y_input_head_mask: Optional[Tuple[int, ...]] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def halve_stream_masks(cfg: SVDUNetConfig) -> SVDUNetConfig:
    """The same UNet for a half batch (one side of classifier-free guidance).

    Stream tuples (the joint mask, the LoRA row masks, the y-head mask) describe the
    CFG-doubled stream-major batch ``[*uncond_streams, *cond_streams]``; a sequential-CFG
    call sees one side only, so tuples of even length >= 4 are cut to their first half. The parameters are unchanged:
    masks are static routing, and a UNet built from either config takes the other's
    weights."""

    def half(t):
        return t[: len(t) // 2] if t and len(t) >= 4 and len(t) % 2 == 0 else t

    joint = cfg.joint
    if joint is not None:
        joint = dataclasses.replace(joint, mask=half(joint.mask))
    lora = cfg.lora
    if lora.rules:
        lora = dataclasses.replace(lora, rules=tuple(
            dataclasses.replace(r, streams=half(r.streams)) for r in lora.rules))
    y_mask = cfg.y_input_head_mask
    if y_mask is not None:
        y_mask = half(y_mask)
    return dataclasses.replace(cfg, joint=joint, lora=lora, y_input_head_mask=y_mask)


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


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    """The CogVideoX 3D transformer (DiT); defaults are CogVideoX-5B I2V."""

    num_layers: int = 42
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 32  # I2V: 16 noise + 16 image-condition latents
    out_channels: int = 16
    text_embed_dim: int = 4096
    time_embed_dim: int = 512
    patch_size: int = 2
    # CogVideoX 1.5: pairs of latent frames become one token row (diffusers patch_size_t);
    # None = 1.0, per-frame 2D patches
    patch_size_t: Optional[int] = None
    sample_frames: int = 49  # pixel frames; latent frames = (F - 1) / 4 + 1
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    rope_base_height: int = 480
    rope_base_width: int = 720
    # CogVideoX-2b: 3D sincos positions added to the video tokens instead of rotary ones
    use_rope: bool = True
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    knowledge_fusion: bool = True
    lora: LoraRouter = EMPTY_ROUTER
    # sequence parallelism over the video tokens (``parallel/sequence.py``): "ulysses" (an
    # all-to-all head exchange) or "ring" (K/V passed round the ranks), over the group of
    # the mesh's ``sp_axis`` (the transformer's ``context_group``); inference only
    sequence_parallel: str = "none"  # none | ulysses | ring
    sp_axis: str = "context"
    # gradient checkpointing: every transformer block recomputed in the backward pass
    remat: bool = False

    def __post_init__(self):
        if self.sequence_parallel not in ("none", "ulysses", "ring"):
            raise ValueError(f"sequence_parallel={self.sequence_parallel!r}: none, ulysses "
                             f"or ring")

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def cogvideox_5b_i2v(cls, **kw) -> "CogVideoXConfig":
        return cls(**kw)

    @classmethod
    def cogvideox_2b(cls, **kw) -> "CogVideoXConfig":
        """CogVideoX-2b (T2V): 30 layers x 30 heads, sincos positions instead of RoPE."""
        kw.setdefault("in_channels", 16)
        return cls(num_layers=30, num_attention_heads=30, attention_head_dim=64,
                   use_rope=False, **kw)

    @classmethod
    def cogvideox1_5_5b(cls, **kw) -> "CogVideoXConfig":
        """CogVideoX 1.5 5B (T2V): temporal patching, 768x1360 base, 81 frames."""
        kw.setdefault("in_channels", 16)
        return cls(patch_size_t=2, sample_frames=81, rope_base_height=768,
                   rope_base_width=1360, **kw)

    @classmethod
    def cogvideox1_5_5b_i2v(cls, **kw) -> "CogVideoXConfig":
        return cls.cogvideox1_5_5b(in_channels=32, **kw)

    @classmethod
    def tiny(cls, **kw) -> "CogVideoXConfig":
        return cls(num_layers=2, num_attention_heads=2, attention_head_dim=16,
                   in_channels=8, out_channels=4, text_embed_dim=64, time_embed_dim=32,
                   max_text_seq_length=8, **kw)


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    """The CogVideoX causal 3D VAE (``AutoencoderKLCogVideoX``)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    temporal_compress_levels: Tuple[bool, ...] = (True, True, False)  # per downsample
    scaling_factor: float = 0.7

    @classmethod
    def tiny(cls) -> "CogVideoXVAEConfig":
        return cls(latent_channels=4, block_out_channels=(32, 32, 64), layers_per_block=1,
                   temporal_compress_levels=(True, True))


@dataclasses.dataclass(frozen=True)
class T5Config:
    """The T5 v1.1 encoder; defaults are T5-XXL, CogVideoX's text encoder."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6

    @classmethod
    def xxl(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    """The SD 2D denoiser (SD2 widths by default)."""

    in_channels: int = 4  # 9 for inpaint (latents + mask + masked latents)
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")
    layers_per_block: int = 2
    transformer_layers_per_block: int = 1
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024  # SD2 OpenCLIP text width
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True
    # image-space conditioning encoder added at conv_in: its input channels
    cond_embedding_channels: Optional[int] = None
    cond_embedding_blocks: Tuple[int, ...] = (16, 32, 96, 256)
    joint: Optional[JointAttentionConfig] = None
    lora: LoraRouter = EMPTY_ROUTER
    # joint-frame track fusion in the spatial blocks: forward then takes tracks=(src_xy,
    # dst_xy, visibility), in image pixels when forward's track_image_size gives the
    # resolution, else on the latent grid
    track_fusion: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAE2DConfig(TemporalVAEConfig):
    """The SD image VAE: the temporal VAE's encoder with a plain 2D decoder."""

    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class ControlNet2DConfig:
    unet: UNet2DConfig = UNet2DConfig()
    conditioning_channels: int = 3
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """SD2's OpenCLIP-H text tower: 23 layers of width 1024 (the 24th is never run)."""

    vocab_size: int = 49408
    max_position_embeddings: int = 77
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def open_clip_h(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=128, max_position_embeddings=16, hidden_size=32,
                   num_layers=2, num_heads=2, intermediate_size=64)
