"""Optical-flow codecs and the flow-latent normalisation (counterpart of
``lkgd_tpu/utils/flow_codec.py``): flow <-> RGB-image encodings, the polar expansion, and
the flow latents' mean and std that the flow pipelines normalise with. Channels-last, as
there."""

from __future__ import annotations

import math

import torch

FLOW_CLIP_MAX = 50.0
FLOW_NORM_CLIP_MAX = math.sqrt(2 * FLOW_CLIP_MAX**2)
FLOW_LATENT_MEAN = 0.5020191669464111
FLOW_LATENT_STD = 1.2818458080291748


def flow_latent_normalize(latents: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``((x * scale - mean) / std) / scale``, in fp32 inside, returned in ``latents``'
    dtype."""
    x = latents.float() * scale
    x = (x - FLOW_LATENT_MEAN) / FLOW_LATENT_STD
    return (x / scale).to(latents.dtype)


def flow_latent_unnormalize(latents: torch.Tensor) -> torch.Tensor:
    return latents * FLOW_LATENT_STD + FLOW_LATENT_MEAN


def flow_to_image_naive(flow: torch.Tensor) -> torch.Tensor:
    """``(..., H, W, 2)`` flow -> ``(..., H, W, 3)`` image in [0, 1]: ``[0, u, v]``, each
    clipped to +-50 and mapped to [0, 1]."""
    clipped = torch.clamp(flow, -FLOW_CLIP_MAX, FLOW_CLIP_MAX) / FLOW_CLIP_MAX
    clipped = (clipped + 1.0) / 2.0
    return torch.cat([torch.zeros_like(clipped[..., :1]), clipped], dim=-1)


def image_to_flow_naive(flow_image: torch.Tensor) -> torch.Tensor:
    """The inverse of ``flow_to_image_naive``."""
    return (flow_image[..., 1:] * 2.0 - 1.0) * FLOW_CLIP_MAX


def flow_expand_polar(flow: torch.Tensor) -> torch.Tensor:
    """``(..., H, W, 2)`` -> ``(..., H, W, 4)``: the flow, its norm and its angle / pi."""
    norm = torch.linalg.vector_norm(flow, dim=-1, keepdim=True)
    angle = torch.atan2(flow[..., 1:2], flow[..., 0:1]) / math.pi
    return torch.cat([flow, norm, angle], dim=-1)


def flow_squeeze_polar(flow4: torch.Tensor) -> torch.Tensor:
    """``(..., H, W, 4)`` -> ``(..., H, W, 2)`` from the polar channels."""
    norm, angle = flow4[..., 2], flow4[..., 3] * math.pi
    return torch.stack([torch.cos(angle) * norm, torch.sin(angle) * norm], dim=-1)
