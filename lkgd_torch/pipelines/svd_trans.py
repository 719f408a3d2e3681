"""Frame-transition generation (counterpart of ``lkgd_tpu/pipelines/svd_trans.py``
``StableVideoDiffusionTransPipeline``): a clip conditioned on BOTH a start and an end frame,
as two coupled streams (x conditioned on the start, y on the end) whose self-attention
layers talk to each other through the UNet's joint-attention branch.

The joint topology is the UNet's config (``SVDUNetConfig.joint``); the pipeline orders the
batch stream-major, ``[x_uncond, y_uncond, x_cond, y_cond]``, which the joint mask
``(0, 1, 0, 1)`` describes. Each stream gets the CLIP embedding and the VAE latents of its
own frame, so the generation loop is the base pipeline's over a batch of two images: this
class adds the pairing and the ``(start_image, end_image)`` call. ``sequential_cfg`` runs
``[x_uncond, y_uncond]`` and ``[x_cond, y_cond]`` one after the other under the halved
mask ``(0, 1)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline


def _as_image(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32)


class StableVideoDiffusionTransPipeline(StableVideoDiffusionPipeline):
    """images ``(2, H, W, 3)`` = ``[start_frame, end_frame]`` -> ``(2, T, H, W, 3)``: stream
    0 is the start -> end transition, stream 1 its end-conditioned twin."""

    deep_cache = False  # the JAX pipeline's loop has none

    def denoise(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_aug: Optional[torch.Tensor] = None,
                initial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if image.shape[0] % 2:
            raise ValueError("the trans pipeline expects [start, end] image pairs, got "
                             f"{image.shape[0]} images")
        return super().denoise(image, generator, noise_aug, initial_noise)

    def __call__(self, start_image, end_image=None, generator: Optional[torch.Generator] = None,
                 output_type: str = "np", noise_aug: Optional[torch.Tensor] = None,
                 initial_noise: Optional[torch.Tensor] = None):
        """``start_image`` and ``end_image``: ``(H, W, 3)`` in [0, 1] at pipeline size, or
        ``start_image`` alone already stacked ``(2, H, W, 3)``. ``output_type`` as in the
        base pipeline."""
        image = _as_image(start_image)
        if end_image is not None:
            image = torch.stack([image, _as_image(end_image)])
        return super().__call__(image, generator, output_type, noise_aug, initial_noise)
