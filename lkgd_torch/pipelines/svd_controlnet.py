"""ControlNet-conditioned image-to-video (counterpart of
``lkgd_tpu/pipelines/svd_controlnet.py`` ``StableVideoDiffusionControlNetPipeline``):
per-frame control images (depth, flow, edges) feed a ControlNet-SDV beside the UNet, whose
zero-init residuals are added to the UNet's skips and mid block at every step.

One class covers the reference's ControlNet video pipeline, its frame-transition form (a
joint UNet over an image pair: CFG rows ``[u0, u1, c0, c1]``, the control broadcast to both
streams) and its time-reversal form (``reverse_time``: generation conditioned on the last
frame, by flipping the initial latents and the control along the frames and the result
back; the image conditioning is not flipped). ``controlnet_cond_scale`` scales the
residuals inside the ControlNet, ``controlnet_scale`` once more here. The loop is the base
pipeline's, batched or ``sequential_cfg`` (``unet_seq`` and the same ControlNet on each
half); DeepCache is refused, as the JAX pipeline's loop has none.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lkgd_torch.models.controlnet_svd import ControlNetSDV, ControlNetSDVConfig
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline, as_batch


class StableVideoDiffusionControlNetPipeline(StableVideoDiffusionPipeline):
    """image ``(B, H, W, 3)`` and control ``(T, H, W, C)`` or ``(B, T, H, W, C)`` in [0, 1]
    -> frames ``(B, T, H, W, 3)``. The ControlNet is built on ``device`` in ``dtype`` beside
    the UNet (uninitialised: ``init_params`` or ``controlnet.load_state_dict``)."""

    deep_cache = False

    def __init__(self, *args, controlnet_config: Optional[ControlNetSDVConfig] = None,
                 controlnet_cond_scale: float = 1.0, controlnet_scale: float = 1.0,
                 reverse_time: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        config = controlnet_config or ControlNetSDVConfig(unet=self.unet.config)
        self.controlnet = materialize(lambda: ControlNetSDV(config), self.device, self.dtype)
        self.controlnet.eval().requires_grad_(False)
        self.controlnet_cond_scale = controlnet_cond_scale
        self.controlnet_scale = controlnet_scale
        self.reverse_time = reverse_time

    def init_params(self, generator: torch.Generator) -> None:
        super().init_params(generator)
        init_params(self.controlnet, generator)

    def _predict(self, unet, model_in, t, emb, ati, control):
        down, mid = self.controlnet(model_in, t, emb, ati, controlnet_cond=control,
                                    conditioning_scale=self.controlnet_cond_scale)
        return unet(model_in, t, emb, ati,
                    down_block_additional_residuals=[r * self.controlnet_scale for r in down],
                    mid_block_additional_residual=mid * self.controlnet_scale)

    @torch.inference_mode()
    def denoise(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_aug: Optional[torch.Tensor] = None,
                initial_noise: Optional[torch.Tensor] = None,
                control: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image: [0,1] (B, H, W, 3), control (T, H, W, C), (B, T, H, W, C) or None (zeros)
        -> latents (B, T, h, w, 4) fp32."""
        cfg = self.config
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        image = image.to(self.device, torch.float32)
        batch_size = image.shape[0]
        image_embeddings, image_latents, added_time_ids = self._condition(
            image, generator, noise_aug)
        latents = self._initial_latents(batch_size, generator, initial_noise)

        if control is None:
            control = torch.zeros((batch_size, cfg.num_frames, cfg.height, cfg.width,
                                   self.controlnet.config.conditioning_channels),
                                  device=self.device)
        else:
            control = control.to(self.device, torch.float32)
            if control.dim() == 4:
                control = control[None].expand(batch_size, *control.shape)
        if self.reverse_time:  # last-frame conditioning
            latents, control = latents.flip(1), control.flip(1)
        rows = [control] * (2 if cfg.do_classifier_free_guidance else 1)
        control_rows = torch.cat(rows).to(self.dtype)

        latents = self._loop(latents, image_embeddings, image_latents, added_time_ids,
                             control_rows)
        return latents.flip(1) if self.reverse_time else latents

    def __call__(self, image, control=None, generator: Optional[torch.Generator] = None,
                 output_type: str = "np", noise_aug: Optional[torch.Tensor] = None,
                 initial_noise: Optional[torch.Tensor] = None):
        """``image`` (B, H, W, 3) or (H, W, 3), ``control`` as in ``denoise``; arrays or
        tensors. ``output_type`` as in the base pipeline."""
        control = None if control is None else torch.as_tensor(
            np.asarray(control) if not torch.is_tensor(control) else control, dtype=torch.float32)
        latents = self.denoise(as_batch(image), generator, noise_aug, initial_noise,
                               control=control)
        if output_type == "latent":
            return latents
        frames = self.decode_latents(latents)
        return frames.cpu().numpy() if output_type == "np" else frames
