"""Optical-flow video diffusion (counterpart of ``lkgd_tpu/pipelines/svd_flow.py``).

- ``StableVideoDiffusionFlowPipeline``, ``mode="flow"``: denoise a flow video. CLIP
  conditions on the RGB frame; the conditioning channels carry the latents of the
  flow-condition image, normalised with the flow latents' mean and std (and the VAE's
  scale), and the result is un-normalised before the decode.
- ``mode="flow_fix"``: conditions on both, ``[flow latents | RGB latents]`` (8 channels,
  not normalised), through the dual-``conv_in`` UNet (``dual_cond_conv_in``,
  ``in_channels=12``).
- ``StableVideoDiffusionJointVFPipeline``: a video and its flow as two coupled streams of a
  joint UNet (rows ``[rgb_u, flow_u, rgb_c, flow_c]``); returns ``(frames, flows)``.

The JAX pipelines draw their own noise from ``jax.random.split(rng, 3)``; here the draws
come from the ``torch.Generator`` or are given: ``noise_aug`` is the first augmentation
noise (the flow condition's in ``flow`` and ``flow_fix``, the RGB frame's in joint
video+flow), ``noise_aug2`` the second (the RGB frame's in ``flow_fix``, the flow
condition's in joint video+flow), ``initial_noise`` the latents'. The JAX loops are batched
CFG only: ``sequential_cfg`` and ``deep_cache_interval`` above 1 are refused.
"""

from __future__ import annotations

from typing import Optional

import torch

from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline, as_batch
from lkgd_torch.utils.flow_codec import flow_latent_normalize, flow_latent_unnormalize


class _FlowBase(StableVideoDiffusionPipeline):
    base_loop = False  # the JAX pipeline's loop has neither DeepCache nor a split

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.config.sequential_cfg:
            raise ValueError(f"{type(self).__name__} runs batched CFG only, as the JAX "
                             f"pipeline does: sequential_cfg must be False")

    def __call__(self, image, flow_cond=None, generator: Optional[torch.Generator] = None,
                 output_type: str = "np", noise_aug: Optional[torch.Tensor] = None,
                 noise_aug2: Optional[torch.Tensor] = None,
                 initial_noise: Optional[torch.Tensor] = None):
        """``image`` and ``flow_cond`` (B, H, W, 3) or (H, W, 3), arrays or tensors;
        ``output_type``: "np" or "pt" frames (decoded as ``_frames`` says), "latent"."""
        latents = self.denoise(as_batch(image), generator, noise_aug, initial_noise,
                               flow_cond=as_batch(flow_cond), noise_aug2=noise_aug2)
        if output_type == "latent":
            return latents
        out = self._frames(latents)
        if output_type != "np":
            return out
        return (tuple(x.cpu().numpy() for x in out) if isinstance(out, tuple)
                else out.cpu().numpy())


class StableVideoDiffusionFlowPipeline(_FlowBase):
    """image ``(B, H, W, 3)`` and flow-condition image ``(B, H, W, 3)`` (zeros if None) in
    [0, 1] -> a flow video ``(B, T, H, W, 3)``."""

    def __init__(self, *args, mode: str = "flow", **kwargs):
        if mode not in ("flow", "flow_fix"):
            raise ValueError(f"mode must be 'flow' or 'flow_fix', got {mode!r}")
        super().__init__(*args, **kwargs)
        self.mode = mode

    @torch.inference_mode()
    def denoise(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_aug: Optional[torch.Tensor] = None,
                initial_noise: Optional[torch.Tensor] = None,
                flow_cond: Optional[torch.Tensor] = None,
                noise_aug2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> normalised flow latents (B, T, h, w, 4) fp32 (``__call__`` un-normalises
        them before the decode)."""
        cfg = self.config
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        image = image.to(self.device, torch.float32)
        flow_cond = (torch.zeros_like(image) if flow_cond is None
                     else flow_cond.to(self.device, torch.float32))
        image_embeddings = self._cfg_rows(self._encode_clip(image))
        flow_lat = self._cfg_rows(self._augmented_latents(flow_cond, generator, noise_aug))
        if self.mode == "flow":
            cond = flow_latent_normalize(flow_lat, scale=self.vae_scaling)
        else:  # flow_fix: [flow latents | RGB latents]
            rgb_lat = self._cfg_rows(self._augmented_latents(image, generator, noise_aug2))
            cond = torch.cat([flow_lat, rgb_lat], dim=-1)
        cond = cond[:, None].expand(-1, cfg.num_frames, -1, -1, -1)
        added_time_ids = self._add_time_ids(cond.shape[0])
        latents = self._initial_latents(image.shape[0], generator, initial_noise)
        return self._loop(latents, image_embeddings, cond, added_time_ids)

    def _frames(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decode_latents(flow_latent_unnormalize(latents))


class StableVideoDiffusionJointVFPipeline(_FlowBase):
    """One image ``(1, H, W, 3)`` (and optionally its flow-condition image) -> ``(frames,
    flows)``, each ``(1, T, H, W, 3)``: stream 0 denoises the RGB video, stream 1 the flow
    video, coupled through the joint UNet (mask ``(0, 1, 0, 1)``)."""

    @torch.inference_mode()
    def denoise(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_aug: Optional[torch.Tensor] = None,
                initial_noise: Optional[torch.Tensor] = None,
                flow_cond: Optional[torch.Tensor] = None,
                noise_aug2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> latents (2, T, h, w, 4) fp32: the RGB stream, then the normalised flow."""
        cfg = self.config
        if image.shape[0] != 1:
            raise ValueError(f"joint video+flow generates one pair, got {image.shape[0]} "
                             f"images")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        image = image.to(self.device, torch.float32)
        image_embeddings = self._cfg_rows(self._encode_clip(image).repeat(2, 1, 1))  # x, y
        img_lat = self._augmented_latents(image, generator, noise_aug)
        if flow_cond is None:  # normalised zero latents, not zeros
            flow_lat = img_lat * 0.0
        else:
            flow_lat = self._augmented_latents(flow_cond.to(self.device, torch.float32),
                                               generator, noise_aug2)
        flow_lat = flow_latent_normalize(flow_lat, scale=self.vae_scaling)
        cond = self._cfg_rows(torch.cat([img_lat, flow_lat]))
        cond = cond[:, None].expand(-1, cfg.num_frames, -1, -1, -1)
        added_time_ids = self._add_time_ids(cond.shape[0])
        latents = self._initial_latents(2, generator, initial_noise)
        return self._loop(latents, image_embeddings, cond, added_time_ids)

    def _frames(self, latents: torch.Tensor) -> tuple:
        # two decodes of the same shape: the RGB stream as it is, the flow un-normalised
        return (self.decode_latents(latents[:1]),
                self.decode_latents(flow_latent_unnormalize(latents[1:])))
