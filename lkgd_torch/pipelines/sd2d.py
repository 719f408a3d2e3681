"""SD 2D image pipelines (counterpart of ``lkgd_tpu/pipelines/sd2d.py``): inpainting with the
9-channel UNet (optionally with ControlNet-2D residuals), test-time latent optimisation,
joint image+modality generation by latent clamping, and the image-conditioned pipeline.

All take prompt *embeddings* (``models/clip_text.py`` encodes text in a separate step) and
run standard SD DDIM (``sd_ddim_config``: epsilon prediction, "leading" spacing, no SNR
shift, no zero-SNR rescale) on the port's CogVideoX DDIM scheduler, CFG-doubled
``[negative | prompt]``, in a Python loop where JAX had ``lax.scan``. Latents stay fp32
between steps; the model input is cast to the compute dtype and its output back to fp32.

Randomness comes from the ``torch.Generator`` passed in, or from ``initial_noise`` (the
starting latents' standard normals): the hook the parity tests use to give JAX's draw,
since torch and JAX generators never agree. The JAX pipelines draw ``normal(rng, (b, h, w,
4))`` (inpaint, condition) and ``normal(split(rng)[0], (2b, h, w, 4))`` (joint control).

Masks are resized to the latent grid with ``jax.image.resize(..., "nearest")``'s sampling,
at half-pixel centres: ``F.interpolate(mode="nearest-exact")`` (plain ``"nearest"`` samples
at the cells' corners and picks other rows).

The generation runs under ``torch.no_grad`` (not ``inference_mode``), so that
``optimize_latents``, which differentiates a guidance loss with respect to the latents, can
run on its results.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from lkgd_torch.models.configs import ControlNet2DConfig, UNet2DConfig, VAE2DConfig
from lkgd_torch.models.controlnet_2d import ControlNet2D
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.models.unet_2d import UNet2DCondition
from lkgd_torch.models.vae_2d import AutoencoderKL
from lkgd_torch.schedulers.cogvideox_ddim import CogVideoXDDIMConfig, CogVideoXDDIMScheduler
from lkgd_torch.utils.device import require_device


def sd_ddim_config(num_train_timesteps: int = 1000) -> CogVideoXDDIMConfig:
    """Standard SD DDIM (epsilon, scaled-linear betas, no SNR tricks)."""
    return CogVideoXDDIMConfig(num_train_timesteps=num_train_timesteps,
                               snr_shift_scale=1.0, rescale_betas_zero_snr=False,
                               timestep_spacing="leading", prediction_type="epsilon")


@dataclasses.dataclass(frozen=True)
class SD2DPipelineConfig:
    height: int = 512
    width: int = 512
    num_inference_steps: int = 50
    guidance_scale: float = 7.5


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), nearest at half-pixel centres (``jax.image.resize``
    "nearest")."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


class _SD2DPipeline:
    """The UNet and VAE of a 2D pipeline on ``device`` (the card unless another is named;
    with no card and no explicit ``"cpu"`` the constructor raises) in ``dtype``, their
    weights uninitialised: fill them with ``init_params(generator)`` or
    ``load_state_dict``."""

    def __init__(self, config: SD2DPipelineConfig, unet_config: UNet2DConfig,
                 vae_config: VAE2DConfig, dtype: torch.dtype, device):
        self.config = config
        self.dtype = dtype
        self.device = require_device(device)
        self.unet = materialize(lambda: UNet2DCondition(unet_config), self.device, dtype)
        self.vae = materialize(lambda: AutoencoderKL(vae_config), self.device, dtype)
        for model in (self.unet, self.vae):
            model.eval().requires_grad_(False)
        self.scheduler = CogVideoXDDIMScheduler(sd_ddim_config())
        self.schedule = self.scheduler.set_timesteps(config.num_inference_steps)
        self.vae_scale = 2 ** (len(vae_config.block_out_channels) - 1)
        self.vae_scaling = vae_config.scaling_factor
        self.latent_hw = (config.height // self.vae_scale, config.width // self.vae_scale)

    @property
    def models(self) -> tuple:
        return self.unet, self.vae

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights at the configured shapes, drawn from ``generator`` only."""
        for model in self.models:
            init_params(model, generator)

    def _on(self, x, dtype=torch.float32) -> Optional[torch.Tensor]:
        return None if x is None else torch.as_tensor(x, device=self.device).to(dtype)

    def _noise(self, shape, generator, initial_noise) -> torch.Tensor:
        if initial_noise is not None:
            return self._on(initial_noise)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return torch.randn(shape, generator=generator, device=self.device)

    def _prompts(self, prompt_embeds, negative_prompt_embeds):
        prompt = self._on(prompt_embeds)
        negative = (torch.zeros_like(prompt) if negative_prompt_embeds is None
                    else self._on(negative_prompt_embeds))
        return prompt, negative

    def _cfg(self, eps: torch.Tensor) -> torch.Tensor:
        uncond, cond = eps.float().chunk(2)
        return uncond + self.config.guidance_scale * (cond - uncond)

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """[-1, 1] images (B, H, W, 3) -> scaled latents (B, h, w, 4) fp32 (the mode)."""
        return self.vae.encode_mode(image.to(self.dtype)).float() * self.vae_scaling

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> [0, 1] images (B, H, W, 3) fp32."""
        img = self.vae.decode((latents / self.vae_scaling).to(self.dtype))
        return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)


class StableDiffusionInpaintPipeline(_SD2DPipeline):
    """Masked inpainting with the 9-channel UNet (latents, mask, masked-image latents), with
    ControlNet-2D residuals when ``controlnet_config`` is given."""

    def __init__(self, config: SD2DPipelineConfig = SD2DPipelineConfig(),
                 unet_config: UNet2DConfig = UNet2DConfig(in_channels=9),
                 vae_config: VAE2DConfig = VAE2DConfig(),
                 controlnet_config: Optional[ControlNet2DConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(config, unet_config, vae_config, dtype, device)
        self.controlnet = None
        if controlnet_config is not None:
            self.controlnet = materialize(lambda: ControlNet2D(controlnet_config), self.device,
                                          dtype)
            self.controlnet.eval().requires_grad_(False)

    @property
    def models(self) -> tuple:
        return super().models + ((self.controlnet,) if self.controlnet is not None else ())

    def _unet_eps(self, latents, mask_lat, masked_lat, t_rows, ehs, control=None):
        rows = torch.cat([latents] * 2)
        model_in = torch.cat([rows.to(self.dtype), torch.cat([mask_lat] * 2).to(self.dtype),
                              torch.cat([masked_lat] * 2).to(self.dtype)], dim=-1)
        kwargs = {}
        if self.controlnet is not None and control is not None:
            down, mid = self.controlnet(rows.to(self.dtype), t_rows, ehs, control)
            kwargs = dict(down_block_additional_residuals=down,
                          mid_block_additional_residual=mid)
        return self._cfg(self.unet(model_in, t_rows, ehs, **kwargs))

    @torch.no_grad()
    def denoise(self, prompt_embeds, image, mask, negative_prompt_embeds=None,
                generator: Optional[torch.Generator] = None, control=None,
                initial_noise=None) -> torch.Tensor:
        """``image`` [0, 1] (B, H, W, 3), ``mask`` (B, H, W, 1) with 1 = repaint, ``control``
        (B, H, W, C) for the ControlNet -> the denoised latents (B, h, w, 4) fp32."""
        prompt, negative = self._prompts(prompt_embeds, negative_prompt_embeds)
        image, mask = self._on(image), self._on(mask)
        b = image.shape[0]
        h, w = self.latent_hw
        masked = (image * 2.0 - 1.0) * (1.0 - mask)
        masked_lat = self.encode(masked)
        mask_lat = resize_nearest(mask, h, w)
        ehs = torch.cat([negative, prompt]).to(self.dtype)
        if control is not None:
            control = torch.cat([self._on(control)] * 2).to(self.dtype)
        latents = self._noise((b, h, w, 4), generator, initial_noise)
        for i in range(self.schedule.num_steps):
            t_rows = torch.full((2 * b,), float(self.schedule.timesteps[i]), device=self.device)
            eps = self._unet_eps(latents, mask_lat, masked_lat, t_rows, ehs, control)
            latents, _ = self.scheduler.step(self.schedule, eps, i, latents)
        return latents

    def __call__(self, prompt_embeds, image, mask, negative_prompt_embeds=None,
                 generator: Optional[torch.Generator] = None, control=None,
                 initial_noise=None) -> torch.Tensor:
        """[0, 1] images (B, H, W, 3) fp32."""
        return self.decode(self.denoise(prompt_embeds, image, mask, negative_prompt_embeds,
                                        generator, control, initial_noise))

    def optimize_latents(self, latents: torch.Tensor,
                         guidance_fn: Callable[[torch.Tensor], torch.Tensor],
                         guidance_lr: float = 0.05, num_optimizer_steps: int = 5,
                         reg_weight: float = 1.0) -> torch.Tensor:
        """Test-time latent optimisation: ``num_optimizer_steps`` of SGD on the latents
        against ``guidance_fn`` plus an L2 anchor to the original latents (weight
        ``reg_weight``). Gradients are on whatever mode the caller is in."""
        with torch.inference_mode(False), torch.enable_grad():
            latents0 = latents.detach().clone()
            z = latents0
            for _ in range(num_optimizer_steps):
                z = z.detach().requires_grad_()
                loss = guidance_fn(z) + reg_weight * torch.mean((z - latents0) ** 2)
                (g,) = torch.autograd.grad(loss, z)
                z = z - guidance_lr * g
        return z.detach()


class StableDiffusionJointControlPipeline(_SD2DPipeline):
    """Joint image+modality generation by latent clamping. Stream rows are interleaved
    ``[x0, y0, x1, y1, ...]`` and CFG-doubled to ``[uncond | cond]``; the condition stream
    (x with ``cond_x``, else y) is reset to the clean condition latents before every step
    and runs at timestep 0; with ``spatial_mask`` only the masked region is reset. The
    streams couple through the UNet's joint attention when its config has one (the
    default config has none: then only the clamping couples them)."""

    def __init__(self, config: SD2DPipelineConfig = SD2DPipelineConfig(),
                 unet_config: UNet2DConfig = UNet2DConfig(in_channels=4),
                 vae_config: VAE2DConfig = VAE2DConfig(), cond_x: bool = True,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(config, unet_config, vae_config, dtype, device)
        self.cond_x = cond_x

    @torch.no_grad()
    def denoise(self, prompt_embeds, condition_image, negative_prompt_embeds=None,
                generator: Optional[torch.Generator] = None, spatial_mask=None,
                initial_noise=None) -> torch.Tensor:
        """``condition_image`` [0, 1] (B, H, W, 3), one per pair; ``prompt_embeds`` one per
        pair -> the latents of both streams (2B, h, w, 4), interleaved, fp32."""
        prompt, negative = self._prompts(prompt_embeds, negative_prompt_embeds)
        condition_image = self._on(condition_image)
        b = condition_image.shape[0]
        h, w = self.latent_hw
        cond_rows = self.encode(condition_image * 2.0 - 1.0).repeat_interleave(2, dim=0)
        latents = self._noise((2 * b, h, w, 4), generator, initial_noise)
        clamp = torch.tensor([self.cond_x, not self.cond_x], device=self.device).repeat(b)
        region = clamp[:, None, None, None]
        if spatial_mask is not None:
            smask = resize_nearest(self._on(spatial_mask), h, w).repeat_interleave(2, dim=0)
            region = (region * smask) != 0
        ehs = torch.cat([negative.repeat_interleave(2, dim=0),
                         prompt.repeat_interleave(2, dim=0)]).to(self.dtype)
        for i in range(self.schedule.num_steps):
            latents = torch.where(region, cond_rows, latents)
            t = float(self.schedule.timesteps[i])
            t_rows = torch.where(clamp, 0.0, t)
            eps = self._cfg(self.unet(torch.cat([latents] * 2).to(self.dtype),
                                      torch.cat([t_rows] * 2), ehs))
            latents, _ = self.scheduler.step(self.schedule, eps, i, latents)
        return torch.where(clamp[:, None, None, None], cond_rows, latents)

    def __call__(self, prompt_embeds, condition_image, negative_prompt_embeds=None,
                 generator: Optional[torch.Generator] = None, spatial_mask=None,
                 initial_noise=None) -> torch.Tensor:
        return self.decode(self.denoise(prompt_embeds, condition_image, negative_prompt_embeds,
                                        generator, spatial_mask, initial_noise))


class StableDiffusionConditionPipeline(_SD2DPipeline):
    """Text-to-image with an image-space condition through the UNet's
    ``ConditioningEmbedding`` (``unet_config.cond_embedding_channels``); the uncond rows
    see a zero condition. Without ``cond_image`` it is plain text-to-image."""

    def __init__(self, config: SD2DPipelineConfig = SD2DPipelineConfig(),
                 unet_config: UNet2DConfig = UNet2DConfig(in_channels=4,
                                                          cond_embedding_channels=3),
                 vae_config: VAE2DConfig = VAE2DConfig(),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(config, unet_config, vae_config, dtype, device)

    @torch.no_grad()
    def denoise(self, prompt_embeds, cond_image=None, negative_prompt_embeds=None,
                generator: Optional[torch.Generator] = None,
                initial_noise=None) -> torch.Tensor:
        prompt, negative = self._prompts(prompt_embeds, negative_prompt_embeds)
        b = prompt.shape[0]
        h, w = self.latent_hw
        ehs = torch.cat([negative, prompt]).to(self.dtype)
        kwargs = {}
        if cond_image is not None:
            cond = self._on(cond_image, self.dtype)
            kwargs["cond_image"] = torch.cat([torch.zeros_like(cond), cond])
        latents = self._noise((b, h, w, 4), generator, initial_noise)
        for i in range(self.schedule.num_steps):
            t_rows = torch.full((2 * b,), float(self.schedule.timesteps[i]), device=self.device)
            eps = self._cfg(self.unet(torch.cat([latents] * 2).to(self.dtype), t_rows, ehs,
                                      **kwargs))
            latents, _ = self.scheduler.step(self.schedule, eps, i, latents)
        return latents

    def __call__(self, prompt_embeds, cond_image=None, negative_prompt_embeds=None,
                 generator: Optional[torch.Generator] = None,
                 initial_noise=None) -> torch.Tensor:
        return self.decode(self.denoise(prompt_embeds, cond_image, negative_prompt_embeds,
                                        generator, initial_noise))
