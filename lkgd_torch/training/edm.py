"""EDM training-time noise math, Karras et al. 2022 preconditioning (counterpart of
``lkgd_tpu/training/edm.py``).

Randomness comes from a ``torch.Generator`` or from a uniform tensor passed in (``u=``),
the hook the parity tests use, since torch and JAX generators never agree. Constants of
the LKGD fine-tune: sigma in [0.002, 700], image_d 64, noise_d 32..64, sigma_data 0.5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    sigma_data: float = 0.5
    image_d: int = 64
    noise_d_low: int = 32
    noise_d_high: int = 64


def stratified_uniform(shape: Tuple[int, ...], generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """Stratified U[0, 1) samples: ``(i + u_i) / n`` over the last axis of length n, with
    ``u`` uniform on [0, 1) drawn from ``generator`` unless given (the JAX function with
    its default single group)."""
    if u is None:
        u = torch.rand(shape, generator=generator, device=device)
    n = shape[-1]
    return (torch.arange(n, dtype=torch.float32, device=u.device) + u.float()) / n


def rand_cosine_interpolated(shape: Tuple[int, ...], config: EDMConfig = EDMConfig(),
                             generator: Optional[torch.Generator] = None,
                             u: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """Sigmas from the interpolated cosine logSNR schedule ('simple diffusion'). ``u``:
    the uniform draw before stratification."""

    def logsnr_schedule_cosine(t, logsnr_min, logsnr_max):
        t_min = math.atan(math.exp(-0.5 * logsnr_max))
        t_max = math.atan(math.exp(-0.5 * logsnr_min))
        return -2.0 * torch.log(torch.tan(t_min + t * (t_max - t_min)))

    def shifted(t, noise_d, logsnr_min, logsnr_max):
        shift = 2.0 * math.log(noise_d / config.image_d)
        return logsnr_schedule_cosine(t, logsnr_min - shift, logsnr_max - shift) + shift

    logsnr_min = -2.0 * math.log(config.sigma_min / config.sigma_data)
    logsnr_max = -2.0 * math.log(config.sigma_max / config.sigma_data)
    t = stratified_uniform(shape, generator=generator, u=u, device=device)
    low = shifted(t, config.noise_d_low, logsnr_min, logsnr_max)
    high = shifted(t, config.noise_d_high, logsnr_min, logsnr_max)
    logsnr = low + t * (high - low)
    return torch.exp(-logsnr / 2.0) * config.sigma_data


def timesteps_from_sigmas(sigmas: torch.Tensor) -> torch.Tensor:
    """Continuous v-prediction timesteps, 0.25 * log(sigma)."""
    return 0.25 * torch.log(sigmas)


def _per_sample(sigmas: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return sigmas.reshape(sigmas.shape + (1,) * (like.dim() - sigmas.dim()))


def precondition_inputs(latents: torch.Tensor, noise: torch.Tensor, sigmas: torch.Tensor):
    """(noisy, model input): noisy = x + sigma * eps, input = noisy / sqrt(sigma^2 + 1)."""
    s = _per_sample(sigmas, latents)
    noisy = latents + noise * s
    return noisy, noisy / torch.sqrt(s ** 2 + 1.0)


def denoise_and_weigh(model_pred: torch.Tensor, noisy_latents: torch.Tensor,
                      sigmas: torch.Tensor):
    """EDM v-prediction scalings: (denoised, per-sample weight) with c_out =
    -sigma / sqrt(sigma^2 + 1), c_skip = 1 / (sigma^2 + 1), w = (1 + sigma^2) / sigma^2."""
    s = _per_sample(sigmas, model_pred)
    c_out, c_skip = -s / torch.sqrt(s ** 2 + 1.0), 1.0 / (s ** 2 + 1.0)
    return model_pred * c_out + c_skip * noisy_latents, (1.0 + s ** 2) / s ** 2


def edm_loss(model_pred: torch.Tensor, noisy_latents: torch.Tensor, target: torch.Tensor,
             sigmas: torch.Tensor) -> torch.Tensor:
    """Weighted MSE of the denoised latents, the mean of per-sample means, fp32."""
    denoised, weighing = denoise_and_weigh(model_pred, noisy_latents, sigmas)
    per_elem = weighing.float() * (denoised.float() - target.float()) ** 2
    return per_elem.reshape(target.shape[0], -1).mean(dim=1).mean()
