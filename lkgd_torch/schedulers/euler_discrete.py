"""Euler-discrete (EDM) scheduler with Karras sigmas (counterpart of
``lkgd_tpu/schedulers/euler_discrete.py``).

The schedule is computed once on the host in numpy (float64), exactly as the JAX
package does, and held as fp32 tensors; ``scale_model_input`` and ``step`` are pure
functions of ``(schedule, step index, tensors)``. The sampling loop is a Python loop.
``add_noise`` takes integer step indices into the sigmas, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EulerDiscreteConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"  # linear | scaled_linear | squaredcos_cap_v2
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample
    interpolation_type: str = "linear"  # linear | log_linear
    use_karras_sigmas: bool = False
    sigma_min: Optional[float] = None
    sigma_max: Optional[float] = None
    timestep_spacing: str = "linspace"  # linspace | leading | trailing
    timestep_type: str = "discrete"  # discrete | continuous
    steps_offset: int = 0
    rescale_betas_zero_snr: bool = False

    @classmethod
    def svd(cls) -> "EulerDiscreteConfig":
        """The Stable-Video-Diffusion scheduler config (img2vid / img2vid-xt)."""
        return cls(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
                   beta_schedule="scaled_linear", prediction_type="v_prediction",
                   interpolation_type="linear", use_karras_sigmas=True, sigma_min=0.002,
                   sigma_max=700.0, timestep_spacing="leading", timestep_type="continuous",
                   steps_offset=1)


class Schedule(NamedTuple):
    """Inference schedule: fp32 tensors on one device."""

    sigmas: torch.Tensor  # (num_steps + 1,), final entry 0
    timesteps: torch.Tensor  # (num_steps,)
    init_noise_sigma: float

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def _make_betas(config: EulerDiscreteConfig) -> np.ndarray:
    n = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
    elif config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5, n,
                            dtype=np.float64) ** 2
    elif config.beta_schedule == "squaredcos_cap_v2":
        t1 = np.arange(n, dtype=np.float64) / n
        t2 = (np.arange(n, dtype=np.float64) + 1) / n

        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = np.minimum(1 - alpha_bar(t2) / alpha_bar(t1), 0.999)
    else:
        raise NotImplementedError(f"beta_schedule={config.beta_schedule}")
    if config.rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)
    return betas.astype(np.float64)


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero-terminal-SNR rescale (arXiv 2305.08891 alg. 1)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = alphas_bar_sqrt[0], alphas_bar_sqrt[-1]
    alphas_bar = ((alphas_bar_sqrt - aT) * (a0 / (a0 - aT))) ** 2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def _training_sigmas(config: EulerDiscreteConfig) -> np.ndarray:
    """Ascending per-train-timestep sigmas sqrt((1-abar)/abar)."""
    alphas_cumprod = np.cumprod(1.0 - _make_betas(config))
    if config.rescale_betas_zero_snr:
        alphas_cumprod[-1] = 2**-24
    return np.sqrt((1 - alphas_cumprod) / alphas_cumprod)


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Invert the sigma schedule to fractional train timesteps."""
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma - log_sigmas[:, None]
    low_idx = np.cumsum((dists >= 0), axis=0).argmax(axis=0).clip(max=log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return ((1 - w) * low_idx + w * high_idx).reshape(np.shape(sigma))


def _convert_to_karras(in_sigmas: np.ndarray, num_inference_steps: int,
                       sigma_min: Optional[float], sigma_max: Optional[float]) -> np.ndarray:
    """Karras et al. 2022 noise schedule, rho = 7."""
    sigma_min = sigma_min if sigma_min is not None else float(in_sigmas[-1])
    sigma_max = sigma_max if sigma_max is not None else float(in_sigmas[0])
    rho = 7.0
    ramp = np.linspace(0, 1, num_inference_steps)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


class EulerDiscreteScheduler:
    """Host-side schedule factory + pure step functions::

        sched = EulerDiscreteScheduler(EulerDiscreteConfig.svd())
        schedule = sched.set_timesteps(25, device)
        x = noise * schedule.init_noise_sigma
        for i in range(schedule.num_steps):
            pred = model(sched.scale_model_input(schedule, x, i), schedule.timesteps[i])
            x, _ = sched.step(schedule, pred, i, x)
    """

    def __init__(self, config: EulerDiscreteConfig = EulerDiscreteConfig()):
        self.config = config
        self._train_sigmas = _training_sigmas(config)

    def set_timesteps(self, num_inference_steps: int, device="cpu") -> Schedule:
        cfg = self.config
        n_train = cfg.num_train_timesteps
        if cfg.timestep_spacing == "linspace":
            timesteps = np.linspace(0, n_train - 1, num_inference_steps,
                                    dtype=np.float64)[::-1].copy()
        elif cfg.timestep_spacing == "leading":
            step_ratio = n_train // num_inference_steps
            timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(
                np.float64)
            timesteps += cfg.steps_offset
        elif cfg.timestep_spacing == "trailing":
            step_ratio = n_train / num_inference_steps
            timesteps = np.arange(n_train, 0, -step_ratio).round().astype(np.float64) - 1
        else:
            raise ValueError(f"timestep_spacing={cfg.timestep_spacing}")

        sigmas_full = self._train_sigmas
        log_sigmas = np.log(sigmas_full)
        if cfg.interpolation_type == "linear":
            sigmas = np.interp(timesteps, np.arange(0, len(sigmas_full)), sigmas_full)
        elif cfg.interpolation_type == "log_linear":
            sigmas = np.exp(np.linspace(np.log(sigmas_full[-1]), np.log(sigmas_full[0]),
                                        num_inference_steps + 1))
        else:
            raise ValueError(f"interpolation_type={cfg.interpolation_type}")

        if cfg.use_karras_sigmas:
            sigmas = _convert_to_karras(sigmas, num_inference_steps, cfg.sigma_min,
                                        cfg.sigma_max)
            timesteps = _sigma_to_t(sigmas, log_sigmas)

        if cfg.timestep_type == "continuous" and cfg.prediction_type == "v_prediction":
            ts = 0.25 * np.log(sigmas)
        else:
            ts = timesteps

        max_sigma = float(np.max(sigmas))
        if cfg.timestep_spacing in ("linspace", "trailing"):
            init_noise_sigma = max_sigma
        else:
            init_noise_sigma = (max_sigma**2 + 1) ** 0.5

        return Schedule(
            sigmas=torch.tensor(np.append(sigmas, 0.0), dtype=torch.float32, device=device),
            timesteps=torch.tensor(ts, dtype=torch.float32, device=device),
            # rounded to fp32 as the JAX schedule holds it
            init_noise_sigma=float(np.float32(init_noise_sigma)),
        )

    def scale_model_input(self, schedule: Schedule, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        """x / sqrt(sigma^2 + 1)."""
        sigma = schedule.sigmas[step_index]
        return sample / torch.sqrt(sigma**2 + 1.0)

    def step(self, schedule: Schedule, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, *, s_churn: float = 0.0, s_noise: float = 1.0,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Euler (EDM) update; fp32 inside. Returns ``(prev_sample, pred_original)``.

        With the default ``s_churn=0`` it is the deterministic ODE step every reference
        pipeline uses; ``s_churn > 0`` first raises the sample's noise level by a factor
        ``gamma + 1``, with ``noise`` (standard normals of the sample's shape) given."""
        dtype = model_output.dtype
        sample = sample.float()
        model_output = model_output.float()
        sigma = schedule.sigmas[step_index]
        if s_churn > 0.0:
            if noise is None:
                raise ValueError("s_churn > 0 requires an explicit `noise` array")
            gamma = min(s_churn / (schedule.sigmas.shape[0] - 1), 2**0.5 - 1)
            sigma_hat = sigma * (gamma + 1.0)
            sample = sample + noise.float() * s_noise * torch.sqrt(
                torch.clamp(sigma_hat**2 - sigma**2, min=0.0))
        else:
            sigma_hat = sigma
        pred = self.config.prediction_type
        if pred in ("original_sample", "sample"):
            pred_original = model_output
        elif pred == "epsilon":
            pred_original = sample - sigma_hat * model_output
        elif pred == "v_prediction":
            pred_original = (model_output * (-sigma / torch.sqrt(sigma**2 + 1.0))
                             + sample / (sigma**2 + 1.0))
        else:
            raise ValueError(f"prediction_type={pred}")
        derivative = (sample - pred_original) / sigma_hat
        prev_sample = sample + derivative * (schedule.sigmas[step_index + 1] - sigma_hat)
        return prev_sample.to(dtype), pred_original.to(dtype)

    def add_noise(self, schedule: Schedule, original_samples: torch.Tensor,
                  noise: torch.Tensor, step_indices) -> torch.Tensor:
        """``x + sigma[i] * noise``, each row's sigma broadcast over its trailing dims.
        ``step_indices`` are integer indices into ``schedule.sigmas`` (not timesteps), one
        per leading row."""
        idx = torch.as_tensor(step_indices, dtype=torch.long, device=schedule.sigmas.device)
        sigma = schedule.sigmas[idx].to(original_samples.dtype)
        sigma = sigma.reshape(sigma.shape + (1,) * (original_samples.dim() - sigma.dim()))
        return original_samples + noise * sigma.to(original_samples.device)

    def step_index_for_timestep(self, schedule: Schedule, timestep: float) -> int:
        """The step index of ``timestep`` in the schedule: the *second* match where it
        occurs twice, so that an img2img resume never skips a sigma."""
        ts = schedule.timesteps.cpu().numpy()
        candidates = np.nonzero(ts == timestep)[0]
        if len(candidates) == 0:
            raise ValueError(f"timestep {timestep} not in schedule")
        return int(candidates[1] if len(candidates) > 1 else candidates[0])


def config_from_diffusers_json(path: str) -> EulerDiscreteConfig:
    """A scheduler config from a diffusers ``scheduler_config.json``: its fields that
    ``EulerDiscreteConfig`` has, the others ignored."""
    import json

    with open(path) as f:
        d = json.load(f)
    fields = {f.name for f in dataclasses.fields(EulerDiscreteConfig)}
    return EulerDiscreteConfig(**{k: v for k, v in d.items() if k in fields})
