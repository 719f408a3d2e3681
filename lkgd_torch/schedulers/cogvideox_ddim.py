"""CogVideoX DDIM scheduler (counterpart of ``lkgd_tpu/schedulers/cogvideox_ddim.py``).

diffusers' ``CogVideoXDDIMScheduler`` as CogVideoX trains and samples with it:
v-prediction, scaled-linear betas, the SNR shift ``acp / (s + (1 - s) acp)`` with s = 3,
the zero-terminal-SNR rescale and trailing timestep spacing. The schedule is computed on
the host in numpy as the JAX package computes it (float64, kept as float32), and a step's
scalar coefficients in float32 numpy, the JAX step's arithmetic; ``step`` is a pure
function of ``(schedule, step index, tensors)`` and the loop around it a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CogVideoXDDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    snr_shift_scale: float = 3.0
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    prediction_type: str = "v_prediction"
    set_alpha_to_one: bool = True


class DDIMSchedule(NamedTuple):
    timesteps: np.ndarray  # (N,) int64, descending
    alphas_cumprod_t: np.ndarray  # (N,) float32, acp at each timestep
    alphas_cumprod_prev: np.ndarray  # (N,) float32, acp at the next (lower-noise) timestep

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def _f32(x) -> np.float32:
    return np.float32(x)


class CogVideoXDDIMScheduler:
    def __init__(self, config: CogVideoXDDIMConfig = CogVideoXDDIMConfig()):
        self.config = config
        betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5,
                            config.num_train_timesteps, dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        s = config.snr_shift_scale
        acp = acp / (s + (1.0 - s) * acp)
        if config.rescale_betas_zero_snr:
            sqrt_acp = np.sqrt(acp)
            a0, at = sqrt_acp[0], sqrt_acp[-1]
            acp = ((sqrt_acp - at) * (a0 / (a0 - at))) ** 2
        self.alphas_cumprod = acp  # (T,) float64
        self.final_alpha_cumprod = 1.0 if config.set_alpha_to_one else float(acp[0])

    def set_timesteps(self, num_inference_steps: int) -> DDIMSchedule:
        cfg = self.config
        if cfg.timestep_spacing == "trailing":
            ratio = cfg.num_train_timesteps / num_inference_steps
            ts = np.arange(cfg.num_train_timesteps, 0, -ratio).round().astype(np.int64) - 1
        elif cfg.timestep_spacing == "linspace":
            ts = np.linspace(0, cfg.num_train_timesteps - 1,
                             num_inference_steps).round()[::-1].astype(np.int64)
        else:  # leading
            ratio = cfg.num_train_timesteps // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1].astype(np.int64)
        prev_ts = ts - cfg.num_train_timesteps // num_inference_steps
        acp_prev = np.where(prev_ts >= 0, self.alphas_cumprod[np.maximum(prev_ts, 0)],
                            self.final_alpha_cumprod)
        return DDIMSchedule(ts, self.alphas_cumprod[ts].astype(np.float32),
                            acp_prev.astype(np.float32))

    def _x0(self, a_t: np.float32, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        if self.config.prediction_type == "v_prediction":
            return float(np.sqrt(a_t)) * x - float(np.sqrt(_f32(1) - a_t)) * out
        if self.config.prediction_type == "epsilon":
            return (x - float(np.sqrt(_f32(1) - a_t)) * out) / float(np.sqrt(a_t))
        raise ValueError(self.config.prediction_type)

    def step(self, schedule: DDIMSchedule, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic DDIM update (eta = 0). Returns (prev_sample, pred_x0)."""
        a_t = schedule.alphas_cumprod_t[step_index]
        a_prev = schedule.alphas_cumprod_prev[step_index]
        x, v = sample.float(), model_output.float()
        x0 = self._x0(a_t, x, v)
        if self.config.prediction_type == "v_prediction":
            eps = float(np.sqrt(a_t)) * v + float(np.sqrt(_f32(1) - a_t)) * x
        else:
            eps = v
        prev = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(_f32(1) - a_prev)) * eps
        return prev.to(sample.dtype), x0.to(sample.dtype)

    def _acp(self, timesteps, like: torch.Tensor) -> torch.Tensor:
        table = torch.as_tensor(self.alphas_cumprod.astype(np.float32), device=like.device)
        acp = table[torch.as_tensor(timesteps, device=like.device)]
        return acp.reshape(acp.shape + (1,) * (like.dim() - acp.dim()))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        acp = self._acp(timesteps, original)
        return torch.sqrt(acp) * original + torch.sqrt(1.0 - acp) * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        """The v-prediction target."""
        acp = self._acp(timesteps, sample)
        return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * sample
