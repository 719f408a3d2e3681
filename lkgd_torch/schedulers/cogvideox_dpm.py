"""CogVideoX DPM-Solver++ scheduler, SDE 2M (counterpart of
``lkgd_tpu/schedulers/cogvideox_dpm.py``), on the DDIM scheduler's snr-shifted
zero-terminal-SNR alphas, in log-SNR time lambda = log(sqrt(acp / (1 - acp))). One step
from t to s with h = lambda_s - lambda_t:

    first order:   x_s = (sigma_s / sigma_t) e^{-h} x_t + a_s (1 - e^{-2h}) x0
                         + sigma_s sqrt(1 - e^{-2h}) z
    second order:  x0 -> (1 + 1/(2r)) x0 - 1/(2r) x0_old,  r = h_last / h

with a = sqrt(acp), sigma = sqrt(1 - acp), z ~ N(0, I). The first step (no history), a
step whose caller has no history (``have_history=False``: V2V starts mid-schedule) and the
final step (acp_prev = 1, h = inf: x_s = x0) run first order. The scalars are float32
numpy, the JAX step's arithmetic; the noise is an explicit argument.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lkgd_torch.schedulers.cogvideox_ddim import CogVideoXDDIMConfig, CogVideoXDDIMScheduler

CogVideoXDPMConfig = CogVideoXDDIMConfig  # the same beta / acp schedule family


class DPMSchedule(NamedTuple):
    timesteps: np.ndarray  # (N,) int64, descending
    alphas_cumprod_t: np.ndarray  # (N,) float32
    alphas_cumprod_prev: np.ndarray  # (N,) float32
    second_order_ok: np.ndarray  # (N,) bool: a step with history and prev timestep >= 0

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def _lamb(acp: np.float32) -> np.float32:
    with np.errstate(divide="ignore"):
        return np.float32(0.5) * np.log(acp / (np.float32(1) - acp))


class CogVideoXDPMScheduler(CogVideoXDDIMScheduler):
    def set_timesteps(self, num_inference_steps: int) -> DPMSchedule:
        base = super().set_timesteps(num_inference_steps)
        prev_ts = base.timesteps - self.config.num_train_timesteps // num_inference_steps
        ok = (np.arange(len(base.timesteps)) > 0) & (prev_ts >= 0)
        return DPMSchedule(*base, ok)

    def step(self, schedule: DPMSchedule, model_output: torch.Tensor,
             old_x0: Optional[torch.Tensor], step_index: int, sample: torch.Tensor,
             noise: Optional[torch.Tensor] = None,
             have_history: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SDE-DPM-Solver++(2M) update; ``old_x0`` is the previous step's returned x0
        (unread where the step runs first order). ``noise=None`` takes the mean update.
        Returns (prev_sample, x0)."""
        one = np.float32(1)
        a_t = schedule.alphas_cumprod_t[step_index]
        a_prev = schedule.alphas_cumprod_prev[step_index]
        x = sample.float()
        x0 = self._x0(a_t, x, model_output.float())

        h = _lamb(np.maximum(a_prev, np.finfo(np.float32).tiny)) - _lamb(a_t)  # final: inf
        em2h = np.exp(np.float32(-2) * h)
        mult_x = np.sqrt((one - a_prev) / (one - a_t)) * np.exp(-h)
        mult_x0 = np.sqrt(a_prev) * (one - em2h)
        mult_noise = np.sqrt(one - a_prev) * np.sqrt(one - em2h)

        denoised = x0
        if schedule.second_order_ok[step_index] and have_history:
            a_back = schedule.alphas_cumprod_t[max(step_index - 1, 0)]
            r = (_lamb(a_t) - _lamb(a_back)) / h
            denoised = float(one + one / (np.float32(2) * r)) * x0 \
                - old_x0.float() / float(np.float32(2) * r)

        prev = float(mult_x) * x + float(mult_x0) * denoised
        if noise is not None:
            prev = prev + float(mult_noise) * noise.float()
        return prev.to(sample.dtype), x0.to(sample.dtype)
