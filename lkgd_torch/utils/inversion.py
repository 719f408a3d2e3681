"""DDIM inversion and conditioning helpers (counterpart of ``lkgd_tpu/utils/inversion.py``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from lkgd_torch.schedulers.cogvideox_ddim import CogVideoXDDIMScheduler, DDIMSchedule


def ddim_inversion(model_eps: Callable[[torch.Tensor, int], torch.Tensor],
                   scheduler: CogVideoXDDIMScheduler, schedule: DDIMSchedule,
                   latents: torch.Tensor) -> torch.Tensor:
    """Invert clean latents to noise by running DDIM forward:
    x_{t+1} = sqrt(a_{t+1}) x0_pred + sqrt(1 - a_{t+1}) eps, over the reversed schedule
    (ascending timesteps, ``a_prev`` starting at 1). ``model_eps(latents, t)`` returns the
    epsilon prediction at the integer timestep ``t``; the latents stay fp32 and eps is cast
    to fp32. The step's coefficients are fp32 scalars, as the JAX step computes them."""
    del scheduler  # the schedule carries all the step reads, as in the JAX function
    acp_t = schedule.alphas_cumprod_t[::-1].astype(np.float32)
    acp_prev = np.concatenate([np.ones(1, np.float32), acp_t[:-1]])
    ts = schedule.timesteps[::-1]
    one = np.float32(1.0)
    lat = latents.float()
    for i in range(schedule.num_steps):
        eps = model_eps(lat, int(ts[i])).float()
        a_prev, a_t = acp_prev[i], acp_t[i]
        x0 = (lat - float(np.sqrt(one - a_prev)) * eps) / float(np.sqrt(a_prev))
        lat = float(np.sqrt(a_t)) * x0 + float(np.sqrt(one - a_t)) * eps
    return lat


def tensor_to_vae_latent(vae_apply: Callable, frames: torch.Tensor,
                         scaling_factor: float = 0.18215) -> torch.Tensor:
    """(B, T, H, W, 3) [-1, 1] -> scaled latents (B, T, ...): ``vae_apply`` on the B*T
    frames as one batch."""
    b, t = frames.shape[:2]
    lat = vae_apply(frames.reshape((b * t,) + tuple(frames.shape[2:])))
    return lat.reshape((b, t) + tuple(lat.shape[1:])) * scaling_factor


def get_add_time_ids(fps: float, motion_bucket_id: float, noise_aug_strength: float,
                     batch_size: int) -> torch.Tensor:
    """(B, 3) fp32 added-time-id rows."""
    row = torch.tensor([[fps, motion_bucket_id, noise_aug_strength]], dtype=torch.float32)
    return row.repeat(batch_size, 1)


def parse_checkpoint_behavior_flags(path: str) -> dict:
    """The joint-attention behaviour the reference encodes in checkpoint directory names
    ('flip' / 'notemporal' / 'nospatial'), for reference-checkpoint compatibility."""
    flip = "noflip" not in path and "flip" in path
    temporal = "notemporal" not in path and "temporal" in path
    spatial = "nospatial" not in path
    return {"flip": flip, "temporal": temporal, "spatial": spatial}
