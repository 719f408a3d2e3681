"""The SD 2D train step (counterpart of ``lkgd_tpu/training/sd2d.py``): the loss of the 2D
trainers in one function.

* epsilon-prediction DDPM MSE in fp32 with optional min-SNR weighting (``snr_gamma``);
* joint x/y batches of halves ``[x*, y*]`` (``joint_streams``) whose two halves share their
  timesteps unless ``no_timestep_align``;
* prompt dropout to zero embeddings for CFG;
* ``extra_channels`` joined to the noisy latents (the inpaint UNet's mask and masked
  latents) and ``cond_image`` for the UNet's conditioning encoder;

then the masked AdamW of ``training/train_state.py`` over the trainable parameters
(``build_sd2d_training`` builds the UNet, its trained set and the step on the card). The
timesteps, noise and dropout flags may be given (``timesteps=``, ``noise=``, ``drop=``) in
place of draws, as the parity tests give JAX's (``jax.random.split(rng, 3)``: ``randint``,
``normal``, ``uniform``).

The rows of a joint batch are halves ``[x*, y*]``, the layout that the UNet's block-wise
stream masks (``stream_gate``, ``_partner_streams``) pair row for row at any number of
pairs (x_i with y_i).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from lkgd_torch.models.configs import UNet2DConfig
from lkgd_torch.models.layers import init_params, materialize
from lkgd_torch.models.unet_2d import UNet2DCondition
from lkgd_torch.pipelines.sd2d import sd_ddim_config
from lkgd_torch.schedulers.cogvideox_ddim import CogVideoXDDIMScheduler
from lkgd_torch.training.train_state import (TrainState, init_train_state, make_optimizer,
                                             trainable_trans)
from lkgd_torch.utils.device import require_device


@dataclasses.dataclass(frozen=True)
class SD2DTrainConfig:
    snr_gamma: Optional[float] = None  # min-SNR weighting (5.0 in the reference launchers)
    prompt_dropout_prob: float = 0.1
    joint_streams: bool = False  # batch = [x*, y*] halves
    no_timestep_align: bool = False  # independent timesteps per half
    num_train_timesteps: int = 1000


def sd2d_loss(unet: nn.Module, batch: dict, scheduler: CogVideoXDDIMScheduler,
              config: SD2DTrainConfig = SD2DTrainConfig(),
              generator: Optional[torch.Generator] = None,
              timesteps: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
              drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The loss of one batch: ``latents`` (B, H, W, 4) scaled, ``prompt_embeds`` (B, L, D),
    optional ``extra_channels`` (B, H, W, C) and ``cond_image``. ``timesteps`` (B,)
    integers, ``noise`` (the latents' shape) and ``drop`` (B,) booleans (the rows whose
    prompt is dropped): given values in place of draws from ``generator``, in that order."""
    latents = batch["latents"].float()
    b = latents.shape[0]
    device = latents.device
    n_t = config.num_train_timesteps
    if timesteps is None:
        if config.joint_streams and not config.no_timestep_align:
            t_half = torch.randint(0, n_t, (b // 2,), generator=generator, device=device)
            timesteps = torch.cat([t_half, t_half])
        else:
            timesteps = torch.randint(0, n_t, (b,), generator=generator, device=device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=device)
    timesteps, noise = timesteps.long().to(device), noise.float().to(device)
    noisy = scheduler.add_noise(latents, noise, timesteps)

    ehs = batch["prompt_embeds"]
    if config.prompt_dropout_prob:
        if drop is None:
            u = torch.rand((b,), generator=generator, device=device)
            drop = u < config.prompt_dropout_prob
        ehs = torch.where(drop.to(device)[:, None, None], torch.zeros_like(ehs), ehs)

    model_in = noisy
    if batch.get("extra_channels") is not None:
        model_in = torch.cat([model_in, batch["extra_channels"].to(model_in.dtype)], dim=-1)
    pred = unet(model_in, timesteps.float(), ehs, cond_image=batch.get("cond_image"))

    err = (pred.float() - noise) ** 2
    if config.snr_gamma is not None:
        acp = torch.as_tensor(scheduler.alphas_cumprod.astype(np.float32), device=device)
        a = acp[timesteps]
        snr = a / torch.clamp(1.0 - a, min=1e-8)
        weight = torch.clamp(snr, max=config.snr_gamma) / torch.clamp(snr, min=1e-8)
        err = err * weight[:, None, None, None]
    return err.mean()


def make_sd2d_train_step(unet: nn.Module, optimizer,
                         scheduler: Optional[CogVideoXDDIMScheduler] = None,
                         config: SD2DTrainConfig = SD2DTrainConfig()):
    """``train_step(state, batch, generator=None, *, timesteps=None, noise=None, drop=None)
    -> (state, loss)``: one step of ``optimizer`` (a ``MaskedAdamW`` bound to ``unet``, the
    train state's module) on ``sd2d_loss``; the state is updated in place and returned, and
    ``loss`` is a 0-d device tensor."""
    sched = scheduler or CogVideoXDDIMScheduler(sd_ddim_config(config.num_train_timesteps))

    def train_step(state, batch: dict, generator: Optional[torch.Generator] = None, **inject):
        loss = sd2d_loss(unet, batch, sched, config, generator, **inject)
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def build_sd2d_training(unet_config: UNet2DConfig, config: SD2DTrainConfig = SD2DTrainConfig(),
                        learning_rate: float = 1e-4,
                        trainable_predicate: Callable[[str], bool] = trainable_trans,
                        dtype: torch.dtype = torch.bfloat16, device="cuda", seed: int = 0
                        ) -> Tuple[TrainState, Callable]:
    """The UNet of ``unet_config`` on ``device`` (the card unless another is named; with no
    card and no explicit ``"cpu"`` this raises), random weights from ``seed``: the frozen
    ones in ``dtype``, the trainables (``trainable_predicate``: LoRA factors and the joint
    branch by default) in fp32, cast to the compute dtype at use; masked AdamW over the
    trainables. Returns ``(state, train_step)``."""
    device = require_device(device)
    unet = materialize(lambda: UNet2DCondition(unet_config), device, dtype,
                       fp32=trainable_predicate)
    init_params(unet, torch.Generator(device=device).manual_seed(seed))
    optimizer = make_optimizer(learning_rate, trainable_predicate=trainable_predicate)
    state = init_train_state(unet, optimizer)
    return state, make_sd2d_train_step(unet, optimizer, config=config)
