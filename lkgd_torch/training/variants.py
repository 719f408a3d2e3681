"""Training-step builders beside the SVD step (counterpart of
``lkgd_tpu/training/variants.py``):

* ``make_controlnet_train_step``: the ControlNet-SDV branch trained against a frozen UNet,
  EDM loss with no conditioning dropout, EMA after every step (the reference's
  ``train_svd_controlnet.py``; its control is the clip's flow as images, ``:1311``);
* ``reverse_time_batch`` and ``consecutive_clip_batches``: the batch transforms of the
  reverse-time and consecutive-clip trainers;
* in-training validation sampling: every N steps, render clips through the full pipeline
  with the weights being trained and write them as GIFs.

The validation pipeline runs the trainer's own modules (``StableVideoDiffusionPipeline(
models=...)``), so it sees the current weights with nothing copied; with an EMA in the
train state, the trained parameters point at the EMA tensors while the clips render and
back after.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from lkgd_torch.training import edm
from lkgd_torch.training.train_state import SVDTrainConfig, TrainState


def controlnet_loss(controlnet: nn.Module, unet: nn.Module, batch: dict, config: SVDTrainConfig,
                    generator: Optional[torch.Generator] = None,
                    sigmas: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The EDM loss of one batch through the ControlNet and the UNet it steers: the
    ControlNet sees the UNet's own input (noised latents and the repeated first-frame
    latents) and the image-space ``control`` (B, T, H, W, C), and its residuals go into the
    UNet's skips and mid block. No conditioning dropout; the added time ids are
    ``[fps, motion_bucket_id, train_noise_aug]``. ``sigmas`` (B,) and ``noise`` (the
    latents' shape, standard normal): given values in place of draws from ``generator``
    (sigmas first, then the noise). The ControlNet computes in the UNet's dtype: trained
    fp32 parameters beside a bf16 UNet run under ``torch.autocast``, as the JAX module
    keeps fp32 parameters and computes at ``dtype``."""
    latents = batch["latents"].float()
    bsz, num_frames = latents.shape[:2]
    device = latents.device
    if sigmas is None:
        sigmas = edm.rand_cosine_interpolated((bsz,), config.edm, generator=generator,
                                              device=device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=device)
    sigmas = sigmas.float()
    noisy, inp = edm.precondition_inputs(latents, noise.float(), sigmas)
    timesteps = edm.timesteps_from_sigmas(sigmas)

    ehs, cond_latents = batch["image_embeddings"], batch["cond_latents"]
    cond = cond_latents[:, None].expand(-1, num_frames, -1, -1, -1)
    model_in = torch.cat([inp.to(cond.dtype), cond], dim=-1)
    added_time_ids = torch.stack([
        torch.full((bsz,), float(v), dtype=torch.float32, device=device)
        for v in (config.fps, config.motion_bucket_id, config.train_noise_aug)], dim=1)
    compute_dtype = next(unet.parameters()).dtype
    autocast = (contextlib.nullcontext()
                if next(controlnet.parameters()).dtype == compute_dtype
                else torch.autocast(device.type, dtype=compute_dtype))
    with autocast:
        down, mid = controlnet(model_in, timesteps, ehs, added_time_ids,
                               controlnet_cond=batch["control"])
    pred = unet(model_in, timesteps, ehs, added_time_ids,
                down_block_additional_residuals=down, mid_block_additional_residual=mid)
    return edm.edm_loss(pred.float(), noisy, latents, sigmas)


def make_controlnet_train_step(unet: nn.Module, config: SVDTrainConfig = SVDTrainConfig()):
    """``train_step(state, batch, generator=None, *, sigmas=None, noise=None) -> (state,
    loss)``: one optimizer step of the ControlNet ``state.unet`` (the train state's module)
    against ``unet``, which is frozen here (``requires_grad_(False)``): gradients pass
    through it from the residuals on, and it never changes. ``batch``: ``latents``,
    ``cond_latents``, ``image_embeddings`` as the SVD step takes them, and ``control``
    (B, T, H, W, C_cond) image-space control frames. With an EMA in the state (the
    reference's ``EMAModel`` of the ControlNet), every parameter's EMA becomes
    ``e * 0.9999 + p * 0.0001`` after the update."""
    unet.requires_grad_(False)

    def train_step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
                   **inject):
        loss = controlnet_loss(state.unet, unet, batch, config, generator, **inject)
        loss.backward()
        state.optimizer.step()
        if state.ema_params is not None:
            with torch.no_grad():
                for name, p in state.trainables.items():
                    state.ema_params[name].mul_(0.9999).add_(p, alpha=0.0001)
        state.step += 1
        return state, loss.detach()

    return train_step


def reverse_time_batch(batch: dict) -> dict:
    """The reverse-time trainer's batch: the frame axis of ``latents`` flipped (the
    conditioning frame stays what the batch gives)."""
    out = dict(batch)
    out["latents"] = batch["latents"].flip(1)
    return out


def consecutive_clip_batches(latents: torch.Tensor, clip_len: int) -> torch.Tensor:
    """A long latent clip (B, >= 2 * clip_len, ...) as two consecutive windows for
    joint-stream training, stream-major: (2B, clip_len, ...), the first windows then their
    continuations."""
    return torch.cat([latents[:, :clip_len], latents[:, clip_len:2 * clip_len]], dim=0)


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """The trainables hold the EMA's tensors inside the block (when the state has an EMA),
    their own after it. Only the tensors a parameter points at change: nothing is copied."""
    if state.ema_params is None:
        yield
        return
    own = {name: p.data for name, p in state.trainables.items()}
    try:
        for name, p in state.trainables.items():
            p.data = state.ema_params[name]
        yield
    finally:
        for name, p in state.trainables.items():
            p.data = own[name]


def make_validation_sampler(pipeline, images: Sequence[np.ndarray], out_dir: str,
                            fps: int = 7, seed: int = 0):
    """A trainer ``validation_fn(state, step)``: each of ``images`` (what ``pipeline``
    takes: ``(1, H, W, 3)`` for the base pipeline, a ``(2, H, W, 3)`` [start, end] pair for
    the trans one) rendered with the current weights (the EMA if the state has one) and
    its first clip written to ``out_dir/step{step}_sample{i}.gif``. Clip ``i`` of step
    ``s`` draws its noise from a generator seeded ``seed + 100 * s + i``. The function
    carries the pipeline as ``validate.pipeline``."""
    from lkgd_torch.data.video_io import write_video

    os.makedirs(out_dir, exist_ok=True)

    def validate(state: TrainState, step: int) -> dict:
        with ema_weights(state):
            for i, image in enumerate(images):
                generator = torch.Generator(device=pipeline.device).manual_seed(
                    seed + 100 * step + i)
                frames = pipeline(image, generator=generator)
                write_video(os.path.join(out_dir, f"step{step}_sample{i}.gif"), frames[0],
                            fps=fps)
        return {"num_samples": len(images)}

    validate.pipeline = pipeline
    return validate
