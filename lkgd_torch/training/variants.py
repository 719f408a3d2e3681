"""In-training validation sampling (counterpart of ``make_validation_sampler`` in
``lkgd_tpu/training/variants.py``): every N steps, render clips through the full pipeline
with the weights being trained and write them as GIFs.

The pipeline runs the trainer's own modules (``StableVideoDiffusionPipeline(models=...)``),
so it sees the current weights with nothing copied; with an EMA in the train state, the
trained parameters point at the EMA tensors while the clips render and back after.
The rest of the JAX module (``make_controlnet_train_step``, ``reverse_time_batch``,
``consecutive_clip_batches``) comes with ControlNet and flow training.
"""

from __future__ import annotations

import contextlib
import os
from typing import Sequence

import numpy as np
import torch

from lkgd_torch.training.train_state import TrainState


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
