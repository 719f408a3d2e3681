"""The training loop: checkpoints with rotation and resume, EMA, JSONL metrics mirrored to
an optional tracker (``utils/trackers.py``), validation every ``validation_every`` steps,
and the export of the trained parameters (counterpart of ``lkgd_tpu/training/trainer.py``).

A checkpoint holds the step, the trainable parameters, the optimizer state and the EMA,
written with ``torch.save`` (the card's machine has no orbax). Frozen parameters never
change under the optimizer's mask, so a checkpoint leaves them out: on resume they come
from the weights the model was built with, which must be the same ones. Under data
parallelism every rank runs the loop and only rank 0 of the default process group writes
(metrics, checkpoints, validation).

ZeRO (``zero_shardings``, ``zero_shard_opt_state``; the JAX module's ``:43-99``, whose
``make_zero_train_step`` re-jits the step for its shardings: here the step is unchanged and
the optimizer alone is rebuilt): the Adam moments split over the ``data`` group on their
first axis that divides by its size, in the JAX parameter's layout (a convolution's
(*k, in, out): the rule of ``lkgd_tpu/training/trainer.py:66-70``) mapped to the port's;
the parameters stay
replicated, each rank updating its block and all-gathering the blocks (``MaskedAdamW``).
A library function, as in the JAX package: no CLI flag selects it. The 8-bit moments are
blockwise: ZeRO over them is refused unless every split falls on their blocks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from lkgd_torch.parallel.sequence import shard
from lkgd_torch.parallel.tp import named_owners, flax_dims
from lkgd_torch.training.train_state import MaskedAdamW, TrainState
from lkgd_torch.utils.porting import save_safetensors


def zero_shardings(state: TrainState, size: int) -> Dict[str, Optional[int]]:
    """{trainable parameter name: the dim its moments split on over ``size`` ranks, or None
    (replicated)}: the first axis of the JAX layout whose size is above 1 and divides by
    ``size``, as the port's dim."""
    specs = {}
    for owner, prefix, key, p in named_owners(state.unet):
        name = f"{prefix}.{key}" if prefix else key
        if name not in state.trainables:
            continue
        specs[name] = next((d for d in flax_dims(owner, key, p)
                            if p.shape[d] > 1 and p.shape[d] % size == 0), None)
    return specs


def _check_8bit_blocks(optimizer: MaskedAdamW, specs: dict, size: int) -> None:
    scale = optimizer.adamw.scale
    for name, dim in specs.items():
        p = optimizer.params[name]
        n = p.numel() // size
        if dim is None or p.numel() < scale.min_8bit_size:
            continue
        if dim != 0 or n % scale.block or n < scale.min_8bit_size:
            raise ValueError(f"ZeRO over 8-bit moments: {name} {tuple(p.shape)} splits on dim "
                             f"{dim} into blocks of {n} elements, which do not fall on the "
                             f"moments' {scale.block}-element quantisation blocks")


def zero_shard_opt_state(state: TrainState, pg) -> TrainState:
    """The optimizer rebuilt over this rank's blocks of the trainable parameters
    (``zero_shardings``), its moments 1/N of the replicated ones, the gradients averaged over
    ``pg`` (data parallelism). Call before the first step."""
    opt = state.optimizer
    specs = zero_shardings(state, dist.get_world_size(pg))
    if opt.use_8bit:
        _check_8bit_blocks(opt, specs, dist.get_world_size(pg))
    opt.group = pg
    opt.shards = {name: (dim, p if dim is None
                         else shard(p.detach(), dim, pg).clone().requires_grad_(True))
                  for name, dim in specs.items() for p in (opt.params[name],)}
    opt.adamw = opt.inner([block for _, block in opt.shards.values()])
    return state


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str = "output"
    max_steps: int = 1000
    checkpoint_every: int = 500
    checkpoints_total_limit: Optional[int] = 3
    log_every: int = 10
    seed: int = 42
    validation_every: Optional[int] = None


class Trainer:
    """Runs ``train_step(state, batch, generator) -> (state, loss)`` over batches. Random
    draws come from one ``torch.Generator`` on the model's device, seeded from
    ``config.seed``. ``validation_fn(state, step) -> metrics`` runs every
    ``config.validation_every`` steps, its metrics logged with a ``val_`` prefix;
    ``tracker`` (``utils/trackers.py``) receives every record the JSONL file does and is
    closed at the end of ``fit``."""

    def __init__(self, train_step: Callable, state: TrainState, config: TrainerConfig,
                 validation_fn: Optional[Callable[[TrainState, int], Dict[str, Any]]] = None,
                 tracker=None):
        self.train_step = train_step
        self.state = state
        self.config = config
        self.validation_fn = validation_fn
        self.tracker = tracker
        device = next(state.unet.parameters()).device
        self.generator = torch.Generator(device=device).manual_seed(config.seed)
        self.checkpoint_dir = Path(config.output_dir) / "checkpoints"
        # under data parallelism rank 0 alone writes
        self.main_process = not dist.is_initialized() or dist.get_rank() == 0
        if self.main_process:
            self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self._metrics_path = Path(config.output_dir) / "metrics.jsonl"

    # ---------------------------------------------------------------- checkpointing
    def _checkpoints(self):
        """(step, path) of the saved checkpoints, oldest first."""
        found = [(int(p.stem), p) for p in self.checkpoint_dir.glob("*.pt") if p.stem.isdigit()]
        return sorted(found)

    def save_checkpoint(self, step: int) -> Optional[Path]:
        if not self.main_process:
            return None
        state = self.state
        blob = {"step": step,
                "trainables": {n: p.detach() for n, p in state.trainables.items()},
                "optimizer": state.optimizer.state_dict(),
                "ema": state.ema_params}
        path = self.checkpoint_dir / f"{step}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, path)
        limit = self.config.checkpoints_total_limit
        if limit:
            for _, old in self._checkpoints()[:-limit]:
                old.unlink()
        return path

    def restore_latest(self) -> int:
        """Resume from the newest checkpoint; returns its step (0 if there is none)."""
        found = self._checkpoints()
        if not found:
            return 0
        state = self.state
        device = next(state.unet.parameters()).device
        blob = torch.load(found[-1][1], map_location=device, weights_only=True)
        with torch.no_grad():
            for name, p in state.trainables.items():
                p.copy_(blob["trainables"][name])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.ema_params = blob["ema"]
        state.step = int(blob["step"])
        return state.step

    # ---------------------------------------------------------------- loop
    def _log(self, record: dict) -> None:
        if not self.main_process:
            return
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.tracker is not None:
            self.tracker.log(record, step=int(record.get("step", 0)))

    def fit(self, data: Iterable) -> TrainState:
        cfg = self.config
        start_step = self.state.step
        t0 = time.time()
        losses = []
        for batch in data:
            if self.state.step >= cfg.max_steps:
                break
            self.state, loss = self.train_step(self.state, batch, self.generator)
            losses.append(loss)
            step = self.state.step
            if step % cfg.log_every == 0:
                loss_val = torch.stack(losses).float().mean().item()
                losses.clear()
                dt, t0 = time.time() - t0, time.time()
                self._log({"step": step, "train_loss": loss_val,
                           "steps_per_sec": cfg.log_every / max(dt, 1e-9)})
            if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                self.save_checkpoint(step)
            if (self.validation_fn is not None and cfg.validation_every and self.main_process
                    and step % cfg.validation_every == 0):
                metrics = self.validation_fn(self.state, step) or {}
                self._log({"step": step, **{f"val_{k}": v for k, v in metrics.items()}})
        if self.state.step > start_step:
            self.save_checkpoint(self.state.step)
        if self.tracker is not None:
            self.tracker.close()
        return self.state


def export_trainable_safetensors(module: nn.Module, predicate: Callable[[str], bool],
                                 path: str, key_map: Optional[Callable[[str], str]] = None
                                 ) -> int:
    """Write the parameters whose names ``predicate`` selects (LoRA factors, knowledge
    fusion) to a safetensors file, as fp32, under the names and layouts the JAX package's
    ``export_trainable_safetensors`` gives them: the module's own names, or ``key_map`` of
    them where the module tree differs (``utils/porting.py`` ``cogvideox_export_name``).
    Returns the number of tensors."""
    tensors = {(key_map(name) if key_map else name): p.detach().float().cpu().numpy()
               for name, p in module.named_parameters() if predicate(name)}
    save_safetensors(tensors, path)
    return len(tensors)
