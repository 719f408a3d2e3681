"""Experiment trackers behind the training CLI's ``--report-to`` (counterpart of
``lkgd_tpu/utils/trackers.py``).

The trainer's JSONL file (``metrics.jsonl``) is always written; a tracker mirrors the same
records: ``tensorboard`` through ``torch.utils.tensorboard``'s ``SummaryWriter``, ``wandb``
through the ``wandb`` package. Both are imported only when asked for, and a missing package
ends the run with a ``SystemExit`` that says so; nothing is installed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


class NullTracker:
    """JSONL only (the trainer writes that itself)."""

    def log(self, record: Dict[str, Any], step: int) -> None:
        pass

    def close(self) -> None:
        pass


class TensorBoardTracker:
    """Scalars to ``output_dir/tb/<run_name>``."""

    def __init__(self, output_dir: str, run_name: str = "train"):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise SystemExit("--report-to tensorboard requires the tensorboard package (not "
                             "installed); use --report-to jsonl") from e
        self._writer = SummaryWriter(os.path.join(output_dir, "tb", run_name))

    def log(self, record: Dict[str, Any], step: int) -> None:
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "step":
                self._writer.add_scalar(k, float(v), global_step=step)

    def close(self) -> None:
        self._writer.flush()
        self._writer.close()


class WandbTracker:
    def __init__(self, output_dir: str, run_name: str = "train",
                 project: Optional[str] = None):
        try:
            import wandb
        except ImportError as e:
            raise SystemExit(
                "--report-to wandb requires the wandb package (not installed); "
                "use --report-to tensorboard or jsonl") from e
        self._run = wandb.init(project=project or os.environ.get("WANDB_PROJECT", "lkgd"),
                               name=run_name, dir=output_dir)

    def log(self, record: Dict[str, Any], step: int) -> None:
        self._run.log({k: v for k, v in record.items() if k != "step"}, step=step)

    def close(self) -> None:
        self._run.finish()


def make_tracker(report_to: Optional[str], output_dir: str, run_name: str = "train"):
    """``report_to``: None / "jsonl" / "none" -> ``NullTracker`` (the JSONL file stays on
    regardless), "tensorboard" -> ``TensorBoardTracker``, "wandb" -> ``WandbTracker``."""
    if report_to in (None, "", "jsonl", "none"):
        return NullTracker()
    if report_to == "tensorboard":
        return TensorBoardTracker(output_dir, run_name)
    if report_to == "wandb":
        return WandbTracker(output_dir, run_name)
    raise ValueError(f"unknown report_to={report_to!r} (jsonl|tensorboard|wandb)")
