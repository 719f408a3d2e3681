"""The port's experiment trackers (``lkgd_torch/utils/trackers.py``) against
``lkgd_tpu/utils/trackers.py``: ``make_tracker``'s choice for each ``--report-to`` value,
the TensorBoard event file (skipped where the tensorboard package is missing), the
``SystemExit`` that a missing wandb gives (skipped where wandb is installed), with the JAX
package's message, and the trainer's mirroring of its JSONL records into a tracker."""

import json

import pytest
import torch

from lkgd_torch.training.trainer import Trainer, TrainerConfig
from lkgd_torch.training.train_state import init_train_state, make_optimizer
from lkgd_torch.utils import trackers


def test_make_tracker_choices(tmp_path):
    for report_to in (None, "", "jsonl", "none"):
        assert isinstance(trackers.make_tracker(report_to, str(tmp_path)), trackers.NullTracker)
    with pytest.raises(ValueError, match="unknown report_to"):
        trackers.make_tracker("mlflow", str(tmp_path))


def test_tensorboard_writes_an_event_file(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    tracker = trackers.make_tracker("tensorboard", str(tmp_path), run_name="svd_trans")
    assert isinstance(tracker, trackers.TensorBoardTracker)
    tracker.log({"step": 1, "train_loss": 0.5, "note": "text is skipped"}, step=1)
    tracker.log({"step": 2, "train_loss": 0.25}, step=2)
    tracker.close()
    events = list((tmp_path / "tb" / "svd_trans").glob("events.out.tfevents.*"))
    assert len(events) == 1 and events[0].stat().st_size > 0


def test_wandb_without_the_package_exits_as_the_jax_package_does(tmp_path):
    try:
        import wandb  # noqa: F401
        pytest.skip("wandb is installed here")
    except ImportError:
        pass
    with pytest.raises(SystemExit) as ours:
        trackers.make_tracker("wandb", str(tmp_path))
    jtrackers = pytest.importorskip("lkgd_tpu.utils.trackers")
    with pytest.raises(SystemExit) as theirs:
        jtrackers.make_tracker("wandb", str(tmp_path))
    assert str(ours.value) == str(theirs.value)
    assert "requires the wandb package" in str(ours.value)


def test_trainer_mirrors_records_into_the_tracker(tmp_path):
    class Recorder(trackers.NullTracker):
        def __init__(self):
            self.records, self.closed = [], False

        def log(self, record, step):
            self.records.append((step, record))

        def close(self):
            self.closed = True

    module = torch.nn.Linear(3, 1)
    state = init_train_state(module, make_optimizer(1e-2))

    def step(state, batch, generator):
        loss = (state.unet(batch) ** 2).mean()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    def validate(state, n):
        return {"num_samples": 2}

    recorder = Recorder()
    trainer = Trainer(step, state, TrainerConfig(output_dir=str(tmp_path), max_steps=4,
                                                 checkpoint_every=0, log_every=2,
                                                 validation_every=4),
                      validation_fn=validate, tracker=recorder)
    trainer.fit(iter([torch.ones(2, 3)] * 6))
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r for _, r in recorder.records] == lines
    assert [s for s, _ in recorder.records] == [2, 4, 4]
    assert lines[-1] == {"step": 4, "val_num_samples": 2} and recorder.closed
