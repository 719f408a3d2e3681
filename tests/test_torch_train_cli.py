"""The port's LKGD fine-tune entry point (``lkgd_torch/cli/train_svd_lora.py``) and its data
(``lkgd_torch/data/datasets.py``) on the CPU, at tiny widths.

* ``build`` + ``Trainer.fit``: a few steps through the frozen preprocessing and the train
  step; the trained parameters move, the frozen ones stay bit-identical, checkpoints
  rotate, the metrics log and the export hold what the JAX CLI writes;
* each option the JAX CLI has: ``--use-8bit-adam`` moves the trainables through 8-bit
  moments; ``--validation-image`` writes ``step{n}_sample{i}.gif`` rendered with the
  current weights (base and trans pipelines; an odd count refuses in trans mode);
  ``--report-to tensorboard`` writes an event file and ``wandb`` without its package exits;
  ``--weights``, which needs a checkpoint the repository does not hold, raises
  ``NotImplementedError`` (``--mode trans``: ``tests/test_torch_train_trans.py``);
* ``MiniDataset`` and ``PrefetchLoader`` against ``lkgd_tpu.data.datasets`` (the same
  frames, the same batch order), with the decoder stubbed out: no video file is needed.
"""

import json

import numpy as np
import pytest
import torch

from lkgd_torch.cli import train_svd_lora as cli
from lkgd_torch.data import datasets as tds
from lkgd_torch.models.configs import CLIPVisionConfig, TemporalVAEConfig
from lkgd_torch.models.vit_mae import ViTConfig

TINY = cli.Widths(
    unet=dict(block_out_channels=(32, 64),
              down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
              up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
              layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=64),
    vae=TemporalVAEConfig(block_out_channels=(32, 64), layers_per_block=1),
    clip=CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                          num_heads=2, intermediate_size=128, projection_dim=64),
    vit=ViTConfig.tiny())
H = W = 48
T = 4


def _args(tmp_path, *extra):
    return cli.make_parser().parse_args(
        ["--output-dir", str(tmp_path), "--height", str(H), "--width", str(W),
         "--num-frames", str(T), "--max-steps", "3", "--checkpoint-every", "1", "--remat",
         "--dtype", "fp32", "--device", "cpu", "--rank", "2", *extra])


def test_build_fit_and_export(tmp_path):
    from safetensors.numpy import load_file

    run = cli.build(_args(tmp_path), TINY)
    before = {n: p.detach().clone() for n, p in run.unet.named_parameters()}
    run.trainer.config.log_every = 1
    run.trainer.config.checkpoints_total_limit = 2
    px = torch.rand(1, T + 1, H, W, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    batch = run.preprocess(px, torch.Generator().manual_seed(1))
    assert batch["latents"].shape == (1, T, H // 2, W // 2, 4)  # the tiny VAE: two levels
    assert batch["image_embeddings"].shape == (1, 1, 64)
    assert batch["domain_features"].shape == (1, 1, ViTConfig.tiny().num_classes)
    state = run.trainer.fit(iter([{"pixel_values": px}] * 5))
    assert state.step == 3

    trained = {n for n, p in run.unet.named_parameters() if p.requires_grad}
    assert trained == {n for n in before if cli.trainable(n)}
    assert any("lora_lkgd_A" in n for n in trained) and any("knowledge_fusion" in n
                                                           for n in trained)
    assert all("temporal_transformer_blocks" in n and ".attn1." in n
               for n in trained if "lora_" in n)
    for name, p in run.unet.named_parameters():
        if name in trained:
            assert torch.isfinite(p).all(), name
        else:
            assert torch.equal(p, before[name]), f"frozen {name} moved"
    assert any(not torch.equal(run.unet.get_parameter(n), before[n]) for n in trained)

    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["train_loss"]) for r in records)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["2.pt", "3.pt"]

    path = tmp_path / "model.safetensors"
    n = cli.export_trainable_safetensors(run.unet, cli.trainable, str(path))
    exported = load_file(str(path))
    assert n == len(exported) == len(trained)
    for name, value in exported.items():
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, run.unet.get_parameter(name).detach().numpy())


@pytest.mark.parametrize("flag", [["--weights", "svd"]], ids=["weights"])
def test_unported_options_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError):
        cli.build(_args(tmp_path, *flag), TINY)


def _clip(seed=0):
    return {"pixel_values": torch.rand(1, T + 1, H, W, 3,
                                       generator=torch.Generator().manual_seed(seed)) * 2 - 1}


def test_8bit_adam_moves_the_trainables(tmp_path):
    """The same trainables move as under fp32 moments (all but a bias whose gradient and
    value are zero), the losses stay finite, and the 8-bit state reads back."""
    from lkgd_torch.training.optim8bit import AdamW8bit

    moved = {}
    for flag in ("--use-8bit-adam", None):
        out = tmp_path / str(flag)
        run = cli.build(_args(out, *([flag] if flag else []), "--max-steps", "2"), TINY)
        assert isinstance(run.trainer.state.optimizer.adamw, AdamW8bit) == bool(flag)
        before = {n: p.detach().clone() for n, p in run.trainer.state.trainables.items()}
        run.trainer.fit(iter([_clip()] * 2))
        moved[flag] = {n for n, p in run.trainer.state.trainables.items()
                       if not torch.equal(p, before[n])}
        assert all(torch.isfinite(p).all() for p in run.trainer.state.trainables.values())
    assert moved["--use-8bit-adam"] == moved[None] and len(moved[None]) >= len(before) - 1
    assert sorted(p.name for p in (tmp_path / "--use-8bit-adam" / "checkpoints").iterdir()) \
        == ["1.pt", "2.pt"]
    run = cli.build(_args(tmp_path / "--use-8bit-adam", "--use-8bit-adam"), TINY)
    assert run.trainer.restore_latest() == 2
    assert int(run.trainer.state.optimizer.adamw.state.count) == 2


def _images(tmp_path, n):
    import imageio.v3 as iio

    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):  # another size than the model's: resized as the JAX CLI does
        paths.append(str(tmp_path / f"v{i}.png"))
        iio.imwrite(paths[-1], (rng.uniform(size=(40, 60, 3)) * 255).astype(np.uint8))
    return [a for path in paths for a in ("--validation-image", path)]


def test_validation_renders_the_current_weights(tmp_path):
    """The sampler runs the trainer's own UNet: a changed LoRA factor changes the clip, and
    the clip equals a separate pipeline's with those weights."""
    from lkgd_torch.data.video_io import load_input, write_video
    from lkgd_torch.pipelines.svd import StableVideoDiffusionPipeline

    run = cli.build(_args(tmp_path, *_images(tmp_path, 2), "--validation-every", "1",
                          "--num-validation-steps", "2", "--max-steps", "1"), TINY)
    run.trainer.fit(iter([_clip()]))
    out = tmp_path / "validation"
    assert sorted(p.name for p in out.iterdir()) == ["step1_sample0.gif", "step1_sample1.gif"]
    records = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert {"step": 1, "val_num_samples": 2} in records

    validate, state = run.trainer.validation_fn, run.trainer.state
    validate(state, 7)
    first = load_input(str(out / "step7_sample0.gif"))
    lora_b = next(p for n, p in state.trainables.items() if n.endswith("lora_lkgd_B"))
    with torch.no_grad():
        lora_b.add_(torch.randn(lora_b.shape, generator=torch.Generator().manual_seed(5)))
    validate(state, 7)
    second = load_input(str(out / "step7_sample0.gif"))
    assert np.abs(first - second).max() > 0

    # a pipeline of its own with the trained weights copied in, the same seed (7 * 100 + 0)
    sampler = validate.pipeline
    assert sampler.unet is run.unet  # nothing copied
    pipe = StableVideoDiffusionPipeline(
        config=sampler.config, unet_config=run.unet.config, vae_config=TINY.vae,
        clip_config=TINY.clip, dtype=torch.float32, device="cpu")
    for mine, theirs in zip(pipe.models, sampler.models):
        mine.load_state_dict(theirs.state_dict())
    image = cli.load_validation_image(str(tmp_path / "v0.png"), H, W)
    frames = pipe(image[None], generator=torch.Generator().manual_seed(700))[0]
    write_video(str(tmp_path / "own.gif"), frames)
    np.testing.assert_array_equal(load_input(str(tmp_path / "own.gif")), second)
    assert all(p.requires_grad for p in state.trainables.values())


def test_validation_renders_the_ema_weights_when_there_is_one():
    """Inside ``ema_weights`` the trainables hold the EMA's tensors, after it their own (the
    same storage: nothing copied); without an EMA nothing changes."""
    from lkgd_torch.training.train_state import init_train_state, make_optimizer
    from lkgd_torch.training.variants import ema_weights

    module = torch.nn.Linear(3, 2)
    state = init_train_state(module, make_optimizer(), ema=True)
    own = {n: p.data_ptr() for n, p in state.trainables.items()}
    state.ema_params = {n: torch.full_like(p, 7.0) for n, p in state.trainables.items()}
    with ema_weights(state):
        assert all(torch.equal(p, state.ema_params[n]) for n, p in state.trainables.items())
        assert torch.equal(module(torch.zeros(1, 3)), torch.full((1, 2), 7.0))
    assert all(p.data_ptr() == own[n] for n, p in state.trainables.items())
    state.ema_params = None
    with ema_weights(state):
        assert all(p.data_ptr() == own[n] for n, p in state.trainables.items())


def test_validation_in_trans_mode_takes_pairs(tmp_path):
    run = cli.build(_args(tmp_path, "--mode", "trans", *_images(tmp_path, 2),
                          "--validation-every", "1", "--num-validation-steps", "2",
                          "--max-steps", "1"), TINY)
    run.trainer.fit(iter([_clip()]))
    assert [p.name for p in (tmp_path / "validation").iterdir()] == ["step1_sample0.gif"]
    with pytest.raises(SystemExit, match="pairs"):
        cli.build(_args(tmp_path, "--mode", "trans", *_images(tmp_path, 3),
                        "--validation-every", "1"), TINY)


def test_report_to_tensorboard_writes_an_event_file(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    run = cli.build(_args(tmp_path, "--report-to", "tensorboard", "--max-steps", "1"), TINY)
    run.trainer.config.log_every = 1
    run.trainer.fit(iter([_clip()]))
    assert list((tmp_path / "tb" / "svd_lkgd").glob("events.out.tfevents.*"))


def test_report_to_wandb_without_the_package_exits(tmp_path):
    try:
        import wandb  # noqa: F401
        pytest.skip("wandb is installed here")
    except ImportError:
        pass
    with pytest.raises(SystemExit, match="requires the wandb package"):
        cli.build(_args(tmp_path, "--report-to", "wandb"), TINY)


def test_main_requires_a_video_folder(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--output-dir", str(tmp_path)])


# ------------------------------------------------------------------ data
def _fake_reader(n_frames):
    def read(path):
        rng = np.random.default_rng(len(path))
        return rng.uniform(size=(n_frames, 40, 56, 3)).astype(np.float32), 24.0
    return read


def test_mini_dataset_matches_jax(tmp_path, monkeypatch):
    """A clip of exactly T+1 frames leaves the sampler no choice of interval or start, so
    both datasets give the same frames, up to the random left-right flip."""
    jds = pytest.importorskip("lkgd_tpu.data.datasets")
    for name in ("a.mp4", "bb.mp4"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setattr(tds, "read_video_frames", _fake_reader(T + 1))
    monkeypatch.setattr(jds, "read_video_frames", _fake_reader(T + 1))
    ours = tds.MiniDataset(str(tmp_path), repeat_num=2, sample_size=(32, 48),
                           sample_n_frames=T)
    theirs = jds.MiniDataset(str(tmp_path), repeat_num=2, sample_size=(32, 48),
                             sample_n_frames=T)
    assert len(ours) == len(theirs) == 4
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got["pixel_values"].shape == (T + 1, 32, 48, 3)
        assert got["fps"] == want["fps"] == np.float32(24.0)
        x, y = got["pixel_values"], want["pixel_values"]
        assert np.allclose(x, y) or np.allclose(x, y[:, :, ::-1])
        assert x.min() >= -1.0 and x.max() <= 1.0


def test_prefetch_loader_matches_jax_order():
    """Torch tensors on the device, in the JAX loader's order, epoch after epoch."""
    jds = pytest.importorskip("lkgd_tpu.data.datasets")
    data = [{"pixel_values": np.full((2, 3), i, np.float32), "caption": f"c{i}"}
            for i in range(7)]
    ours = iter(tds.PrefetchLoader(data, batch_size=2, seed=3, device="cpu"))
    theirs = iter(jds.PrefetchLoader(data, batch_size=2, seed=3))
    for _ in range(7):  # three batches an epoch, the seventh of them epoch 2's
        got, want = next(ours), next(theirs)
        assert isinstance(got["pixel_values"], torch.Tensor)
        np.testing.assert_array_equal(got["pixel_values"].numpy(), want["pixel_values"])
        assert got["caption"] == want["caption"]
    ours.close()
    theirs.close()


def test_prefetch_loader_raises_the_producers_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("bad clip")

    with pytest.raises(ValueError, match="bad clip"):
        next(iter(tds.PrefetchLoader(Broken(), batch_size=2, device="cpu")))
