"""The port's CogVideoX fine-tuning CLI (``lkgd_torch/cli/train_cogvideox_lora.py``) run
in-process on the CPU at tiny widths, 2 steps, from a tensor cache written by the JAX
package's ``TensorCache``:

* LoRA, ``--full-finetune --remat``, ``--mode t2v``, ``--use-8bit-adam``: every exported
  tensor moved from the weights the run started from (the same seed built again), and the
  last checkpoint's trainables equal to the export;
* ``--validation-every 2 --num-validation-steps 2 --report-to tensorboard``: the
  validation latents and the event file;
* resume: a second run restores the newest checkpoint's step and trainables;
* the export's names and shapes equal to the JAX CLI's export of the same configuration
  (the JAX CLI run in-process on the same cache, its initial trainables exported);
* an SVD-flavoured cache (``cond_latents``, ``image_embeddings``) adapted as the JAX CLI
  adapts it;
* ``--weights`` refused."""

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from lkgd_tpu.data.tensor_cache import TensorCache as JaxTensorCache  # noqa: E402

from lkgd_torch.cli import train_cogvideox_lora as cli  # noqa: E402
from lkgd_torch.data.tensor_cache import PrecomputedLatentDataset  # noqa: E402
from lkgd_torch.utils.porting import load_safetensors  # noqa: E402

STEPS = ["--tiny", "--max-steps", "2", "--checkpoint-every", "2", "--batch-size", "1"]


def make_cache(path, svd: bool = False) -> str:
    """Two clips of 3 latent frames at 4x4, the first frame's latents and 8 T5 tokens of
    width 64, through the JAX package; ``svd``: the SVD cache's field names instead."""
    cache = JaxTensorCache(path)
    rng = np.random.default_rng(0)
    for i in range(2):
        cache.put(f"clip{i}/latents", rng.normal(size=(3, 4, 4, 4)).astype(np.float32))
        if svd:
            cache.put(f"clip{i}/cond_latents", rng.normal(size=(4, 4, 4)).astype(np.float32))
            cache.put(f"clip{i}/image_embeddings", rng.normal(size=(1, 24)).astype(np.float32))
        else:
            cache.put(f"clip{i}/image_latents", rng.normal(size=(4, 4, 4)).astype(np.float32))
            cache.put(f"clip{i}/prompt_embeds", rng.normal(size=(8, 64)).astype(np.float32))
    cache.close()
    return path


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return make_cache(str(tmp_path_factory.mktemp("cache") / "cache.lkgd"))


def run_cli(cache_path, out_dir, *extra):
    argv = ["--cache", cache_path, "--output-dir", str(out_dir), "--device", "cpu", *STEPS,
            *extra]
    cli.main(argv)
    return cli.make_parser().parse_args(argv)


@pytest.mark.parametrize("extra", [[], ["--full-finetune", "--remat"], ["--mode", "t2v"],
                                   ["--use-8bit-adam"]],
                         ids=["lora", "full_finetune_remat", "t2v", "adam8bit"])
def test_fit_and_export(cache, tmp_path, capsys, extra):
    args = run_cli(cache, tmp_path, *extra)
    stdout = capsys.readouterr().out
    n = int(stdout.strip().splitlines()[-1].split()[1])
    exported = load_safetensors(str(tmp_path / "model.safetensors"))
    assert len(exported) == n
    assert (n > 50) == ("--full-finetune" in extra)
    fresh = cli.build(args)  # the same seed: the weights the run started from
    start = {cli.cogvideox_export_name(k): v.detach() for k, v in
             fresh.transformer.named_parameters()}
    moved = [k for k, v in exported.items() if not np.array_equal(v, start[k].numpy())]
    assert len(moved) == n, sorted(set(exported) - set(moved))
    ckpt = torch.load(tmp_path / "checkpoints" / "2.pt", weights_only=True)
    assert ckpt["step"] == 2 and len(ckpt["trainables"]) == n
    for name, value in ckpt["trainables"].items():
        np.testing.assert_array_equal(value.numpy(), exported[cli.cogvideox_export_name(name)])
    if "--mode" in extra:
        assert fresh.transformer.config.in_channels == fresh.transformer.config.out_channels


def test_validation_and_tensorboard(cache, tmp_path):
    run_cli(cache, tmp_path, "--validation-every", "2", "--num-validation-steps", "2",
            "--report-to", "tensorboard")
    latents = np.load(tmp_path / "validation" / "step2_latents.npy")
    assert latents.shape == (1, 3, 4, 4, 4) and np.isfinite(latents).all()
    events = [f for _, _, files in os.walk(tmp_path / "tb") for f in files]
    assert any(f.startswith("events.") for f in events), events


def test_resume_from_checkpoint(cache, tmp_path):
    run_cli(cache, tmp_path)
    saved = torch.load(tmp_path / "checkpoints" / "2.pt", weights_only=True)
    args = cli.make_parser().parse_args(["--cache", cache, "--output-dir", str(tmp_path),
                                         "--device", "cpu", *STEPS[:1], "--max-steps", "3"])
    run = cli.build(args)
    assert run.trainer.restore_latest() == 2
    for name, p in run.trainer.state.trainables.items():
        assert torch.equal(p, saved["trainables"][name]), name
    data = PrecomputedLatentDataset(cache)
    batch = {k: v[None] for k, v in cli._Adapted(data, 64)[0].items()}
    run.trainer.fit(iter([batch] * 3))
    assert run.trainer.state.step == 3
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["2.pt", "3.pt"]


def test_export_names_and_shapes_equal_the_jax_cli(cache, tmp_path, monkeypatch):
    from lkgd_tpu.cli import train_cogvideox_lora as jax_cli

    monkeypatch.setenv("LKGD_JAX_CACHE", str(tmp_path / "jax_cache"))
    flags = ["--rank", "4", "--lora-alpha", "2"]
    # names and shapes do not depend on training: the JAX CLI exports its initial trainables
    monkeypatch.setattr(sys, "argv", ["train_cogvideox_lora", "--cache", cache, "--output-dir",
                                      str(tmp_path / "jax"), *STEPS, "--max-steps", "0",
                                      *flags])
    jax_cli.main()
    run_cli(cache, tmp_path / "port", *flags)
    theirs = load_safetensors(str(tmp_path / "jax" / "model.safetensors"))
    ours = load_safetensors(str(tmp_path / "port" / "model.safetensors"))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
    assert len(ours) == 2 * 4 * 2 + 29  # 2 layers x 4 projections x (A, B) + the fusion


def test_svd_flavoured_cache_is_adapted(tmp_path):
    path = make_cache(str(tmp_path / "svd.lkgd"), svd=True)
    sample = cli._Adapted(PrecomputedLatentDataset(path), 64)[0]
    assert sorted(sample) == ["image_latents", "latents", "prompt_embeds"]
    emb = PrecomputedLatentDataset(path)[0]["image_embeddings"].reshape(-1)
    want = np.tile(emb.numpy(), 3)[:64][None].repeat(8, 0)
    np.testing.assert_array_equal(sample["prompt_embeds"].numpy(), want)
    run_cli(path, tmp_path / "out")
    assert (tmp_path / "out" / "model.safetensors").exists()


def test_weights_refused(cache, tmp_path, capsys):
    with pytest.raises(SystemExit):
        run_cli(cache, tmp_path, "--weights", str(tmp_path))
    assert "ROADMAP.md Queue 1, item 11" in capsys.readouterr().err
    args = cli.make_parser().parse_args(["--weights", "w", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
        cli.build(args)
