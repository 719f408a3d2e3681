"""``lkgd_torch.cli.caption`` against the JAX package's ``lkgd_tpu.cli.caption``, both run
in-process on the same inputs (a 4-frame 40 x 56 GIF and a PNG), each model's configuration
set to its tiny one on both sides (BLIP: ``tests/test_torch_blip.py``'s; CogVLM:
``CogVLMConfig.tiny()``), from one ``--weights`` file of random JAX params under the published
names (``blip_state_dict``, ``cogvlm_state_dict``), which the JAX CLI reads through its porters
and the port's loads strictly (CogVLM's cls embedding and position table given the JAX porter
with the leading axis it expects, ROADMAP.md Queue 3):

* ``--model blip``: the captions' ids equal;
* ``--model cogvlm --prompt-ids``: the ids equal with both sides in fp32 (the JAX CLI's module
  and the port's ``caption.COGVLM_DTYPE`` set to fp32 here: bf16 on both sides would compare
  two roundings of near-tied random logits); the port's own bf16 run writes ids in range;
* ``--tokenizer``, a text ``--prompt`` and CogVLM without ``--prompt-ids`` are refused, naming
  ROADMAP.md Queue 1, item 14e."""

import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lkgd_tpu.cli.caption as jax_cli  # noqa: E402
from lkgd_tpu.models import blip as JB  # noqa: E402
from lkgd_tpu.models import cogvlm as JC  # noqa: E402

from lkgd_torch.cli import caption  # noqa: E402
from lkgd_torch.data import video_io  # noqa: E402
from lkgd_torch.models import blip as PB  # noqa: E402
from lkgd_torch.models import cogvlm as PC  # noqa: E402
from lkgd_torch.utils.porting import (blip_state_dict, cogvlm_state_dict,  # noqa: E402
                                      save_safetensors)
from tests.test_torch_blip import TINY  # noqa: E402
from tests.test_torch_porting import flatten  # noqa: E402
from tests.test_torch_raft import random_params  # noqa: E402


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    base = rng.uniform(size=(46, 64, 3)).astype(np.float32)
    video_io.write_video(str(folder / "clip.gif"),
                         np.stack([base[i:i + 40, 2 * i:2 * i + 56] for i in range(4)]))
    from PIL import Image

    Image.fromarray((rng.uniform(size=(36, 48, 3)) * 255).astype(np.uint8)).save(
        folder / "still.png")
    return folder


def _both(monkeypatch, tmp_path, argv, port_extra=(), jax_extra=()):
    monkeypatch.setattr(sys, "argv", ["caption", *argv, *jax_extra, "--output",
                                      str(tmp_path / "jax.json")])
    jax_cli.main()
    caption.main([*argv, *port_extra, "--output", str(tmp_path / "port.json"), "--device", "cpu"])
    return [json.loads((tmp_path / f"{side}.json").read_text()) for side in ("port", "jax")]


def test_blip(inputs, tmp_path, monkeypatch):
    model = JB.BlipCaptioner(JB.BlipConfig(**TINY))
    params = random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3)),
                                          jnp.zeros((1, 4), jnp.int32)), 7)
    path = str(tmp_path / "blip.safetensors")
    save_safetensors({k: v.numpy() for k, v in blip_state_dict(flatten(params)).items()}, path)
    monkeypatch.setattr(JB.BlipConfig, "large", classmethod(lambda cls: cls(**TINY)))
    monkeypatch.setattr(PB.BlipConfig, "large", classmethod(lambda cls: cls(**TINY)))
    got, want = _both(monkeypatch, tmp_path, ["--input", str(inputs), "--weights", path,
                                              "--max-length", "8", "--frame", "2"])
    assert sorted(got) == ["clip.gif", "still.png"] and got == want
    assert all(0 < len(ids) <= 7 for ids in got.values())


def test_cogvlm(inputs, tmp_path, monkeypatch):
    model = JC.CogVLMVideoCaptioner(JC.CogVLMConfig.tiny())
    params = random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 1, 32, 32, 3)),
                                          jnp.zeros((1, 4), jnp.int32)), 8)
    sd = {k: v.numpy() for k, v in cogvlm_state_dict(flatten(params)).items()}
    path = str(tmp_path / "cogvlm.safetensors")
    save_safetensors(sd, path)
    # the JAX porter fits neither THUDM's (1, D) cls embedding nor its (N, D) position table
    # into its (1, 1, D) and (1, N, D) leaves (ROADMAP.md Queue 3): its file adds the axis
    for name in ("model.vision.patch_embedding.cls_embedding",
                 "model.vision.patch_embedding.position_embedding.weight"):
        sd[name] = sd[name][None]
    save_safetensors(sd, str(tmp_path / "cogvlm_jax.safetensors"))
    prompt = tmp_path / "prompt.json"
    prompt.write_text(json.dumps([5, 9, 17]))
    monkeypatch.setattr(JC.CogVLMConfig, "caption_8b", classmethod(lambda cls: cls.tiny()))
    monkeypatch.setattr(PC.CogVLMConfig, "caption_8b", classmethod(lambda cls: cls.tiny()))
    monkeypatch.setattr(JC, "CogVLMVideoCaptioner",
                        lambda cfg, dtype: model.clone(parent=None))  # fp32, not the CLI's bf16
    argv = ["--model", "cogvlm", "--input", str(inputs), "--prompt-ids", str(prompt),
            "--max-length", "6", "--num-frames", "3"]
    with monkeypatch.context() as fp32:
        fp32.setattr(caption, "COGVLM_DTYPE", torch.float32)
        got, want = _both(monkeypatch, tmp_path, argv, ["--weights", path],
                          ["--weights", str(tmp_path / "cogvlm_jax.safetensors")])
    assert sorted(got) == ["clip.gif", "still.png"] and got == want
    assert all(len(ids) > 0 for ids in got.values())
    caption.main([*argv, "--weights", path, "--output", str(tmp_path / "bf16.json"),
                  "--device", "cpu"])
    bf16 = json.loads((tmp_path / "bf16.json").read_text())
    assert all(len(ids) <= 6 and all(0 < t < 64 and t != 2 for t in ids) for ids in bf16.values())


def test_refusals(inputs, tmp_path):
    base = ["--input", str(inputs), "--output", str(tmp_path / "c.json"), "--weights", "w.pth",
            "--device", "cpu"]
    for extra in (["--tokenizer", "bert"], ["--model", "cogvlm"],
                  ["--model", "cogvlm", "--prompt", "Describe the video."]):
        with pytest.raises(SystemExit, match=r"ROADMAP.md Queue 1, item 14e"):
            caption.main(base + extra)
