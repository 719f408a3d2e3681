"""``lkgd_torch.cli.annotate`` on the CPU against the JAX package's ``lkgd_tpu.cli.annotate``,
both run in-process on the same tiny GIF (4 frames of 30 x 44, a drifting random image):

* ``canny`` and ``tile``: the label GIFs decode to the same frames;
* ``flow``: the JAX CLI with ``UniMatchConfig.lkgd`` set to ``tiny`` initialises its UniMatch
  from ``PRNGKey(0)``; those params, carried across by ``unimatch_state_dict``, are given to
  the port's CLI (its ``build_unimatch`` monkeypatched to return them, two pairs a batch);
  the label frames before the GIF agree at atol 2e-5, 2e-3 px on the flow image's scale of
  1/100 a pixel: ``jax.image.resize`` of the 0-255 frames to the padded 32 x 48 is 2.3e-6
  of full scale off (``tests/test_torch_unimatch.py``, whose random model stays within
  1e-3 px), and the CLI's flax-initialised model carries it to 1.2e-3 px at 0.2% of the
  values;
* ``tracks``: a ``--weights`` file of the tiny RAFT's JAX params under torchvision's names,
  read by the JAX CLI through its ``port_raft`` and by the port's strictly (``RAFTConfig``
  set to ``tiny`` in both): the ``.npz`` keys, shapes and values agree (tracks at rtol
  1e-4, atol 2e-4 px, visibility equal);
* ``depth_anything``: a ``--weights`` file of the tiny model's JAX params through
  ``depth_anything_state_dict``, read by the port's CLI (``DepthAnythingConfig.small`` set
  to ``tiny``), against the JAX processor on those params (the JAX CLI reads such a file
  through ``port_depth_anything``, which applies the reassemble transposed kernels mirrored
  against HF's model: ROADMAP.md Queue 3), at rtol 1e-4, atol 2e-4;
* ``--weights`` missing exits; an annotator of ROADMAP item 14d is refused, naming it."""

import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import lkgd_tpu.cli.annotate as jax_cli  # noqa: E402
from lkgd_tpu.data import video_io as jax_io  # noqa: E402
from lkgd_tpu.models import depth_anything as jax_da  # noqa: E402
from lkgd_tpu.models import raft as jax_raft  # noqa: E402
from lkgd_tpu.models import unimatch as jax_unimatch  # noqa: E402
from lkgd_tpu.utils import optical_flow as jax_of  # noqa: E402

from lkgd_torch.cli import annotate  # noqa: E402
from lkgd_torch.data import video_io  # noqa: E402
from lkgd_torch.models.depth_anything import DepthAnythingConfig  # noqa: E402
from lkgd_torch.models.raft import RAFTConfig  # noqa: E402
from lkgd_torch.models.unimatch import UniMatchConfig, build_unimatch  # noqa: E402
from lkgd_torch.utils.porting import (depth_anything_state_dict, raft_state_dict,  # noqa: E402
                                      save_safetensors, unimatch_state_dict)
from tests.test_torch_depth_anything import jax_params as depth_params  # noqa: E402
from tests.test_torch_porting import flatten, jit  # noqa: E402
from tests.test_torch_raft import close, tiny_pair  # noqa: E402

T, H, W = 4, 30, 44


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    folder = tmp_path_factory.mktemp("clips")
    base = np.random.default_rng(0).uniform(size=(H + 6, W + 6, 3)).astype(np.float32)
    video_io.write_video(str(folder / "clip.gif"),
                         np.stack([base[i:i + H, 2 * i:2 * i + W] for i in range(T)]))
    return folder


def run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["annotate", *argv])
    jax_cli.main()


def recorded(monkeypatch, module):
    """The frames each ``write_video`` of ``module`` writes, recorded on the way."""
    seen = []
    real = module.write_video

    def write(path, frames, fps=7):
        seen.append(np.asarray(frames))
        real(path, frames, fps=fps)

    monkeypatch.setattr(module, "write_video", write)
    return seen


@pytest.mark.parametrize("annotation", ["canny", "tile"])
def test_classical_annotations_match(clip, tmp_path, monkeypatch, annotation):
    argv = ["--input", str(clip), "--annotation", annotation]
    run_jax(monkeypatch, argv + ["--output", str(tmp_path / "jax")])
    annotate.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    name = f"clip_{annotation}.gif"
    got = video_io.load_input(str(tmp_path / "port" / name))
    assert got.shape == (T, H, W, 3)
    np.testing.assert_array_equal(got, video_io.load_input(str(tmp_path / "jax" / name)))


def test_flow_with_the_same_unimatch(clip, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_unimatch.UniMatchConfig, "lkgd",
                        classmethod(lambda cls: cls.tiny()))
    # the CLI's PRNGKey(0) init, compiled once instead of run op by op
    init = jax_unimatch.UniMatch.init
    monkeypatch.setattr(jax_unimatch.UniMatch, "init", lambda self, rng, *xs: jit(
        lambda r: init(self, r, *xs))(rng))
    params = []
    real = jax_of.make_flow_fn
    monkeypatch.setattr(jax_of, "make_flow_fn",
                        lambda model, p, hw: params.append(p) or real(model, p, hw))
    want = recorded(monkeypatch, jax_io)
    argv = ["--input", str(clip), "--annotation", "flow"]
    run_jax(monkeypatch, argv + ["--output", str(tmp_path / "jax")])
    model = build_unimatch(UniMatchConfig.tiny(), device="cpu")
    model.load_state_dict(unimatch_state_dict(flatten(params[0])), strict=True)
    got = recorded(monkeypatch, video_io)
    monkeypatch.setattr(annotate, "build_unimatch", lambda *args, **kw: model)
    monkeypatch.setattr(annotate, "FLOW_PAIRS", 2)  # the 3 pairs in two batches
    annotate.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert got[0].shape == want[0].shape == (T, H, W, 3)
    np.testing.assert_array_equal(got[0][-1], got[0][-2])  # the last flow image repeats
    close(got[0], want[0], atol=2e-3 / 100, rtol=0)  # 2e-3 px on the image's 1/100 px scale
    assert (tmp_path / "port" / "clip_flow.gif").exists()


def test_tracks_from_a_weights_file(clip, tmp_path, monkeypatch):
    params, _, _ = tiny_pair()
    path = str(tmp_path / "raft.safetensors")
    save_safetensors({k: v.numpy() for k, v in raft_state_dict(flatten(params)).items()}, path)
    monkeypatch.setattr(jax_raft, "RAFTConfig", jax_raft.RAFTConfig.tiny)
    monkeypatch.setattr(annotate, "RAFTConfig", RAFTConfig.tiny)
    argv = ["--input", str(clip), "--annotation", "tracks", "--weights", path,
            "--grid-size", "4"]
    run_jax(monkeypatch, argv + ["--output", str(tmp_path / "jax")])
    annotate.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    got, want = (np.load(tmp_path / side / "clip.npz") for side in ("port", "jax"))
    assert sorted(got.files) == sorted(want.files) == ["tracks", "visibility"]
    assert got["tracks"].shape == want["tracks"].shape == (T, 16, 2)
    assert got["visibility"].dtype == want["visibility"].dtype == np.bool_
    close(got["tracks"], want["tracks"])
    np.testing.assert_array_equal(got["visibility"], want["visibility"])


def test_depth_anything_from_a_weights_file(clip, tmp_path, monkeypatch):
    cfg = jax_da.DepthAnythingConfig.tiny()
    params = depth_params(cfg)
    path = str(tmp_path / "depth_anything.safetensors")
    save_safetensors({k: v.numpy() for k, v in
                      depth_anything_state_dict(flatten(params)).items()}, path)
    got = recorded(monkeypatch, video_io)
    monkeypatch.setattr(DepthAnythingConfig, "small", classmethod(lambda cls: cls.tiny()))
    annotate.main(["--input", str(clip), "--annotation", "depth_anything", "--weights", path,
                   "--output", str(tmp_path), "--device", "cpu"])
    frames = video_io.load_input(str(clip / "clip.gif"))
    process = jax_da.make_depth_processor(params, cfg)
    want = np.stack([np.asarray(process(f)) for f in frames])
    assert got[0].shape == want.shape == (T, H, W, 3)
    close(got[0], want)


@pytest.mark.parametrize("model", ["raft", "rife", "dpt_hybrid", "dpt_large", "depth_anything"])
def test_random_builds_are_seeded(model):
    """Every parameter and buffer of a model built random from a generator is written by it:
    two builds from one seed are equal and finite."""
    from lkgd_torch.models import depth_anything, midas, raft, rife

    build = {"raft": lambda g: raft.build_raft(RAFTConfig.tiny(), "cpu", g),
             "rife": lambda g: rife.build_rife(rife.RIFEConfig(c=16), "cpu", g),
             "dpt_hybrid": lambda g: midas.build_dpt("hybrid", midas.MidasConfig.tiny(), "cpu", g),
             "dpt_large": lambda g: midas.build_dpt("large", midas.MidasConfig.tiny_large(),
                                                    "cpu", g),
             "depth_anything": lambda g: depth_anything.build_depth_anything(
                 DepthAnythingConfig.tiny(), "cpu", g)}[model]
    a, b = (build(torch.Generator().manual_seed(3)).state_dict() for _ in range(2))
    for name, x in a.items():
        assert torch.isfinite(x).all() and torch.equal(x, b[name]), name


def test_refusals(clip, tmp_path):
    for annotation in ("tracks", "depth", "depth_midas", "depth_anything"):
        with pytest.raises(SystemExit, match="needs --weights"):
            annotate.main(["--input", str(clip), "--output", str(tmp_path), "--annotation",
                           annotation, "--device", "cpu"])
    for annotation in annotate.NOT_PORTED:
        with pytest.raises(SystemExit, match=r"ROADMAP.md Queue 1, item 14d"):
            annotate.main(["--input", str(clip), "--output", str(tmp_path), "--annotation",
                           annotation, "--device", "cpu", "--weights", "w.pth"])
