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
* the twelve annotators of HED, PiDiNet, line art, SegFormer and OpenPose: each from a
  ``--weights`` file of a random model under the published names (PiDiNet's raw
  pixel-difference kernels), loaded strictly; the label frames the CLI writes are the ones
  the annotator's processor gives on the model loaded from that file, so each name reaches its
  own variant (soft, ``*safe``, scribble; fine or coarse; B0 for ``--model-size small``). Each
  processor is held against the JAX package's in ``tests/test_torch_edge_annotators.py``,
  ``test_torch_openpose.py`` and ``test_torch_segformer.py``;
* ``--weights`` missing exits, naming the annotator's checkpoint."""

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


MODEL_LABELS = ("softedge_hed", "scribble_hed", "softedge_hedsafe", "scribble_hedsafe",
                "softedge_pidinet", "softedge_pidsafe", "scribble_pidinet", "lineart",
                "lineart_coarse", "lineart_anime", "segmentation", "openpose")


def _label_model(annotation: str, monkeypatch):
    """(a random model's file contents under the published names, the processor the name
    must reach on the model loaded from them) at sizes the CPU runs quickly: the published
    widths but for Anime2Sketch (``num_downs=6, ngf=8``) and SegFormer (tiny); OpenPose at
    ``detect_resolution=64``."""
    import functools

    from lkgd_torch.models import hed, lineart, lineart_anime, openpose, pidinet, segformer

    g = torch.Generator().manual_seed(len(annotation))
    if annotation.endswith(("_hed", "_hedsafe")):
        model = hed.build_hed("cpu", g)
        return model.state_dict(), hed.make_hed_processor(
            model, scribble=annotation.startswith("scribble"), safe=annotation.endswith("safe"))
    if annotation.endswith(("_pidinet", "_pidsafe")):
        with torch.device("meta"):
            names = pidinet.PiDiNet().state_dict()
        raw = {name: torch.randn((t.shape[0], 1, 3, 3) if pidinet.pdc_op_for(name) == "rd"
                                 else t.shape, generator=g) * 0.3 for name, t in names.items()}
        model = pidinet.build_pidinet("cpu")
        model.load_state_dict(pidinet.port_pidinet(raw), strict=True)
        return {f"module.{k}": v for k, v in raw.items()}, pidinet.make_pidinet_processor(
            model, safe=annotation.endswith("pidsafe"), scribble=annotation.startswith("scribble"))
    if annotation.startswith("lineart_anime"):
        cfg = lineart_anime.LineartAnimeConfig(num_downs=6, ngf=8)
        monkeypatch.setattr(lineart_anime, "LineartAnimeConfig", lambda: cfg)
        model = lineart_anime.build_lineart_anime(cfg, "cpu", g)
        return model.state_dict(), lineart_anime.make_lineart_anime_processor(model)
    if annotation.startswith("lineart"):
        model = lineart.build_lineart(lineart.LineartConfig(), "cpu", g)
        return model.state_dict(), lineart.make_lineart_processor(model)
    if annotation == "segmentation":
        cfg = segformer.SegformerConfig.tiny()
        monkeypatch.setattr(segformer, "segformer_config",
                            lambda size: cfg if size == "small" else None)
        model = segformer.build_segformer(cfg, "cpu", g)
        return model.state_dict(), segformer.make_segmentation_processor(model)
    monkeypatch.setattr(openpose, "make_openpose_processor", functools.partial(
        openpose.make_openpose_processor, detect_resolution=64))
    model = openpose.build_openpose(openpose.OpenPoseConfig(), "cpu", g)
    return model.state_dict(), openpose.make_openpose_processor(model)


@pytest.mark.parametrize("annotation", MODEL_LABELS)
def test_model_labels_from_a_weights_file(clip, tmp_path, monkeypatch, annotation):
    contents, process = _label_model(annotation, monkeypatch)
    path = str(tmp_path / f"{annotation}.pth")
    torch.save(contents, path)
    got = recorded(monkeypatch, video_io)
    annotate.main(["--input", str(clip), "--annotation", annotation, "--weights", path,
                   "--output", str(tmp_path), "--device", "cpu"])
    want = np.stack([process(f) for f in video_io.load_input(str(clip / "clip.gif"))])
    assert got[0].shape == want.shape == (T, H, W, 3) and got[0].dtype == want.dtype
    np.testing.assert_array_equal(got[0], want)
    assert (tmp_path / f"clip_{annotation}.gif").exists()


def test_refusals(clip, tmp_path):
    for annotation in ("tracks", "depth", "depth_midas", "depth_anything") + MODEL_LABELS:
        with pytest.raises(SystemExit, match="needs --weights") as refused:
            annotate.main(["--input", str(clip), "--output", str(tmp_path), "--annotation",
                           annotation, "--device", "cpu"])
        assert annotate.WEIGHTS[annotation] in str(refused.value)
