"""The port's data modules against the JAX package's: the Gaussian masks bit for bit from
one seed, and every dataset class, the index cache and the loaders item for item on one
synthetic corpus (``tests/test_windowed_clips.py:18-35``'s). Both packages draw a dataset's
randomness from ``np.random.default_rng()``; the tests pin that factory to one seed, so
the two draw the same numbers, and also hand the port an explicit generator of that seed.
Tolerance: none; the numpy pipelines give the same arrays."""

import csv
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import lkgd_tpu.data.datasets as jds  # noqa: E402
import lkgd_tpu.data.gaussian_masks as jgm  # noqa: E402
import lkgd_tpu.data.video_io as jvio  # noqa: E402

import lkgd_torch.data.datasets as tds  # noqa: E402
import lkgd_torch.data.gaussian_masks as tgm  # noqa: E402
import lkgd_torch.data.video_io as tvio  # noqa: E402

SEED = 7
_default_rng = np.random.default_rng


@pytest.fixture
def pinned_rng(monkeypatch):
    """``np.random.default_rng()`` without a seed gives a generator of SEED (a seeded call
    is left alone): both packages' unseeded draws become one sequence."""
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: _default_rng(SEED if seed is None else seed))


def _make_video(path, n_frames, h=24, w=32, fps=14):
    """Frames of distinct levels (50 apart in 0-255, well above the codec's noise)."""
    levels = (np.arange(n_frames) % 5) * 0.2 + 0.1
    frames = np.broadcast_to(levels[:, None, None, None], (n_frames, h, w, 3))
    tvio.write_video(path, frames.astype(np.float32), fps=fps)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    _make_video(str(root / "a.mp4"), 48)
    _make_video(str(root / "b.mp4"), 20)
    _make_video(str(root / "c.mp4"), 6)  # shorter than one window: no windows
    (root / "bad.mp4").write_bytes(b"not a video at all")  # corrupt: no windows
    (root / "a.txt").write_text("a caption about video a")
    (root / "b.txt").write_text("b caption")
    paths = [str(root / n) for n in ("a.mp4", "b.mp4", "c.mp4", "bad.mp4")]
    (root / "video_files.json").write_text(json.dumps(paths))
    return root, paths


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or np.isscalar(a[k]) and not isinstance(a[k], str):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------------------ Gaussian masks
@pytest.mark.parametrize("kw", [dict(), dict(thresh=0.3, noise_patch_size=2),
                                dict(smooth=True), dict(smooth=True, thresh=-0.2)],
                         ids=["default", "thresh_patch", "smooth", "smooth_thresh"])
def test_rand_masks_bit_equal(kw):
    want = jgm.get_rand_masks(np.random.default_rng(3), 3, 24, **kw)
    got = tgm.get_rand_masks(np.random.default_rng(3), 3, 24, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape[0] == 3
    np.testing.assert_array_equal(got, want)


def test_mask_pieces_bit_equal():
    field = tgm.gaussian_random_field(np.random.default_rng(1), alpha=3.0, size=32)
    np.testing.assert_array_equal(
        field, jgm.gaussian_random_field(np.random.default_rng(1), alpha=3.0, size=32))
    x = (np.random.default_rng(2).random((17, 19)) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(tgm._box_blur(x, 3), jgm._box_blur(x, 3))
    np.testing.assert_array_equal(tgm._dilate(x), jgm._dilate(x))


# ------------------------------------------------------------------ clip index and windows
def test_clip_index_equal(corpus):
    _, paths = corpus
    for kw in (dict(clip_length=15, frames_between_clips=32),
               dict(clip_length=16, frames_between_clips=1, frame_rate=7.0)):
        want = jds.VideoClipIndex(paths, **kw)
        got = tds.VideoClipIndex(paths, **kw)
        assert (got.num_clips(), got.frames, got.fps) == (want.num_clips(), want.frames, want.fps)
        assert got.frames[2:] == [6, 0]  # the short and the corrupt video: no windows
        for i in (0, got.num_clips() - 1):
            fa, ia, va = got.get_clip(i)
            fb, ib, vb = want.get_clip(i)
            np.testing.assert_array_equal(fa, fb)
            assert (ia, va) == (ib, vb)


def test_clip_index_reads_the_jax_cache_without_probing(corpus, tmp_path, monkeypatch):
    _, paths = corpus
    cache = str(tmp_path / "clips.json")
    want = jds.VideoClipIndex(paths, 15, 32, cache_path=cache)
    monkeypatch.setattr(tvio, "probe_video",
                        lambda p: (_ for _ in ()).throw(RuntimeError("re-probed")))
    got = tds.VideoClipIndex(paths, 15, 32, cache_path=cache)
    assert (got.num_clips(), got.frames) == (want.num_clips(), want.frames)


def test_windowed_datasets_equal(corpus, tmp_path, pinned_rng):
    root, paths = corpus
    cap = tmp_path / "caps.json"
    cap.write_text(json.dumps({"a": "json caption A", "b": "json caption B"}))
    pairs = [
        (jds.panda_dataset(str(root), sample_size=16, sample_n_frames=14, cache_path=None),
         tds.panda_dataset(str(root), sample_size=16, sample_n_frames=14, cache_path=None)),
        (jds.msrvtt_dataset(str(root), str(cap), sample_size=(16, 12), cache_path=None),
         tds.msrvtt_dataset(str(root), str(cap), sample_size=(16, 12), cache_path=None)),
    ]
    for want, got in pairs:
        assert len(got) == len(want)
        for i in (0, len(got) - 1):
            _same(got[i], want[i])
    # an explicit generator of the same seed draws what the pinned factory draws
    got = tds.panda_dataset(str(root), sample_size=16, sample_n_frames=14, cache_path=None,
                            rng=_default_rng(SEED))
    _same(got[1], pairs[0][0][1])


def test_windowed_decode_retry_equal(corpus, pinned_rng, monkeypatch):
    """Two failed decodes, then another window drawn from the same generator."""
    _, paths = corpus
    out = []
    for mod in (jds, tds):
        ds = mod.WindowedClipDataset(paths, sample_size=16, sample_n_frames=14,
                                     frames_between_clips=32)
        calls, orig = [], mod.VideoClipIndex.get_clip

        def flaky(self, idx, calls=calls, orig=orig):
            calls.append(idx)
            if len(calls) < 3:
                raise ValueError("transient decode failure")
            return orig(self, idx)

        monkeypatch.setattr(mod.VideoClipIndex, "get_clip", flaky)
        out.append((ds[0], calls))
    _same(out[1][0], out[0][0])
    assert out[1][1] == out[0][1] and len(out[0][1]) == 3


# ------------------------------------------------------------------ indexed corpora
def test_webvid_csv_equal_with_the_retry(corpus, tmp_path, pinned_rng):
    root, _ = corpus
    path = tmp_path / "webvid.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["videoid", "page_dir", "name"])
        w.writeheader()
        w.writerow({"videoid": "a", "page_dir": "", "name": "clip a"})
        w.writerow({"videoid": "missing", "page_dir": "", "name": "gone"})  # -> next row
        w.writerow({"videoid": "b", "page_dir": "", "name": "clip b"})
    want = jds.WebVidCSV(str(path), str(root), sample_size=16, sample_n_frames=14)
    got = tds.WebVidCSV(str(path), str(root), sample_size=16, sample_n_frames=14)
    assert len(got) == len(want) == 3
    for i in range(3):
        _same(got[i], want[i])
    assert got[1]["caption"] == "clip b"


def test_json_video_dataset_equal(corpus, tmp_path, pinned_rng):
    root, _ = corpus
    path = tmp_path / "items.json"
    path.write_text(json.dumps([{"path": "a.mp4", "caption": "A"}, {"path": "b.mp4"}]))
    want = jds.JsonVideoDataset(str(path), str(root), sample_size=(12, 16), sample_n_frames=8)
    got = tds.CaptionedClipDataset(str(path), str(root), sample_size=(12, 16),
                                   sample_n_frames=8)
    for i in range(2):
        _same(got[i], want[i])


def test_mix_and_bucketed_loader_equal():
    a = [{"pixel_values": np.full((2, 3), i, np.float32), "caption": f"a{i}"} for i in range(5)]
    b = [{"pixel_values": np.full((4, 3), -i, np.float32), "caption": f"b{i}"} for i in range(3)]
    want, got = jds.MixDataset([a, b]), tds.MixDataset([a, b])
    assert len(got) == len(want) == 8
    for i in range(11):
        _same(got[i], want[i])
    jit, tit = iter(jds.BucketedLoader(want, 2, seed=4)), iter(tds.BucketedLoader(got, 2, seed=4))
    for _ in range(6):
        _same(next(tit), next(jit))


def test_read_gif_equals_imageio_and_pil(tmp_path, monkeypatch):
    """``load_input`` of a GIF: imageio's frames, and the same frames from PIL where
    imageio is not installed (the card's machine)."""
    import builtins

    frames = np.random.default_rng(0).random((5, 20, 24, 3)).astype(np.float32)
    path = str(tmp_path / "clip.gif")
    jvio.write_video(path, frames)
    want = jvio.load_input(path)
    np.testing.assert_array_equal(tvio.load_input(path), want)
    real = builtins.__import__

    def no_imageio(name, *args, **kw):
        if name.startswith("imageio"):
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    np.testing.assert_array_equal(tvio.load_input(path), want)
