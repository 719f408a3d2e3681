"""Track fusion and the point-track helpers of the port against ``lkgd_tpu``:

* ``lkgd_torch.ops.track_fusion``: ``quantize_tracks`` (truncation toward zero, negative
  and past-the-edge coordinates clamped, a fractional downsample), ``_scatter_mean`` with
  repeated indices and invisible tracks, and ``track_scatter_fusion`` with a random 3x3
  ``conv_fuse`` through the port's ``ZeroInitConv2d``, at rtol 1e-5, atol 1e-5 (fp32 sums
  in another order);
* ``lkgd_torch.utils.track_helpers``, the port's numpy copy, equal to the JAX package's:
  ``grid_queries``, ``filter_tracks_by_distance``, ``draw_points``, ``draw_tracks`` and
  ``TrackDataset`` (its video decoder and its unseeded frame draw replaced by the same
  stand-ins in both packages)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.ops import track_fusion as jtf  # noqa: E402
from lkgd_tpu.utils import track_helpers as jth  # noqa: E402

from lkgd_torch.models.layers import ZeroInitConv2d  # noqa: E402
from lkgd_torch.ops import track_fusion as ttf  # noqa: E402
from lkgd_torch.utils import track_helpers as tth  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("downsample", [8.0, 2.5])
def test_quantize_tracks_matches_jax(downsample):
    rng = np.random.default_rng(0)
    src = rng.uniform(-20, 90, (2, 30, 2)).astype(np.float32)
    dst = rng.uniform(-5, 70, (2, 30, 2)).astype(np.float32)
    src[0, 0] = (-3.9, -0.1)  # truncation toward zero gives 0, not -1
    want = jtf.quantize_tracks(jnp.asarray(src), jnp.asarray(dst), 4, 8, downsample)
    got = ttf.quantize_tracks(torch.from_numpy(src), torch.from_numpy(dst), 4, 8, downsample)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scatter_mean_matches_jax():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(3, 10, 5)).astype(np.float32)
    idx = rng.integers(0, 6, (3, 10))
    idx[:, :3] = 2  # repeated targets
    vis = (rng.random((3, 10)) > 0.3).astype(np.float32)
    want = jax.vmap(jtf._scatter_mean, in_axes=(0, 0, 0, None))(
        jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(vis), 6)
    got = ttf._scatter_mean(torch.from_numpy(vals), torch.from_numpy(idx), torch.from_numpy(vis),
                            6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_track_scatter_fusion_matches_jax():
    rng = np.random.default_rng(2)
    b, fh, fw, c, nt = 2, 4, 6, 8, 10
    hidden = rng.normal(size=(2 * b, fh * fw, c)).astype(np.float32)
    src_idx = rng.integers(0, fh * fw, (b, nt))
    dst_idx = rng.integers(0, fh * fw, (b, nt))
    vis = (rng.random((b, nt)) > 0.3).astype(np.float32)
    conv = ZeroInitConv2d(2 * c, 2 * c, 3, padding=1)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(3))
        conv.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(4))
    kernel = jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0))  # OIHW -> HWIO
    bias = jnp.asarray(conv.bias.detach().numpy())

    def jconv(x):
        return jax.lax.conv_general_dilated(x, kernel, (1, 1), [(1, 1), (1, 1)],
                                            dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias

    want = jtf.track_scatter_fusion(jnp.asarray(hidden), jnp.asarray(src_idx),
                                    jnp.asarray(dst_idx), jnp.asarray(vis), jconv, fh, fw)
    with torch.no_grad():
        got = ttf.track_scatter_fusion(torch.from_numpy(hidden), torch.from_numpy(src_idx),
                                       torch.from_numpy(dst_idx), torch.from_numpy(vis), conv,
                                       fh, fw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.allclose(got.numpy(), hidden)


def test_track_helpers_match_jax():
    np.testing.assert_array_equal(tth.grid_queries(5, 48, 64, t=3),
                                  jth.grid_queries(5, 48, 64, t=3))
    rng = np.random.default_rng(5)
    tracks = rng.uniform(0, 40, (4, 12, 2)).astype(np.float32)
    vis = rng.random((4, 12)) > 0.2
    for v in (None, vis):
        np.testing.assert_array_equal(tth.filter_tracks_by_distance(tracks, v, 10.0),
                                      jth.filter_tracks_by_distance(tracks, v, 10.0))
    np.testing.assert_array_equal(tth.draw_points(24, 32, tracks[0, :5]),
                                  jth.draw_points(24, 32, tracks[0, :5]))
    np.testing.assert_array_equal(tth.draw_tracks(40, 40, tracks[[0, -1], :6]),
                                  jth.draw_tracks(40, 40, tracks[[0, -1], :6]))


def test_track_dataset_matches_jax(tmp_path, monkeypatch):
    """The same items from both packages' ``TrackDataset`` on one video with tracks and one
    without: the decoder returns the same synthetic frames in both, and the unseeded frame
    draw is seeded alike."""
    from lkgd_tpu.data import video_io as jio

    from lkgd_torch.data import video_io as tio

    videos, annotations = tmp_path / "videos", tmp_path / "tracks"
    videos.mkdir()
    annotations.mkdir()
    for name in ("a", "b"):
        (videos / f"{name}.mp4").write_bytes(b"")
    rng = np.random.default_rng(6)
    frames = rng.uniform(size=(12, 40, 56, 3)).astype(np.float32)
    np.savez(annotations / "a.npz", tracks=rng.uniform(0, 50, (12, 9, 2)).astype(np.float32))
    def decode(path, max_frames=None):
        return frames, 8.0

    for module in (jio, tio):
        monkeypatch.setattr(module, "read_video_frames", decode)
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(11 if seed is None else seed))
    items = [ds[i] for ds in (jth.TrackDataset(str(videos), str(annotations), 32),
                              tth.TrackDataset(str(videos), str(annotations), 32))
             for i in range(2)]
    for want, got in zip(items[:2], items[2:]):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert items[0]["point_map"][..., 3].max() > 0 and items[1]["point_map"].max() == 0
