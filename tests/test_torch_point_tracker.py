"""The chained-flow point tracker in the port (``lkgd_torch.utils.point_tracker``) against
``lkgd_tpu.utils.point_tracker``: ``grid_queries`` bit for bit; the tracker with the same
exact synthetic flows injected through ``flow_fn`` (a smooth non-uniform field whose
backward half is not its inverse, so that the cycle test marks some points invisible, and
points that leave the frame), at a size padded to a multiple of 8; then with the tiny RAFT
of ``tests/test_torch_raft.py`` (the JAX params carried across), also at a padded size.
Tracks at rtol 1e-4, atol 2e-4 px (1e-5 px with the exact flows); visibility equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import raft as jax_raft  # noqa: E402
from lkgd_tpu.utils import point_tracker as J  # noqa: E402

from lkgd_torch.utils import point_tracker as P  # noqa: E402
from tests.test_torch_raft import close, tiny_pair  # noqa: E402


@pytest.mark.parametrize("h,w,grid,margin", [(64, 128, 4, None), (30, 44, (3, 5), None),
                                             (576, 1024, 16, None), (33, 47, 7, 2.5)])
def test_grid_queries_bit_equal(h, w, grid, margin):
    got, want = P.grid_queries(h, w, grid, margin), J.grid_queries(h, w, grid, margin)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _field(h: int, w: int):
    """A smooth forward field and a backward field that undoes it only near the top."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    fwd = np.stack([1.5 + 2.0 * np.sin(yy / 5.0), 0.8 * np.cos(xx / 7.0)], -1)
    bwd = -fwd * (1.0 + yy[..., None] / h * 3.0)
    return fwd.astype(np.float32), bwd.astype(np.float32)


def test_tracker_with_exact_flows_at_a_padded_size():
    t, h, w = 6, 30, 44  # padded to 32 x 48 for the flow
    fwd, bwd = _field(32, 48)
    frames = np.random.default_rng(0).uniform(size=(t, h, w, 3)).astype(np.float32)
    queries = np.concatenate([J.grid_queries(h, w, 5), [[42.5, 3.0], [0.2, 28.9]]])
    queries = queries.astype(np.float32)
    seen = []

    def jax_flow(f1, f2):
        seen.append(f1.shape)
        return jnp.asarray(fwd)[None], jnp.asarray(bwd)[None]

    want_tracks, want_vis = (np.asarray(x) for x in J.make_track_fn(None, None, flow_fn=jax_flow)(
        jnp.asarray(frames), jnp.asarray(queries)))
    got_tracks, got_vis = P.make_track_fn(flow_fn=lambda f1, f2: (
        torch.from_numpy(fwd)[None], torch.from_numpy(bwd)[None]))(
        torch.from_numpy(frames), torch.from_numpy(queries))
    assert seen[0] == (1, 32, 48, 3)
    assert tuple(got_tracks.shape) == want_tracks.shape == (t, len(queries), 2)
    assert got_vis.dtype == torch.bool and tuple(got_vis.shape) == want_vis.shape
    close(got_tracks, want_tracks, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_vis.numpy(), want_vis)
    assert want_vis[0].all() and 0 < want_vis[1:].mean() < 1  # both outcomes occur


def test_tracker_with_tiny_raft_at_a_padded_size():
    h, w = 30, 44  # padded to 32 x 48 for RAFT
    params, _, port = tiny_pair()
    model = jax_raft.RAFT(jax_raft.RAFTConfig.tiny())
    rng = np.random.default_rng(1)
    base = rng.uniform(size=(h + 4, w + 4, 3)).astype(np.float32)
    frames = np.stack([base[i:i + h, i:i + w] for i in range(3)])  # a diagonal drift
    queries = J.grid_queries(h, w, 4)
    want_tracks, want_vis = (np.asarray(x) for x in J.make_track_fn(model, params, 2.0)(
        jnp.asarray(frames), jnp.asarray(queries)))
    got_tracks, got_vis = P.make_track_fn(port, 2.0)(torch.from_numpy(frames),
                                                     torch.from_numpy(queries))
    close(got_tracks, want_tracks)
    np.testing.assert_array_equal(got_vis.numpy(), want_vis)
    tracks, vis = P.track_video(port, frames, grid_size=4)
    np.testing.assert_array_equal(tracks, got_tracks.numpy())
    np.testing.assert_array_equal(vis, got_vis.numpy())
