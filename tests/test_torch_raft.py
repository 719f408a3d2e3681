"""RAFT in the port (``lkgd_torch.models.raft``) against ``lkgd_tpu.models.raft`` at fp32: the
correlation pyramid and its radius lookup alone, the tiny ``RAFTConfig.tiny()`` forward and
``raft_bidirectional_flow`` with the JAX params carried across by
``lkgd_torch.utils.porting.raft_state_dict`` and loaded strictly, and the full
``RAFTConfig()`` against the ``raft_large`` manifest (torchvision's names, shapes only).
Tolerance rtol 1e-4, atol 2e-4. Every parameter is random (``random_params``), the frozen
BatchNorm variances positive.

``random_params`` is shared with the other pseudo-label tests."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import raft as J  # noqa: E402

from lkgd_torch.models import raft as P  # noqa: E402
from lkgd_torch.utils import checkpoint_manifest as cm  # noqa: E402
from lkgd_torch.utils.porting import raft_state_dict  # noqa: E402
from tests.test_torch_porting import flatten, jit  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)
H, W = 32, 48


def close(got, want, err="", **tol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=err, **(tol or TOL))


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def random_params(shapes, seed: int):
    """A flax tree of random leaves shaped as ``shapes``: kernels normal / sqrt(fan-in),
    norm scales and LayerScales 1 + 0.1 x normal, BatchNorm variances 1 + 0.1 x |normal|,
    PReLU slopes 0.25 + 0.05 x normal, everything else 0.1 x normal (biases, means, cls
    tokens, position embeddings)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name in ("kernel", "tkernel"):
            value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("scale") or name.startswith("layer_scale"):
            value = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("_var"):
            value = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif name == "alpha":
            value = 0.25 + 0.05 * rng.standard_normal(shape)
        else:
            value = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tiny_pair(seed: int = 0):
    """(JAX params, jitted JAX apply, the port's model with them) of the tiny RAFT."""
    model = J.RAFT(J.RAFTConfig.tiny())
    img = jnp.zeros((1, H, W, 3))
    params = random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), img, img), seed)
    port = P.build_raft(P.RAFTConfig.tiny(), device="cpu")
    port.load_state_dict(raft_state_dict(flatten(params)), strict=True)
    return params, jit(model.apply), port


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


def test_correlation_pyramid_and_lookup():
    rng = np.random.default_rng(1)
    f1, f2 = (rng.standard_normal((2, 6, 8, 16)).astype(np.float32) for _ in range(2))
    want = [np.asarray(x) for x in J.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)]
    got = P.correlation_pyramid(t(f1), t(f2), 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (96, 6, 8, 1), (96, 3, 4, 1), (96, 1, 2, 1)]
    for level, (g, w) in enumerate(zip(got, want)):
        close(g, w, f"level {level}")
    # coordinates inside, on the border and outside the grid
    coords = (rng.uniform(-2.0, 10.0, size=(2, 6, 8, 2))).astype(np.float32)
    pyramid = [jnp.asarray(w) for w in want]
    want_lookup = np.asarray(J.lookup_correlation(pyramid, jnp.asarray(coords), 2))
    got_lookup = P.lookup_correlation([t(w) for w in want], t(coords), 2)
    assert tuple(got_lookup.shape) == want_lookup.shape == (2, 6, 8, 3 * 25)
    close(got_lookup, want_lookup)


def test_tiny_forward_and_bidirectional(tiny):
    params, apply, port = tiny
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(size=(2, H, W, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(apply(params, jnp.asarray(a * 2 - 1), jnp.asarray(b * 2 - 1)))
    with torch.no_grad():
        got = port(t(a * 2 - 1), t(b * 2 - 1))
    assert tuple(got.shape) == want.shape == (2, H, W, 2)
    assert np.abs(want).max() > 0.1  # the random model moves points
    close(got, want)

    model = J.RAFT(J.RAFTConfig.tiny())
    want_fwd, want_bwd = (np.asarray(x) for x in jax.jit(
        lambda p, x, y: J.raft_bidirectional_flow(p, model, x, y))(params, a[:1], b[:1]))
    with torch.no_grad():
        fwd, bwd = P.raft_bidirectional_flow(port, t(a[:1]), t(b[:1]))
    close(fwd, want_fwd, "forward")
    close(bwd, want_bwd, "backward")


def test_full_config_loads_the_raft_large_manifest_strictly():
    """``RAFTConfig()`` has torchvision's names and shapes: a state dict of the manifest's
    keys loads strictly (also with the BatchNorms' ``num_batches_tracked`` of a torchvision
    file, which are dropped), one key fewer does not, and the JAX full model's params
    carried across give the same keys and shapes."""
    manifest = cm.load_manifest("raft_large")
    with torch.device("meta"):
        model = P.RAFT(P.RAFTConfig())
    sd = cm.synthetic_state_dict(manifest)
    model.load_state_dict(sd, strict=True, assign=True)
    norms = {k.rsplit(".", 1)[0] for k in manifest if k.endswith("running_var")}
    assert len(norms) == 15  # stem, 12 in the residual blocks, 2 shortcuts
    with torch.device("meta"):
        model = P.RAFT(P.RAFTConfig())
    extra = {**sd, **{f"{n}.num_batches_tracked": torch.zeros((), dtype=torch.long)
                      for n in norms}}
    model.load_state_dict(extra, strict=True, assign=True)
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(dict(list(sd.items())[1:]), strict=True, assign=True)

    img = jnp.zeros((1, 64, 64, 3))
    # the iterations share their weights: one traces the same parameters as twelve
    shapes = jax.eval_shape(J.RAFT(J.RAFTConfig(iters=1)).init, jax.random.PRNGKey(0), img,
                            img)
    ported = raft_state_dict(flatten(jax.tree.map(
        lambda x: np.broadcast_to(np.float32(0), x.shape), shapes)))
    assert {k: tuple(v.shape) for k, v in ported.items()} == manifest
