"""RIFE in the port (``lkgd_torch.models.rife``) against ``lkgd_tpu.models.rife`` at fp32, with
a narrow IFNet (``c=16``, scales (4, 2, 1)) whose JAX params are carried across by
``lkgd_torch.utils.porting.rife_state_dict`` and loaded strictly: the midpoint of two
frames; ``interpolate_video`` at ``exp=1`` and ``exp=2`` with the host dedup of
near-duplicate pairs, on 30 x 40 frames that ``pad_to_multiple`` pads to 32 x 64; the
port's state dict read back by the JAX package's ``port_rife`` as a ``flownet.pkl``.
Tolerance rtol 1e-4, atol 2e-4."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.models import rife as J  # noqa: E402
from lkgd_tpu.utils.porting import port_rife  # noqa: E402

from lkgd_torch.models import rife as P  # noqa: E402
from lkgd_torch.utils.porting import rife_state_dict  # noqa: E402
from tests.test_torch_porting import flatten  # noqa: E402
from tests.test_torch_raft import close, random_params  # noqa: E402

C = 16


@pytest.fixture(scope="module")
def pair():
    model = J.IFNet(J.RIFEConfig(c=C))
    img = jnp.zeros((1, 32, 64, 3))
    params = random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0), img, img), 3)
    port = P.build_rife(P.RIFEConfig(c=C), device="cpu")
    port.load_state_dict(rife_state_dict(flatten(params)), strict=True)
    return model, params, port


def test_midpoint(pair):
    model, params, port = pair
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(size=(2, 32, 64, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == want.shape == (2, 32, 64, 3)
    close(got, want)


@pytest.mark.parametrize("exp", [1, 2])
def test_interpolate_video_padded_with_dedup(pair, exp):
    model, params, port = pair
    rng = np.random.default_rng(exp)
    frames = rng.uniform(size=(4, 30, 40, 3)).astype(np.float32)
    frames[2] = frames[1] + 1e-3  # a near-duplicate pair: its in-betweens are copies
    want = np.asarray(J.interpolate_video(model, params, jnp.asarray(frames), exp=exp,
                                          dedup_threshold=0.01))
    got = P.interpolate_video(port, torch.from_numpy(frames), exp=exp, dedup_threshold=0.01)
    n = 2 ** exp * 3 + 1
    assert tuple(got.shape) == want.shape == (n, 30, 40, 3)
    close(got, want)
    step = 2 ** exp
    for k in range(step + 1, 2 * step):
        np.testing.assert_array_equal(got[k].numpy(), got[step].numpy())
    np.testing.assert_array_equal(got[::step].numpy(), frames)


def test_names_are_the_flownet_checkpoints(pair):
    """The port's state dict, under ``flownet.pkl``'s ``module.`` prefix and with the
    training-only teacher beside it, is read back by the JAX package's ``port_rife``
    (strict) to the JAX params it came from: the port's names and layouts are the
    checkpoint's (the ConvTranspose2d weights (in, out, kh, kw))."""
    model, params, port = pair
    sd = {f"module.{k}": v.numpy() for k, v in port.state_dict().items()}
    sd["module.block_tea.conv0.0.0.weight"] = np.zeros((1,), np.float32)
    back = flatten(port_rife(sd, params))
    want = flatten(params)
    assert sorted(back) == sorted(want)
    for name, x in want.items():
        np.testing.assert_array_equal(back[name], x, err_msg=name)
    assert tuple(port.state_dict()["block0.conv1.0.weight"].shape) == (C, C // 2, 4, 4)
