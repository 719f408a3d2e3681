"""The port's quaternion linear and latent-knowledge fusion (``lkgd_torch.ops.quaternion`` /
``ops.fusion``) against ``lkgd_tpu`` at fp32 on the same weights: outputs and the
gradients of every parameter and input.

The JAX module computes its spectral branch with real DFT matmuls (``ops/real_fft.py``),
the port with ``torch.fft``: the same transforms summed in another order. Tolerance rtol
1e-4, atol 2e-4 on outputs and on gradients scaled by their largest entry, as the other
torch-oracle tests of the JAX package. A zero knowledge feature (an absent or fully masked
one) makes every bin of its spectrum exactly zero, where the guarded magnitude and phase
must keep the gradients finite and equal on both sides."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.ops import fusion as jfusion  # noqa: E402
from lkgd_tpu.ops import quaternion as jquat  # noqa: E402

from lkgd_torch.models.layers import materialize  # noqa: E402
from lkgd_torch.ops import fusion as tfusion  # noqa: E402
from lkgd_torch.ops import quaternion as tquat  # noqa: E402

from tests.test_torch_porting import flatten, port_state_dict, randomize  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-4)


def _assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert np.isfinite(g).all(), name
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g / scale, w / scale, err_msg=name, **TOL)


def _torch_grads(module, inputs, loss_fn):
    """Output and d(loss)/d(params, inputs) of the port module, as numpy by name."""
    ins = [torch.from_numpy(x).requires_grad_() if x is not None else None for x in inputs]
    out = module(*ins)
    loss_fn(out).backward()
    grads = {n: p.grad.numpy() for n, p in module.named_parameters()}
    grads.update({f"input{i}": x.grad.numpy() for i, x in enumerate(ins) if x is not None})
    return out.detach().numpy(), grads


def _jax_grads(jmod, params, inputs, loss_fn):
    """Output and gradients of the JAX module, by the port's parameter names."""
    idx = [i for i, x in enumerate(inputs) if x is not None]

    def f(p, *xs):
        args = list(inputs)
        for i, x in zip(idx, xs):
            args[i] = x
        out = jmod.apply(p, *args)
        return loss_fn(out), out

    xs = [jnp.asarray(inputs[i]) for i in idx]
    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, *range(1, len(xs) + 1)),
                                                 has_aux=True))(params, *xs)
    named = {k: v.numpy() for k, v in port_state_dict(grads[0]).items()}
    named.update({f"input{i}": np.asarray(g) for i, g in zip(idx, grads[1:])})
    return np.asarray(out), named


def _loss(out):
    return (out * out).sum() * 0.5 + out.sum()


def test_assemble_quaternion_kernel():
    rng = np.random.default_rng(0)
    factors = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(4)]
    want = np.asarray(jquat.assemble_quaternion_kernel(*map(jnp.asarray, factors)))
    got = tquat.assemble_quaternion_kernel(*map(torch.from_numpy, factors)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quaternion_linear_outputs_and_grads():
    x = np.random.default_rng(1).normal(size=(2, 3, 16)).astype(np.float32)
    jmod = jquat.QuaternionLinear(16, 8)
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=2)
    port = materialize(lambda: tquat.QuaternionLinear(16, 8), "cpu", torch.float32)
    port.load_state_dict(port_state_dict(params), strict=True)
    want_out, want = _jax_grads(jmod, params, [x], lambda o: _loss(o))
    got_out, got = _torch_grads(port, [x], _loss)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    _assert_grads_close(got, want)


def test_quaternion_init_is_seeded_and_scaled():
    a = tquat.quaternion_init(64, 32, torch.Generator().manual_seed(0))
    b = tquat.quaternion_init(64, 32, torch.Generator().manual_seed(0))
    for x, y in zip(a, b):
        assert x.shape == (16, 8) and torch.equal(x, y)
    modulus = torch.sqrt(sum(f * f for f in a))
    # chi(4) modulus times the glorot scale 1/sqrt(2 (16 + 8)): mean ~ 1.88 * 0.144
    assert 0.2 < modulus.mean().item() < 0.35


@pytest.mark.parametrize("case", ["features", "zero_flow", "absent", "cfg_doubled"])
def test_knowledge_fusion_outputs_and_grads(case):
    rng = np.random.default_rng(3)
    b = 2
    ctx = rng.normal(size=(b, 1, 64)).astype(np.float32)
    domain = rng.normal(size=(b, 1, 48)).astype(np.float32)
    flow = rng.normal(size=(b, 1, 48)).astype(np.float32)
    if case == "zero_flow":
        flow = np.zeros_like(flow)  # every rFFT bin of the compressed flow is exactly 0
    elif case == "absent":
        domain = flow = None
    elif case == "cfg_doubled":  # a CFG-doubled context, knowledge of one side
        domain, flow = domain[:1], flow[:1]
    jmod = jfusion.LatentKnowledgeFusion(ctx_dim=64)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(ctx),
                            None if domain is None else jnp.asarray(domain),
                            None if flow is None else jnp.asarray(flow))
    params = randomize(shapes, seed=4)  # texts* non-zero: their paths are exercised
    assert np.abs(flatten(params)["params/texts_fft_pha"]).min() > 0
    port = materialize(lambda: tfusion.LatentKnowledgeFusion(ctx_dim=64), "cpu", torch.float32)
    port.load_state_dict(port_state_dict(params), strict=True)
    inputs = [ctx, domain, flow]
    want_out, want = _jax_grads(jmod, params, inputs, _loss)
    got_out, got = _torch_grads(port, inputs, _loss)
    assert got_out.shape == ctx.shape
    np.testing.assert_allclose(got_out, want_out, **TOL)
    _assert_grads_close(got, want)


def test_interpolate_linear_1d_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 1, 1000)).astype(np.float32)
    want = np.asarray(jfusion.interpolate_linear_1d(jnp.asarray(x), 1024))
    got = tfusion.interpolate_linear_1d(torch.from_numpy(x), 1024).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    torch_ref = torch.nn.functional.interpolate(torch.from_numpy(x), size=1024, mode="linear",
                                                align_corners=False).numpy()
    np.testing.assert_allclose(got, torch_ref, rtol=1e-5, atol=1e-5)
