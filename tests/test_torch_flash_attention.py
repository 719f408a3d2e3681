"""The port's flash attention (``lkgd_torch.ops.flash_attention``) against the Pallas
kernels of ``lkgd_tpu.ops.flash_attention`` run in TPU interpret mode on the CPU, as
``tests/test_flash_attention.py`` runs them. On the CPU the port runs the plain versions
of its kernels; the CUDA kernels themselves are held against those plain versions in
``tests/test_torch_kernels_cuda.py`` on the card.

Tolerances: fp32 on both sides, the same exp2-domain arithmetic, summed in another order
(rtol 1e-5, atol 1e-5; 2e-5 where the Pallas wrapper pads and masks)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lkgd_tpu.ops import flash_attention as jfa  # noqa: E402
from lkgd_tpu.ops.attention import _xla_attention  # noqa: E402

from lkgd_torch.models.layers import Attention, init_params, materialize  # noqa: E402
from lkgd_torch.ops import attention as tattn  # noqa: E402
from lkgd_torch.ops import flash_attention as tfa  # noqa: E402


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=shape) * scale).astype(np.float32)
    k = (rng.normal(size=shape) * scale).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return q, k, v


def _bhsd(x: np.ndarray) -> jnp.ndarray:
    """(B, S, H, D) -> the Pallas kernels' (B*H, S, D) operand layout."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _port(fn, q, k, v) -> np.ndarray:
    out = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    b, s, h, d = out.shape
    return out.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("d", [64, 256])
def test_bound_plain_matches_pallas_bound_kernel(d):
    q, k, v = _qkv(0, (1, 256, 2, d))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), 128, 128))
    got = _port(tfa.flash_attention_bound_plain, q, k, v)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [64, 256])
def test_maxtrack_plain_matches_pallas_maxtrack_kernel(d):
    q, k, v = _qkv(1, (1, 256, 2, d))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash_maxtrack_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), 128, 128,
                                                   None))
    got = _port(tfa.flash_attention_maxtrack_plain, q, k, v)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plain", [tfa.flash_attention_bound_plain,
                                   tfa.flash_attention_maxtrack_plain])
def test_ragged_sequence_matches_padded_pallas(plain):
    """S=300 tiles no block: the Pallas wrapper pads and masks keys; the port's kernels
    mask the edge themselves and their plain versions never pad."""
    q, k, v = _qkv(2, (1, 300, 2, 32))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_underflow_fallback_matches_pallas():
    """The input of test_bound_kernel_underflow_fallback_interpret: the bound is too loose
    for fp32, and the guard must give the max-tracking result, not NaNs."""
    rng = np.random.default_rng(4)
    shape = (1, 256, 2, 32)
    q = (rng.normal(size=shape) * 60.0).astype(np.float32)
    k = (rng.normal(size=shape) * 60.0).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa._flash_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), 128, 128))
    got = _port(tfa.flash_attention_bound_plain, q, k, v)
    assert not np.isnan(got).any()
    # logits here reach ~2e4, where one fp32 ulp of a logit summed in another order moves
    # its softmax weight by ~1e-3 relative: the tolerance follows the input's scale
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_bound_t_matches_pallas_wrapper():
    q, k, _ = _qkv(3, (2, 64, 3, 16))
    want = np.asarray(jfa._bound_t(_bhsd(q), _bhsd(k), 16 ** -0.5))[:, 0]  # (B*H, S)
    got = tfa.bound_t(torch.from_numpy(q), torch.from_numpy(k)).reshape(6, 64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,masked,flash", [(1024, False, True), (1023, False, False),
                                            (1024, True, False)])
def test_dispatch_routes_long_sequences_to_flash(monkeypatch, s, masked, flash):
    """At S >= 1024 without a mask the dispatch goes through the flash kernel's plain
    version on the CPU; shorter or masked, through the plain matmul-softmax. All match the
    JAX _xla_attention."""
    calls = []
    real = tfa.flash_attention_bound_plain
    monkeypatch.setattr(tfa, "flash_attention_bound_plain",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = _qkv(4, (1, s, 1, 16))
    mask = (np.random.default_rng(5).uniform(size=(1, 1, s, s)) > 0.3) if masked else None
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask)).numpy()
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     None if mask is None else jnp.asarray(mask)))
    assert len(calls) == (1 if flash else 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_hands_projection_views_to_flash(monkeypatch):
    """Attention passes (B, S, H, D) views of its projections, never relayout copies."""
    import lkgd_torch.models.layers as layers

    seen = {}

    def record(q, k, v, mask=None):
        seen.update(q=q, k=k, v=v)
        return tattn.dot_product_attention(q, k, v, mask)

    monkeypatch.setattr(layers, "dot_product_attention", record)
    attn = materialize(lambda: Attention(32, heads=2, dim_head=16), "cpu", torch.float32)
    init_params(attn, torch.Generator().manual_seed(0))
    with torch.no_grad():
        attn(torch.randn(1, 1024, 32, generator=torch.Generator().manual_seed(0)))
    for name in ("q", "k", "v"):
        x = seen[name]
        assert x._base is not None and x.shape == (1, 1024, 2, 16)
        assert x.stride() == (1024 * 32, 32, 16, 1), name
