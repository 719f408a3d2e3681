"""The fp32 form of the flash forward (``csrc/flash_attention_f32.cu``) on the CPU: its
arithmetic and its tiling. The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 3f).

The kernel multiplies fp32 operands as 3xTF32: each x is split into hi = x rounded to tf32
(``cvt.rna``) and lo = x - hi, and a product is lo.hi + hi.lo + hi.hi on the TF32 tensor
cores, whose accumulator truncates each sum (round toward zero). A test-local emulation of
that arithmetic, with the kernel's accumulation structure (hi.hi and the two small
products in separate accumulators, S's depth halves summed apart at D=512, P.V of each
64-key tile in a fresh accumulator added to O in fp32), is held against the JAX package's
fp32 forward run in TPU interpret mode, as ``tests/test_flash_attention.py`` runs it,
within 2e-5 of max|ref|: ``chip_smoke.py``'s FP32_TOL for the kernel against the plain fp32
version. One TF32 product in the place of three misses that by two orders of magnitude.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lkgd_tpu.ops import flash_attention as jfa  # noqa: E402

from lkgd_torch.ops import flash_attention as tfa  # noqa: E402

FP32_TOL = 2e-5  # of max|ref|, as chip_smoke.py holds the kernel against the plain version
LOG2E = 1.4426950408889634


def _rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 rounded to nearest, ties away from zero (``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 word: its upper 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _rna(x)
    return hi, _tf32(x - hi)


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 cut to fp32's 24 significant bits toward zero in place, as the tensor core's
    accumulator rounds (the value stays float64, exactly an fp32)."""
    x.view(torch.int64).bitwise_and_(-(1 << 29))
    return x


def _mma(acc, a, b, k0):
    """acc + a[:, k0:k0+8] @ b[k0:k0+8] (float64 holding tf32 and fp32 values), one
    m64nNk8 step: exact products, one truncation."""
    return _rz(torch.addmm(acc, a[:, k0:k0 + 8], b[k0:k0 + 8]))


def _scores(q, k, one_product):
    """S = Q.K^T (rows x keys) as the kernel sums it: per depth half at D=512."""
    d = q.shape[1]
    qh, ql = (x.double() for x in _split(q))
    kh, kl = (x.t().double().contiguous() for x in _split(k))
    if one_product:
        qh, kh = _tf32(q).double(), _tf32(k).t().double().contiguous()
    halves = 2 if d > 256 else 1
    total = None
    for part in range(halves):
        big = torch.zeros(q.shape[0], k.shape[0], dtype=torch.float64)
        small = torch.zeros_like(big)
        for k0 in range(part * d // halves, (part + 1) * d // halves, 8):
            if not one_product:
                small = _mma(_mma(small, ql, kh, k0), qh, kl, k0)
            big = _mma(big, qh, kh, k0)
        s = big.float() + small.float()
        total = s if total is None else total + s
    return total


def _emulate_head(q, k, v, bound, one_product=False):
    """The kernel's arithmetic on one (batch, head): q (S_q, D), k, v (S_k, D) fp32, D a
    multiple of 8 padded with zeros to the kernel's tile width."""
    s_q, d = q.shape
    s_k = k.shape[0]
    dp = 64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256 else 512
    q, k, v = (torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v))
    scale2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    s = _scores(q, k, one_product)
    if bound:
        t = -(torch.sqrt((q * q).sum(1)) * torch.sqrt((k * k).sum(1).max())) * scale2
    o = torch.zeros(s_q, dp)
    l = torch.zeros(s_q)
    m = torch.full((s_q,), -math.inf)
    for k0 in range(0, s_k, 64):
        st = s[:, k0:k0 + 64]
        if bound:
            alpha, shift = torch.ones(s_q), t
        else:
            m_new = torch.maximum(m, st.max(1).values * scale2)
            alpha, shift = torch.exp2(m - m_new), -m_new
            m = m_new
        p = torch.exp2(st * scale2 + shift[:, None])
        l = l * alpha + p.sum(1)
        vt = v[k0:k0 + 64]
        acc = torch.zeros(s_q, dp, dtype=torch.float64)
        ph, pl = (x.double() for x in _split(p))
        vh, vl = (x.double() for x in _split(vt))
        if one_product:
            ph, vh = _tf32(p).double(), _tf32(vt).double()
        for j in range(0, vt.shape[0], 8):
            if not one_product:
                acc = _mma(_mma(acc, pl, vh, j), ph, vl, j)
            acc = _mma(acc, ph, vh, j)
        o = o * alpha[:, None] + acc.float()
    return (o / l[:, None])[:, :d], l


def emulate(q, k, v, bound, one_product=False):
    """(B, S, H, D) fp32 numpy -> the kernel's output; the bound form with its guard: a
    query tile (128 rows at D <= 128, else 64) whose smallest row sum is not > 2^-110 takes
    the max-tracking result."""
    out = np.empty_like(q)
    rows = 128 if q.shape[3] <= 128 else 64
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            qh, kh, vh = (torch.from_numpy(x[b, :, h].copy()) for x in (q, k, v))
            o, l = _emulate_head(qh, kh, vh, bound, one_product)
            if bound:
                bad = ~(l > tfa.GUARD)
                if bad.any():
                    fallback, _ = _emulate_head(qh, kh, vh, False, one_product)
                    for r0 in range(0, len(l), rows):
                        if bad[r0:r0 + rows].any():
                            o[r0:r0 + rows] = fallback[r0:r0 + rows]
            out[b, :, h] = o.numpy()
    return out


def _jax_forward(q, k, v, bound):
    """The JAX package's fp32 forward, Pallas kernels 1 (with its guard) or 2, in TPU
    interpret mode; sequences padded to a block multiple as ``flash_attention`` pads them."""
    b, s, h, d = q.shape
    bq, bk, sq_p, sk_p = jfa._plan_blocks(s, s, d)
    pad = ((0, 0), (0, sq_p - s), (0, 0), (0, 0))
    qt, kt, vt = (jnp.asarray(np.pad(x, pad).transpose(0, 2, 1, 3).reshape(b * h, sq_p, d))
                  for x in (q, k, v))
    valid = s if sk_p != s else None
    with pltpu.force_tpu_interpret_mode():
        if bound:
            out = jfa._flash_bhsd(qt, kt, vt, bq, bk, valid)
        else:
            out = jfa._flash_maxtrack_bhsd(qt, kt, vt, bq, bk, valid)
    return np.asarray(out).reshape(b, h, sq_p, d)[:, :, :s].transpose(0, 2, 1, 3)


def _qkv(shape, scale):
    rng = np.random.default_rng(17)
    return tuple((rng.normal(size=shape) * (scale if i < 2 else 1.0)).astype(np.float32)
                 for i in range(3))


# the fp32 UNet's head dim, the precompute encoder's mid block at 1024 tokens, and the
# guard input: norms x3 at D=512, where every row underflows the bound
CASES = [((1, 1024, 1, 64), 1.0), ((1, 1024, 1, 512), 1.0), ((1, 1100, 1, 512), 3.0)]


@pytest.mark.parametrize("bound", [True, False], ids=["flash_bound", "flash_maxtrack"])
@pytest.mark.parametrize("shape,scale", CASES, ids=["d64", "d512", "guard"])
def test_split_arithmetic_matches_jax_fp32_forward(monkeypatch, shape, scale, bound):
    monkeypatch.delenv("LKGD_FLASH_MAXTRACK", raising=False)
    q, k, v = _qkv(shape, scale)
    want = _jax_forward(q, k, v, bound)
    got = emulate(q, k, v, bound)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FP32_TOL, err


def test_one_tf32_product_misses_the_tolerance():
    """The emulation is not fp32 in disguise: with one TF32 product in the place of three
    (and the same accumulation) it lands two orders of magnitude outside FP32_TOL."""
    q, k, v = _qkv((1, 1024, 1, 64), 1.0)
    want = tfa.flash_attention_maxtrack_plain(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    got = emulate(q, k, v, bound=False, one_product=True)
    assert np.abs(got - want).max() / np.abs(want).max() > 50 * FP32_TOL


@pytest.mark.parametrize("d", [8, 40, 64, 128, 256, 512])
def test_flash_fp32_plan_by_head_dim(d):
    """The fp32 form's tiling (``Plan`` in ``csrc/flash_attention_f32.cu``): 64-key tiles,
    128 query rows a block at D <= 128 (Q's hi and lo resident), 64 above (D = 512: Q
    streamed and 64 KB for the exchanged halves of S), and a ring of 16 KB units filling
    the rest of the 227 KB a block may use."""
    plan = tfa.flash_plan(2, 1100, 1333, 3, d, fp32=True)
    dp = next(w for w in (64, 128, 256, 512) if d <= w)
    rows = 128 if dp <= 128 else 64
    assert plan.kernel == "tf32x3" and plan.key_tile == 64 and plan.tile_rows == rows
    assert plan.blocks == 2 * 3 * -(-1100 // rows) and plan.waves == plan.blocks / 132
    resident = 0 if dp == 512 else rows * dp * 4 * 2
    exchange = 4 * 64 * 64 * 4 if dp == 512 else 0
    assert plan.smem_bytes <= tfa.SMEM_LIMIT == 232_448
    assert plan.smem_bytes >= resident + exchange + plan.stages * tfa.F32_UNIT
    assert tfa.SMEM_LIMIT - plan.smem_bytes < tfa.F32_UNIT  # no room for another slot
    assert plan.stages >= 6
