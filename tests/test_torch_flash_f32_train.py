"""The fp32 training kernels (7-10 on fp32 operands) on the CPU: the arithmetic and tiling of
the fp32 backward, and the training CLI's precision flag. The kernels themselves run only on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phases 3i, 7d, 8o).

At every head dim the fp32 backward (``csrc/flash_attention_bwd_f32.cu``) multiplies as
3xTF32 on the tensor cores, as the fp32 forward does (``tests/test_torch_flash_f32.py``): each
operand split into a tf32 hi and an fp32 lo, lo.hi + hi.lo + hi.hi, each k8 step's sum
truncated by the accumulator. So the arithmetic can go wrong, not only the tile loop. A
test-local emulation of the kernels' arithmetic and accumulation structure (S and dP, or S^T
and dP^T, with hi.hi and the small products in two accumulators, hi.hi restarting every 128
of D into an fp32 sum (the wide kernels' fold; one accumulator to D = 128); P and dS split
after they are formed; each 64-row tile's dQ, dK, dV in a fresh accumulator added to fp32
sums; keys past S_k with P = 0 in dq, queries past S_q with lse = +inf and delta = 0 in dk/dv)
is held against the JAX package's fp32 backward run in TPU interpret mode within 1e-4 of each
gradient's max|ref|: ``chip_smoke.py``'s FP32_GRAD_TOL for the kernels against their plain
fp32 versions. One TF32 product in the place of three misses it. The narrow kernels (D <= 64)
and the wide ones (above, 64 resident rows) share that arithmetic; where they differ (how a
block splits its rows and columns) changes no sum. The forward's LSE form is the fp32 forward
of ``tests/test_torch_flash_f32.py`` with one more store a row; its plan is that forward's.
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
from tests.test_torch_flash_f32 import _mma, _split, _tf32  # noqa: E402

FP32_GRAD_TOL = 1e-4  # of each gradient's max|ref|, as chip_smoke.py holds the kernels
LOG2E = 1.4426950408889634
FOLD = 128  # depth a hi.hi accumulator sums before the wide kernels add it in fp32


def _padded(x: np.ndarray, s_pad: int) -> jnp.ndarray:
    """(B, S, H, D) -> the Pallas kernels' (B*H, S_pad, D), zero rows past S."""
    b, s, h, d = x.shape
    x = np.pad(x, ((0, 0), (0, s_pad - s), (0, 0), (0, 0)))
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s_pad, d))


def _unpadded(x, b: int, h: int, s: int) -> torch.Tensor:
    """The Pallas kernels' (B*H, S_pad, D) -> the port's (B, S, H, D)."""
    x = np.asarray(x)
    return torch.from_numpy(x.reshape(b, h, -1, x.shape[-1])[:, :, :s].transpose(0, 2, 1, 3)
                            .copy())


def _jax_backward(q, k, v, do):
    """lse and delta of the JAX fp32 forward (max-tracking kernel 8, the guard's values) and
    its kernels 9 and 10, in interpret mode on 128-row blocks (keys past S_k masked)."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    q_pad, k_pad = -(-s_q // 128) * 128, -(-s_k // 128) * 128
    valid = s_k if k_pad != s_k else None
    qt, dot = (_padded(x, q_pad) for x in (q, do))
    kt, vt = (_padded(x, k_pad) for x in (k, v))
    with pltpu.force_tpu_interpret_mode():
        out, lse = jfa._flash_fwd_lse_maxtrack_bhsd(qt, kt, vt, 128, 128, valid)
        delta = jnp.sum(dot * out, axis=-1)[:, None, :]
        grads = jfa._flash_bwd_bhsd(qt, kt, vt, dot, lse, delta, 128, 128, valid)
    rows = [torch.from_numpy(np.asarray(x)[:, 0, :s_q].reshape(b, h, s_q).copy())
            for x in (lse, delta)]
    return (*rows, _unpadded(grads[0], b, h, s_q), _unpadded(grads[1], b, h, s_k),
            _unpadded(grads[2], b, h, s_k))


def _one_tf32(x: torch.Tensor):
    """One TF32 product in the place of three: the tensor core's reading of x, no lo."""
    return _tf32(x), torch.zeros_like(x)


def _three(acc, a, b, k0):
    """acc (+)= A . B over one k8 step as the kernels' products into one accumulator: lo.hi,
    hi.lo, hi.hi, each sum truncated. a, b: (hi, lo) pairs in float64."""
    return _mma(_mma(_mma(acc, a[1], b[0], k0), a[0], b[1], k0), a[0], b[0], k0)


def _scores(a, b):
    """(M, DP) . (DP, N) as S and dP are summed: lo.hi + hi.lo in one accumulator over the
    depth's k8 steps, hi.hi in another that restarts every FOLD of the depth into an fp32
    sum; the two added in fp32."""
    small = torch.zeros(a[0].shape[0], b[0].shape[1], dtype=torch.float64)
    total = None
    for g0 in range(0, a[0].shape[1], FOLD):
        big = torch.zeros_like(small)
        for k0 in range(g0, min(g0 + FOLD, a[0].shape[1]), 8):
            small = _mma(_mma(small, a[1], b[0], k0), a[0], b[1], k0)
            big = _mma(big, a[0], b[0], k0)
        total = big.float() if total is None else total + big.float()
    return total + small.float()


def _tf32_head(q, k, v, do, lse, delta, split):
    """Both tf32 kernels on one (batch, head): q, dO (S_q, D), k, v (S_k, D), lse and delta
    (S_q,), zero-padded as the pre-pass and TMA give them (D to 64, 128, 256 or 512,
    sequences to 64-row tiles)."""
    s_q, d = q.shape
    s_k = k.shape[0]
    dp = 64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256 else 512
    qp, kp = -(-s_q // 64) * 64, -(-s_k // 64) * 64
    q, do = (torch.nn.functional.pad(x, (0, dp - d, 0, qp - s_q)) for x in (q, do))
    k, v = (torch.nn.functional.pad(x, (0, dp - d, 0, kp - s_k)) for x in (k, v))
    lse = torch.cat([lse, torch.full((qp - s_q,), math.inf)])
    delta = torch.cat([delta, torch.zeros(qp - s_q)])
    sq, sk, sv, so = (tuple(x.double() for x in split(t)) for t in (q, k, v, do))
    rows = lambda x, r0: tuple(y[r0:r0 + 64] for y in x)  # noqa: E731
    cols = lambda x, r0: tuple(y[r0:r0 + 64].t().contiguous() for y in x)  # noqa: E731
    scale = d ** -0.5
    scale2 = torch.tensor(scale * LOG2E, dtype=torch.float32)

    dq = torch.zeros(qp, dp)  # kernel 9: over 64-key tiles
    for j in range(0, kp, 64):
        s = _scores(sq, cols(sk, j))
        s = torch.where(torch.arange(j, j + 64) < s_k, s, -math.inf)
        p = torch.exp2(s * scale2 - lse[:, None])
        ds = tuple(x.double() for x in split(p * (_scores(so, cols(sv, j)) - delta[:, None])))
        acc = torch.zeros(qp, dp, dtype=torch.float64)
        for k0 in range(0, 64, 8):
            acc = _three(acc, ds, rows(sk, j), k0)
        dq = dq + acc.float()
    dk, dv = torch.zeros(kp, dp), torch.zeros(kp, dp)  # kernel 10: over 64-query tiles
    for i in range(0, qp, 64):
        p = torch.exp2(_scores(sk, cols(sq, i)) * scale2 - lse[None, i:i + 64])
        ds = p * (_scores(sv, cols(so, i)) - delta[None, i:i + 64])
        for out, a, b in ((dv, p, so), (dk, ds, sq)):
            a = tuple(x.double() for x in split(a))
            acc = torch.zeros(kp, dp, dtype=torch.float64)
            for k0 in range(0, 64, 8):
                acc = _three(acc, a, rows(b, i), k0)
            out += acc.float()
    return (dq * scale)[:s_q, :d], (dk * scale)[:s_k, :d], dv[:s_k, :d]


def emulate_tf32_backward(q, k, v, do, lse, delta, one_product=False):
    """The 3xTF32 backward kernels (every D <= 512) on (B, S, H, D) fp32 tensors with lse and
    delta (B, H, S_q): dq, dk, dv as (B, S, H, D). ``one_product``: one TF32 product a
    product."""
    split = _one_tf32 if one_product else _split
    outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            grads = _tf32_head(q[b, :, h], k[b, :, h], v[b, :, h], do[b, :, h], lse[b, h],
                               delta[b, h], split)
            for out, g in zip(outs, grads):
                out[b, :, h] = g
    return tuple(outs)


def _inputs(shape, s_k, scale):
    b, s_q, h, d = shape
    rng = np.random.default_rng(31)
    q = (rng.normal(size=shape) * scale).astype(np.float32)
    k = (rng.normal(size=(b, s_k, h, d)) * scale).astype(np.float32)
    v, do = rng.normal(size=(b, s_k, h, d)).astype(np.float32), rng.normal(size=shape).astype(
        np.float32)
    return q, k, v, do


# the fp32 UNet's head dim, ragged against the 64-row tiles, S_q != S_k, D = 40 (zero-padded
# to 64), 128 and 200 (zero-padded to 256, hi.hi restarted once), and the guard input: norms
# x4, where the bound form's rows underflow
CASES = [((1, 300, 2, 64), 300, 1.0), ((1, 200, 2, 40), 330, 1.0),
         ((1, 256, 1, 128), 256, 1.0), ((1, 300, 2, 64), 300, 4.0),
         ((1, 100, 1, 200), 130, 1.0)]


@pytest.mark.parametrize("shape,s_k,scale", CASES, ids=["ragged", "sq_ne_sk_d40", "d128",
                                                        "guard", "d200_fold"])
def test_tile_loop_matches_jax_fp32_backward(shape, s_k, scale):
    """The kernel the plan names, emulated: 3xTF32 at every D, on the narrow kernels' plan to
    D = 64 and the wide ones' above."""
    q, k, v, do = _inputs(shape, s_k, scale)
    lse, delta, *want = _jax_backward(q, k, v, do)
    tensors = [torch.from_numpy(x) for x in (q, k, v, do)]
    kernel = tfa.flash_bwd_plan(*shape[:2], s_k, *shape[2:], False, fp32=True).kernel
    assert kernel == ("dq_tf32x3" if shape[3] <= 64 else "dq_tf32x3_wide")
    got = emulate_tf32_backward(*tensors, lse, delta)
    plain = tfa.flash_bwd_plain(*tensors, lse, delta)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert g.shape == w.shape, name
        ref = w.abs().max().item()
        assert (g - w).abs().max().item() <= FP32_GRAD_TOL * ref, name
        assert (p - w).abs().max().item() <= FP32_GRAD_TOL * ref, name


def test_one_tf32_product_misses_the_tolerance_backward():
    """The emulation is not fp32 in disguise: with one TF32 product in the place of three (and
    the same accumulation) every gradient lands more than 20x outside FP32_GRAD_TOL of JAX's
    (3.9-4.2e-3 of max|ref| at this input)."""
    shape, s_k, scale = CASES[0]
    q, k, v, do = _inputs(shape, s_k, scale)
    lse, delta, *want = _jax_backward(q, k, v, do)
    got = emulate_tf32_backward(*(torch.from_numpy(x) for x in (q, k, v, do)), lse, delta,
                                one_product=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert (g - w).abs().max().item() > 20 * FP32_GRAD_TOL * w.abs().max().item(), name


@pytest.mark.parametrize("d", [8, 40, 64, 128, 256, 512])
def test_fp32_lse_plan_is_the_fp32_forward_plan(d):
    """Kernels 7/8 at fp32 are the fp32 forward with the lse store: one tiling."""
    shape = (2, 1100, 1333, 3, d)
    plan = tfa.flash_plan(*shape, lse=True, fp32=True)
    assert plan == tfa.flash_plan(*shape, fp32=True) and plan.kernel == "tf32x3"


@pytest.mark.parametrize("dkv", [False, True], ids=["dq", "dkv"])
@pytest.mark.parametrize("d", [8, 40, 64, 96, 128])
def test_fp32_bwd_plan_by_head_dim(d, dkv):
    """D <= 64, ``TPlan``: 128 resident rows of two tensors' hi and lo planes (128 KB), 64-row
    streamed tiles through a ring of 16 KB units that fills the rest of the 227 KB a block may
    use (dk/dv: beside two tiles' lse and delta), a grid of (B*H, 128-row tiles). Above,
    ``WPlan``, the wide kernels at D padded to 128: 64 rows a block, each consumer warpgroup
    with its own ring of six 16 KB units through which its score operand's 64 rows stream
    with the other operands, the 16 KB exchange between the two warpgroups; a grid of (B*H,
    64-row tiles), one column slice (dq 64 columns a warpgroup, dk/dv 128)."""
    plan = tfa.flash_bwd_plan(2, 1100, 1030, 5, d, dkv, fp32=True)
    n = 1030 if dkv else 1100
    if d <= 64:
        assert plan.kernel == ("dkv_tf32x3" if dkv else "dq_tf32x3")
        assert (plan.tile_rows, plan.stream_rows) == (128, 64)
        fixed = 1024 + 2 * 2 * 2 * tfa.F32_UNIT + (1024 if dkv else 0)
        assert plan.stages == 6 and plan.stages * tfa.F32_UNIT + fixed < tfa.SMEM_LIMIT
        assert tfa.SMEM_LIMIT - plan.smem_bytes < tfa.F32_UNIT  # no room for another unit
        assert plan.smem_bytes == fixed + plan.stages * tfa.F32_UNIT + 8 * (1 + 2 * plan.stages)
        assert plan.blocks == 2 * 5 * -(-n // 128)
    else:
        assert plan.kernel == ("dkv_tf32x3_wide" if dkv else "dq_tf32x3_wide")
        assert (plan.tile_rows, plan.stream_rows, plan.stages, plan.slices) == (64, 64, 6, 1)
        assert plan.smem_bytes == (1024 + 2 * 6 * tfa.F32_UNIT + tfa.BWD_EXCHANGE
                                   + 2 * 8 * 2 * 6)
        assert plan.blocks == 2 * 5 * -(-n // 64)
    assert plan.smem_bytes <= tfa.SMEM_LIMIT and plan.waves == plan.blocks / 132


@pytest.mark.parametrize("d", [520, 776, 1024])
def test_fp32_bwd_plan_refuses_wide_heads(d):
    with pytest.raises(ValueError, match="not built"):
        tfa.flash_bwd_plan(1, 1024, 1024, 1, d, True, fp32=True)


def test_train_cli_dtype_names_the_jax_precision():
    """``--dtype`` stays bf16 by default (the JAX bench's ``bench_train``); its help names fp32
    as the JAX fine-tune CLI's precision and the TF32 setting the path runs under."""
    from lkgd_torch.cli import train_svd_lora as cli

    parser = cli.make_parser()
    assert parser.parse_args([]).dtype == "bf16"
    assert parser.parse_args(["--dtype", "fp32"]).dtype == "fp32"
    text = next(a.help for a in parser._actions if a.dest == "dtype")
    assert "JAX" in text and "TF32" in text and "bf16 only" not in text


def test_fp32_backward_counters_exist():
    """The four fp32 forms have counters of their own beside the bf16 ones."""
    for name in ("flash_bound_lse_fp32", "flash_maxtrack_lse_fp32", "flash_bwd_dq_fp32",
                 "flash_bwd_dkv_fp32", "flash_bound_lse", "flash_bwd_dq"):
        assert name in tfa.launches
