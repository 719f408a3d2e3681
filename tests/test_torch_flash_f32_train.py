"""The fp32 training kernels (7-10 on fp32 operands) on the CPU: their tiling, the tile loop
of the fp32 backward, and the training CLI's precision flag. The kernels themselves run only
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phases 3i, 7d, 8o).

The fp32 backward (``csrc/flash_attention_bwd_f32.cu``) multiplies on the CUDA cores with
fp32 FMAs: each product is the fp32 product, so what can go wrong is the tile loop, not the
arithmetic. A test-local emulation of that loop (64 resident rows, 64-row streamed tiles, keys
past S_k with P = 0 in dq, queries past S_q with lse = +inf and delta = 0 in dk/dv, fp32
accumulators a tile at a time) is held against the JAX package's fp32 backward run in TPU
interpret mode within 1e-4 of each gradient's max|ref|: ``chip_smoke.py``'s FP32_GRAD_TOL for
the kernels against their plain fp32 versions. The forward's LSE form is the fp32 forward of
``tests/test_torch_flash_f32.py`` with one more store a row; its plan is that forward's.
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

FP32_GRAD_TOL = 1e-4  # of each gradient's max|ref|, as chip_smoke.py holds the kernels
LOG2E = 1.4426950408889634
TILE = tfa.F32_BWD_ROWS


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


def emulate_backward(q, k, v, do, lse, delta):
    """The fp32 backward kernels' tile loops in fp32: dq a 64-query tile at a time over
    64-key tiles, dk and dv a 64-key tile at a time over 64-query tiles, each output tile
    accumulated in fp32 tile by tile, with the kernels' masks."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = d ** -0.5
    qt, kt, vt, dot = (x.transpose(1, 2).float() for x in (q, k, v, do))  # (B, H, S, D)
    dq, dk, dv = torch.zeros_like(qt), torch.zeros_like(kt), torch.zeros_like(vt)

    def tile(q0, k0):
        """P and dS of queries q0.. and keys k0.. (64 each, padded as the kernels load)."""
        rows = torch.arange(q0, q0 + TILE)
        keys = torch.arange(k0, k0 + TILE)
        qs, dos = (torch.nn.functional.pad(x[:, :, q0:q0 + TILE], (0, 0, 0, q0 + TILE - min(
            s_q, q0 + TILE))) for x in (qt, dot))
        ks, vs = (torch.nn.functional.pad(x[:, :, k0:k0 + TILE], (0, 0, 0, k0 + TILE - min(
            s_k, k0 + TILE))) for x in (kt, vt))
        lse_r = torch.where(rows < s_q, torch.nn.functional.pad(
            lse[:, :, q0:q0 + TILE], (0, q0 + TILE - min(s_q, q0 + TILE))), math.inf)
        delta_r = torch.nn.functional.pad(delta[:, :, q0:q0 + TILE],
                                          (0, q0 + TILE - min(s_q, q0 + TILE)))
        s = qs @ ks.transpose(-1, -2)
        p = torch.exp2(s * (scale * LOG2E) - lse_r[..., None])
        p = torch.where(keys < s_k, p, 0.0)
        ds = p * (dos @ vs.transpose(-1, -2) - delta_r[..., None])
        return qs, dos, ks, p, ds

    for q0 in range(0, s_q, TILE):  # kernel 9
        acc = torch.zeros(b, h, TILE, d)
        for k0 in range(0, s_k, TILE):
            _, _, ks, _, ds = tile(q0, k0)
            acc = acc + ds @ ks
        dq[:, :, q0:q0 + TILE] = (acc * scale)[:, :, :min(TILE, s_q - q0)]
    for k0 in range(0, s_k, TILE):  # kernel 10
        acc_k, acc_v = torch.zeros(b, h, TILE, d), torch.zeros(b, h, TILE, d)
        for q0 in range(0, s_q, TILE):
            qs, dos, _, p, ds = tile(q0, k0)
            acc_v = acc_v + p.transpose(-1, -2) @ dos
            acc_k = acc_k + ds.transpose(-1, -2) @ qs
        n = min(TILE, s_k - k0)
        dk[:, :, k0:k0 + TILE] = (acc_k * scale)[:, :, :n]
        dv[:, :, k0:k0 + TILE] = acc_v[:, :, :n]
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


# the fp32 UNet's head dim, ragged against the 64-row tiles, S_q != S_k, D = 40 (zero-padded
# to 64) and 128, and the guard input: norms x4, where the bound form's rows underflow
CASES = [((1, 300, 2, 64), 300, 1.0), ((1, 200, 2, 40), 330, 1.0),
         ((1, 256, 1, 128), 256, 1.0), ((1, 300, 2, 64), 300, 4.0)]


@pytest.mark.parametrize("shape,s_k,scale", CASES, ids=["ragged", "sq_ne_sk_d40", "d128",
                                                        "guard"])
def test_tile_loop_matches_jax_fp32_backward(shape, s_k, scale):
    b, s_q, h, d = shape
    rng = np.random.default_rng(31)
    q = (rng.normal(size=shape) * scale).astype(np.float32)
    k = (rng.normal(size=(b, s_k, h, d)) * scale).astype(np.float32)
    v, do = rng.normal(size=(b, s_k, h, d)).astype(np.float32), rng.normal(size=shape).astype(
        np.float32)
    lse, delta, *want = _jax_backward(q, k, v, do)
    got = emulate_backward(*(torch.from_numpy(x) for x in (q, k, v, do)), lse, delta)
    plain = tfa.flash_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, do)), lse, delta)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert g.shape == w.shape, name
        ref = w.abs().max().item()
        assert (g - w).abs().max().item() <= FP32_GRAD_TOL * ref, name
        assert (p - w).abs().max().item() <= FP32_GRAD_TOL * ref, name


@pytest.mark.parametrize("d", [8, 40, 64, 128, 256, 512])
def test_fp32_lse_plan_is_the_fp32_forward_plan(d):
    """Kernels 7/8 at fp32 are the fp32 forward with the lse store: one tiling."""
    shape = (2, 1100, 1333, 3, d)
    plan = tfa.flash_plan(*shape, lse=True, fp32=True)
    assert plan == tfa.flash_plan(*shape, fp32=True) and plan.kernel == "tf32x3"


@pytest.mark.parametrize("dkv", [False, True], ids=["dq", "dkv"])
@pytest.mark.parametrize("d", [8, 40, 64, 96, 128])
def test_fp32_bwd_plan_by_head_dim(d, dkv):
    """``F32BwdPlan``: 64 resident rows and 64-row streamed tiles at a pitch of D padded
    (64 or 128) + 1 floats, one tile each of q, dO, k and v, then dS (and P for dk/dv) at a
    pitch of 65 and the tile's lse and delta; a grid of (B*H, 64-row tiles)."""
    plan = tfa.flash_bwd_plan(2, 1100, 1030, 5, d, dkv, fp32=True)
    dp = 64 if d <= 64 else 128
    assert plan.kernel == ("dkv_fp32" if dkv else "dq_fp32")
    assert (plan.tile_rows, plan.stream_rows, plan.stages) == (TILE, TILE, 1)
    assert plan.smem_bytes == 4 * (4 * TILE * (dp + 1) + (2 if dkv else 1) * TILE * (TILE + 1)
                                   + 2 * TILE)
    assert plan.smem_bytes <= tfa.SMEM_LIMIT
    assert plan.blocks == 2 * 5 * -(-(1030 if dkv else 1100) // TILE)


@pytest.mark.parametrize("d", [136, 256, 512])
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
