"""The port's flash attention (``lkgd_torch.ops.flash_attention``) against the Pallas
kernels of ``lkgd_tpu.ops.flash_attention`` run in TPU interpret mode on the CPU, as
``tests/test_flash_attention.py`` runs them. On the CPU the port runs the plain versions
of its kernels; the CUDA kernels themselves are held against those plain versions in
``tests/test_torch_kernels_cuda.py`` on the card.

The training path: the plain versions of kernels 7-10 (``flash_fwd_lse_bound_plain``,
``flash_fwd_lse_maxtrack_plain``, ``flash_bwd_plain``) against ``_flash_fwd_lse_bhsd``,
``_flash_fwd_lse_maxtrack_bhsd`` and ``_flash_bwd_bhsd``, padded S and D=512 included; the plain
versions of kernels 5 and 6 (``split_heads_plain``, ``merge_heads_plain`` and their grouped
forms) against ``_split_heads`` and ``_merge_heads`` (exact: they move bytes); and the autograd
Function's gradients against ``jax.grad`` of ``flash_attention``.

Tolerances: fp32 on both sides, the same exp2-domain arithmetic, summed in another order
(rtol 1e-5, atol 1e-5; 2e-5 where the Pallas wrapper pads and masks; gradients, whose
products run over every key or query, rtol 1e-4, atol 1e-5)."""

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


def _as_bhsd(x: torch.Tensor) -> np.ndarray:
    """A port (B, S, H, D) tensor -> numpy in the Pallas kernels' (B*H, S, D) layout."""
    b, s, h, d = x.shape
    return x.detach().numpy().transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _port(fn, q, k, v) -> np.ndarray:
    return _as_bhsd(fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)))


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


# ------------------------------------------------------------------ the kernels' tiling
# every (B, S_q, S_k, H, D) the pipelines hand the forward kernels: UNet levels 0 and 1 of
# the base clip, the VAE mid block (encode, whole-clip decode), the frame-transition clip,
# and the fine-tune's frozen VAE encode
MAIN_SHAPES = [(2, 9216, 9216, 5, 64), (4, 2304, 2304, 10, 64), (2, 9216, 9216, 1, 512),
               (14, 9216, 9216, 1, 512), (56, 9216, 9216, 5, 64), (56, 2304, 2304, 10, 64),
               (8, 4096, 4096, 1, 512)]


def _expected_rows(d: int, lse: bool) -> int:
    """What ``lkgd_flash_block_rows(d, lse)`` answers (csrc/flash_attention_wgmma.cu): the
    training forward is the inference kernel with an lse store, tiled the same way."""
    return 64 if d > 128 else 128


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plan_at_main_path_shapes(shape):
    b, s_q, s_k, h, d = shape
    plan = tfa.flash_plan(*shape)
    assert plan.kernel == "wgmma"
    assert plan.smem_bytes <= tfa.SMEM_LIMIT == 232_448
    assert plan.tile_rows == _expected_rows(d, False)
    assert plan.blocks == b * h * -(-s_q // plan.tile_rows)
    assert plan.waves == plan.blocks / 132
    # the ring holds at least one K and one V tile beside Q
    assert plan.stages >= 2 and plan.smem_bytes > (plan.tile_rows + 2 * plan.key_tile) * d * 2


@pytest.mark.parametrize("lse", [False, True], ids=["inference", "lse"])
@pytest.mark.parametrize("d", [8, 40, 64, 128, 256, 512])
def test_flash_plan_by_head_dim(d, lse):
    plan = tfa.flash_plan(1, 1100, 1030, 2, d, lse=lse)
    assert plan.kernel == "wgmma"
    assert plan.smem_bytes <= tfa.SMEM_LIMIT
    assert plan.tile_rows == _expected_rows(d, lse)
    assert plan.key_tile == plan.tile_rows
    assert plan.blocks == 2 * -(-1100 // plan.tile_rows)
    dp = next(w for w in (64, 128, 256, 512) if d <= w)
    assert plan.smem_bytes >= (plan.tile_rows + plan.stages * plan.key_tile) * dp * 2


@pytest.mark.parametrize("d", [0, 12, 520])
def test_flash_plan_refuses_head_dims_the_kernels_do_not_take(d):
    with pytest.raises(ValueError):
        tfa.flash_plan(1, 1024, 1024, 1, d)


# the training shapes beside the inference ones: UNet levels 0 and 1 of the fine-tune
@pytest.mark.parametrize("shape", MAIN_SHAPES + [(8, 4096, 4096, 5, 64), (8, 1024, 1024, 10, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lse_plan_is_the_inference_plan(shape):
    """Kernels 7 and 8 are kernels 1 and 2 with one more store a row: one plan, and with
    it one guard tile, for both."""
    assert tfa.flash_plan(*shape, lse=True) == tfa.flash_plan(*shape)
    assert tfa.FWD_MAX_D == 512 and not hasattr(tfa, "BWD_MAX_D")  # one limit, 7-10 alike


# the backward kernels' tiling (csrc/flash_attention_bwd.cu BwdPlan): the fine-tune's UNet
# levels 0 and 1 and the card tests' ragged shape, each for kernel 9 (dq) and kernel 10 (dkv)
TRAIN_SHAPES = [(8, 4096, 4096, 5, 64), (8, 1024, 1024, 10, 64), (2, 1100, 1100, 5, 64)]


@pytest.mark.parametrize("dkv", [False, True], ids=["dq", "dkv"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_bwd_plan_at_the_train_path_shapes(shape, dkv):
    b, s_q, s_k, h, d = shape
    plan = tfa.flash_bwd_plan(*shape, dkv=dkv)
    assert plan.kernel == ("dkv" if dkv else "dq")
    assert plan.smem_bytes <= tfa.SMEM_LIMIT
    # 128 resident rows a block, 64 to each consumer warpgroup; D=64 streams 128 keys into
    # dq and 64 queries into dk/dv
    assert plan.tile_rows == 128
    assert plan.stream_rows == (64 if dkv else 128)
    assert plan.blocks == b * h * -(-(s_k if dkv else s_q) // 128)
    assert plan.waves == plan.blocks / 132
    if shape[:3] == (8, 4096, 4096):
        assert plan.blocks == 1280  # 9.7 waves of the level-0 call
    # the two resident tiles and a ring of at least three streamed slots
    per_slot = (2 if dkv else 1) * plan.stream_rows * 64 * 2
    assert plan.stages >= 3
    assert plan.smem_bytes >= 2 * 128 * 64 * 2 + plan.stages * per_slot


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("dkv", [False, True], ids=["dq", "dkv"])
@pytest.mark.parametrize("d", [8, 40, 64, 96, 128, 136, 192, 256, 512])
def test_flash_bwd_plan_by_head_dim(d, dkv, fp32):
    """Every D % 8 == 0 up to 512 has a backward in both dtypes. bf16 to D = 128 and fp32 to
    D = 64: 128 resident rows (the narrow kernels; fp32's are ``test_fp32_bwd_plan_by_head_dim``
    of ``tests/test_torch_flash_f32_train.py``). Above: the wide kernels' 64 resident rows,
    64-row streamed tiles, two rings of 16 KB units beside the 16 KB exchange, and column
    slices where a block's outputs would not fit in registers."""
    plan = tfa.flash_bwd_plan(1, 1100, 1030, 2, d, dkv, fp32=fp32)
    dp = 64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256 else 512
    own = 1030 if dkv else 1100
    assert plan.smem_bytes <= tfa.SMEM_LIMIT
    if dp <= (64 if fp32 else 128):
        assert plan.tile_rows == 128 and plan.slices == 1
        assert plan.blocks == 2 * -(-own // 128)
        if not fp32:
            # 64-row streamed tiles, except dq's 128-key tiles at D <= 64
            assert plan.kernel == ("dkv" if dkv else "dq")
            assert plan.stream_rows == (128 if not dkv and dp == 64 else 64)
            per_slot = (2 if dkv else 1) * plan.stream_rows * dp * 2
            assert plan.smem_bytes >= 2 * 128 * dp * 2 + plan.stages * per_slot
    else:
        assert plan.kernel == ("dkv" if dkv else "dq") + ("_tf32x3" if fp32 else "") + "_wide"
        assert (plan.tile_rows, plan.stream_rows) == (tfa.WIDE_ROWS, 64)
        # output columns a block: bf16 dq all of D, bf16 dk/dv and fp32 dq 256, fp32 dk/dv 128
        width = (128 if dkv else 256) if fp32 else (256 if dkv else 512)
        assert plan.slices == -(-d // min(width, dp))
        assert plan.blocks == 2 * -(-own // 64) * plan.slices
        # the resident 64 rows (bf16 at D = 256; else they stream), two rings, the exchange
        resident = 64 * dp * 2 if not fp32 and dp == 256 else 0
        assert plan.smem_bytes == (1024 + 2 * (resident + plan.stages * tfa.F32_UNIT)
                                   + tfa.BWD_EXCHANGE + 16 * (int(not fp32) + 2 * plan.stages))
        assert plan.stages >= 2 and tfa.SMEM_LIMIT - plan.smem_bytes < 2 * tfa.F32_UNIT
    assert plan.waves == plan.blocks / 132
    # one plan a padded width: D=8 and D=64 tile alike, as D=96 and D=128 do (the wide
    # kernels' slices follow D itself)
    if plan.slices == 1:
        assert plan == tfa.flash_bwd_plan(1, 1100, 1030, 2, dp, dkv, fp32=fp32)


@pytest.mark.parametrize("d", [0, 12, 520, 1024])
def test_flash_bwd_plan_refuses_head_dims_the_kernels_do_not_take(d):
    for dkv in (False, True):
        for fp32 in (False, True):
            with pytest.raises(ValueError):
                tfa.flash_bwd_plan(1, 1024, 1024, 1, d, dkv, fp32=fp32)


# kernel 1 sums |q_i| itself and takes max_j|k_j| from the key-norm kernel; their plain
# versions (bound_t = -(|q_i| * key_norm_max_plain) * scale * log2e) against the Pallas
# wrapper's _bound_t and, through the bound form, against the Pallas kernel on a ragged S
@pytest.mark.parametrize("shape", [(1, 1100, 2, 64), (1, 1030, 1, 512)], ids=["d64", "d512"])
def test_key_norm_and_row_bound_match_pallas_wrapper(shape):
    q, k, _ = _qkv(14, shape, scale=3.0)
    d = shape[-1]
    kn_j = np.sqrt(np.max(np.sum(np.square(_as_bhsd(torch.from_numpy(k))), -1), axis=1))
    got_kn = tfa.key_norm_max(torch.from_numpy(k))  # on the CPU: the plain version
    assert got_kn.shape == (shape[0], shape[2])
    np.testing.assert_allclose(got_kn.reshape(-1).numpy(), kn_j, rtol=1e-6)
    want = np.asarray(jfa._bound_t(_bhsd(q), _bhsd(k), d ** -0.5))[:, 0]
    got = tfa.bound_t(torch.from_numpy(q), torch.from_numpy(k)).reshape(want.shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1100, 2, 64), (1, 1030, 1, 512)], ids=["d64", "d512"])
def test_bound_plain_matches_pallas_at_the_card_tests_ragged_shapes(shape):
    """fp32, rtol 1e-4 / atol 2e-4: the same exp2-domain arithmetic summed in another order
    over ~1100 keys; the Pallas wrapper pads S to its blocks and masks the keys."""
    q, k, v = _qkv(15, shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tfa.flash_attention_bound_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


# ------------------------------------------------------------------ training kernels
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _lse(lse: torch.Tensor) -> np.ndarray:
    """The port's (B, H, S) lse -> the Pallas kernels' (B*H, 1, S)."""
    b, h, s = lse.shape
    return lse.numpy().reshape(b * h, 1, s)


def _padded_bhsd(x: np.ndarray, s_pad: int) -> jnp.ndarray:
    return _bhsd(np.pad(x, ((0, 0), (0, s_pad - x.shape[1]), (0, 0), (0, 0))))


@pytest.mark.parametrize("s", [256, 300], ids=["tiled", "ragged"])
@pytest.mark.parametrize("kernel", ["bound", "maxtrack"])
def test_lse_forward_plain_matches_pallas(monkeypatch, kernel, s):
    """Kernels 7 and 8: the output and the log2-domain lse. S=300 runs the Pallas kernels
    on keys padded to 384 and masked (kv_valid); the port's plain versions never pad."""
    monkeypatch.delenv("LKGD_FLASH_MAXTRACK", raising=False)
    q, k, v = _qkv(6, (1, s, 2, 64))
    s_pad = -(-s // 128) * 128
    kv_valid = s if s_pad != s else None
    args = [_padded_bhsd(x, s_pad) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        if kernel == "bound":
            out_j, lse_j = jfa._flash_fwd_lse_bhsd(*args, 128, 128, kv_valid)
        else:
            out_j, lse_j = jfa._flash_fwd_lse_maxtrack_bhsd(*args, 128, 128, kv_valid)
    plain = (tfa.flash_fwd_lse_bound_plain if kernel == "bound"
             else tfa.flash_fwd_lse_maxtrack_plain)
    out, lse = plain(*map(torch.from_numpy, (q, k, v)))
    assert lse.shape == (1, 2, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(_as_bhsd(out), np.asarray(out_j)[:, :s], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_lse(lse), np.asarray(lse_j)[..., :s], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["bound", "maxtrack"])
def test_lse_forward_plain_matches_pallas_at_wide_heads(kernel):
    """Kernels 7 and 8 at the VAE's D=512 and the card tests' ragged S=1030: the Pallas
    kernels on keys padded to 1152 and masked. fp32 on both sides, the same exp2-domain
    arithmetic summed in another order over ~1030 keys: out rtol 1e-4 / atol 2e-4 (as the
    inference case at this shape), lse rtol 1e-5 / atol 1e-5."""
    s, s_pad = 1030, 1152
    q, k, v = _qkv(16, (1, s, 1, 512))
    args = [_padded_bhsd(x, s_pad) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        if kernel == "bound":
            out_j, lse_j = jfa._flash_fwd_lse_bhsd(*args, 128, 128, s)
        else:
            out_j, lse_j = jfa._flash_fwd_lse_maxtrack_bhsd(*args, 128, 128, s)
    plain = (tfa.flash_fwd_lse_bound_plain if kernel == "bound"
             else tfa.flash_fwd_lse_maxtrack_plain)
    out, lse = plain(*map(torch.from_numpy, (q, k, v)))
    assert lse.shape == (1, 1, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(_as_bhsd(out), np.asarray(out_j)[:, :s], rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(_lse(lse), np.asarray(lse_j)[..., :s], rtol=1e-5, atol=1e-5)


def test_lse_forward_bound_form_matches_maxtrack_at_a_wide_head(monkeypatch):
    """``flash_fwd_lse`` at D=256 (ring attention's ``flash_attention_with_lse``): the bound
    form that runs by default against kernel 8's plain version."""
    monkeypatch.delenv("LKGD_FLASH_MAXTRACK", raising=False)
    q, k, v = (torch.from_numpy(x) for x in _qkv(17, (1, 64, 1, 256)))
    out, lse = tfa.flash_fwd_lse(q, k, v)
    want_out, want_lse = tfa.flash_fwd_lse_maxtrack_plain(q, k, v)
    # fp32, two forms of one softmax over 64 keys: rtol 1e-5 / atol 1e-5
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5, atol=1e-5)


def test_lse_forward_underflow_fallback_matches_pallas(monkeypatch):
    """The huge-norm input: kernel 7's rows underflow and take kernel 8's out and lse, as
    the Pallas wrapper's lax.cond reruns the max-tracking kernel."""
    monkeypatch.delenv("LKGD_FLASH_MAXTRACK", raising=False)
    q, k, v = _qkv(4, (1, 256, 2, 32), scale=60.0)
    with pltpu.force_tpu_interpret_mode():
        out_j, lse_j = jfa._flash_fwd_lse_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), 128, 128)
    out, lse = tfa.flash_fwd_lse_bound_plain(*map(torch.from_numpy, (q, k, v)))
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    # logits of ~2e4 (test_underflow_fallback_matches_pallas): tolerances follow the scale
    np.testing.assert_allclose(_as_bhsd(out), np.asarray(out_j),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_lse(lse), np.asarray(lse_j), rtol=1e-6, atol=1e-2)


@pytest.mark.parametrize("s", [256, 300], ids=["tiled", "ragged"])
def test_backward_plain_matches_pallas(s):
    """Kernels 9 and 10 from the same lse and delta: dq, dk and dv. With S=300 the Pallas
    kernels see zero-padded rows (zero dO, masked keys) that are sliced off."""
    q, k, v = _qkv(7, (1, s, 2, 64))
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    s_pad = -(-s // 128) * 128
    kv_valid = s if s_pad != s else None
    qt, kt, vt, dot = (_padded_bhsd(x, s_pad) for x in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        out_j, lse_j = jfa._flash_fwd_lse_maxtrack_bhsd(qt, kt, vt, 128, 128, kv_valid)
        delta_j = jnp.sum(dot * out_j, axis=-1)[:, None, :]
        grads_j = jfa._flash_bwd_bhsd(qt, kt, vt, dot, lse_j, delta_j, 128, 128, kv_valid)
    lse = torch.from_numpy(np.asarray(lse_j)[:, 0, :s].reshape(1, 2, s).copy())
    delta = torch.from_numpy(np.asarray(delta_j)[:, 0, :s].reshape(1, 2, s).copy())
    got = tfa.flash_bwd_plain(*map(torch.from_numpy, (q, k, v, do)), lse, delta)
    for name, g, want in zip(("dq", "dk", "dv"), got, grads_j):
        assert g.shape == q.shape, name
        np.testing.assert_allclose(_as_bhsd(g), np.asarray(want)[:, :s],
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("b,s_q,s_k,h,d", [(1, 200, 300, 2, 64), (1, 256, 256, 2, 40),
                                           (1, 256, 256, 1, 128), (1, 200, 330, 2, 136),
                                           (1, 256, 256, 1, 256), (1, 256, 256, 1, 512)],
                         ids=["sq_ne_sk", "d40", "d128", "d136_ragged", "d256", "d512"])
def test_backward_plain_matches_pallas_at_other_shapes(b, s_q, s_k, h, d):
    """Kernels 9 and 10 where the card's kernels tile differently: fewer queries than keys,
    both ragged (the Pallas kernels see 256 zero-padded query rows and 384 keys, masked),
    the head dims 40 and 128 (D < 64 zero-padded to a panel; D=128 two panels), and the wide
    kernels' 136 (ragged, D past a 128-column unit), 256 and the VAE's 512."""
    rng = np.random.default_rng(18)
    q, do = (rng.normal(size=(b, s_q, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s_k, h, d)).astype(np.float32) for _ in range(2))
    q_pad, k_pad = -(-s_q // 128) * 128, -(-s_k // 128) * 128
    kv_valid = s_k if k_pad != s_k else None
    qt, dot = (_padded_bhsd(x, q_pad) for x in (q, do))
    kt, vt = (_padded_bhsd(x, k_pad) for x in (k, v))
    with pltpu.force_tpu_interpret_mode():
        out_j, lse_j = jfa._flash_fwd_lse_maxtrack_bhsd(qt, kt, vt, 128, 128, kv_valid)
        delta_j = jnp.sum(dot * out_j, axis=-1)[:, None, :]
        grads_j = jfa._flash_bwd_bhsd(qt, kt, vt, dot, lse_j, delta_j, 128, 128, kv_valid)
    lse = torch.from_numpy(np.asarray(lse_j)[:, 0, :s_q].reshape(b, h, s_q).copy())
    delta = torch.from_numpy(np.asarray(delta_j)[:, 0, :s_q].reshape(b, h, s_q).copy())
    got = tfa.flash_bwd_plain(*map(torch.from_numpy, (q, k, v, do)), lse, delta)
    for name, g, want, x in zip(("dq", "dk", "dv"), got, grads_j, (q, k, v)):
        assert g.shape == x.shape, name
        np.testing.assert_allclose(_as_bhsd(g), np.asarray(want)[:, :x.shape[1]],
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("s", [256, 300], ids=["tiled", "ragged"])
def test_function_grads_match_jax_grad(monkeypatch, s):
    """The autograd Function (kernels 7/8 forward, 9/10 backward; their plain versions on
    the CPU) against jax.grad through the custom VJP of ``flash_attention``."""
    monkeypatch.delenv("LKGD_FLASH_MAXTRACK", raising=False)
    q, k, v = _qkv(9, (2, s, 2, 32))
    w = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)

    def loss_j(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    inputs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention_differentiable(*inputs)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    for name, x, g in zip(("dq", "dk", "dv"), inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("shape", [(1, 256, 2, 256), (1, 256, 1, 512)], ids=["d256", "d512"])
def test_function_grads_match_jax_grad_at_wide_heads(monkeypatch, shape):
    """The Function past D = 128, where the card runs the wide backward kernels: two heads of
    256 (the head split and merge around it) and the VAE's one head of 512, against jax.grad
    through the custom VJP of ``flash_attention`` (its Pallas kernels in interpret mode)."""
    monkeypatch.delenv("LKGD_FLASH_MAXTRACK", raising=False)
    q, k, v = _qkv(26, shape)
    w = np.random.default_rng(27).normal(size=q.shape).astype(np.float32)

    def loss_j(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    inputs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention_differentiable(*inputs)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    for name, x, g in zip(("dq", "dk", "dv"), inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), err_msg=name, **GRAD_TOL)


def test_vae_attention_gradient_at_512_channels_matches_jax_grad(monkeypatch):
    """The VAE mid block's attention (one head of 512 channels, its GroupNorm and residual)
    on a 32x32 latent: 1024 tokens, so a call that needs a gradient goes to the flash
    Function (kernels 7-10; their plain versions on the CPU), as every gradient through the
    VAEs' mid blocks at 1024 or more latent tokens does. Held against jax.grad through the JAX
    ``VAEAttention`` (XLA's attention on the CPU) on the same random weights, carried over by
    ``utils/porting.py``'s rules. The input's gradient at GRAD_TOL; the projections' weight
    gradients, each a sum over the 1024 tokens, within 1e-4 of their own max|ref| (an entry
    near zero carries the rounding of the whole sum, so an entry-wise rtol does not apply)."""
    from flax import traverse_util

    from lkgd_tpu.models.vae_temporal import VAEAttention as JaxVAEAttention
    from lkgd_torch.models.vae_temporal import VAEAttention
    from lkgd_torch.utils.porting import from_flax_params

    rng = np.random.default_rng(25)
    x = rng.normal(size=(1, 32, 32, 512)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jmod = JaxVAEAttention(512)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes, sep="/").items():
        z = rng.normal(size=leaf.shape).astype(np.float32)
        flat[path] = (0.05 * z if path.endswith("kernel") else 1 + 0.1 * z
                      if path.endswith("scale") else 0.1 * z)
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                          sep="/")

    def loss_j(params, x):
        return jnp.sum(jmod.apply(params, x) * w)

    want_p, want_x = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(params, jnp.asarray(x))

    module = VAEAttention(512)
    module.load_state_dict(from_flax_params(flat), strict=True)
    routes = []
    real_fn = tattn.flash_attention_differentiable
    monkeypatch.setattr(tattn, "flash_attention_differentiable",
                        lambda *a: routes.append(a[0].shape) or real_fn(*a))
    xt = torch.from_numpy(x).requires_grad_()
    out = module(xt)
    assert routes == [(1, 1024, 1, 512)]
    names = ("to_q", "to_k", "to_v")
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              [xt] + [getattr(module, n).weight for n in names])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_x), err_msg="dx", **GRAD_TOL)
    for name, g in zip(names, got[1:]):
        ref = np.asarray(want_p["params"][name]["kernel"]).T  # flax (in, out) -> (out, in)
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), name


@pytest.mark.parametrize("grad,mode", [(True, "enabled"), (True, "no_grad"),
                                       (False, "enabled")])
def test_dispatch_routes_grad_calls_to_the_function(monkeypatch, grad, mode):
    """A long-sequence call whose q, k or v requires a gradient, with grad mode on, goes
    through the autograd Function (kernels 7-10); under no_grad, or with inputs that need
    none, it keeps the inference forward (kernels 1/2)."""
    routes = []
    real_fn, real_inf = tattn.flash_attention_differentiable, tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention_differentiable",
                        lambda *a: routes.append("function") or real_fn(*a))
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a: routes.append("inference") or real_inf(*a))
    q, k, v = (torch.from_numpy(x) for x in _qkv(11, (1, 1024, 1, 16)))
    k.requires_grad_(grad)
    with torch.set_grad_enabled(mode == "enabled"):
        out = tattn.dot_product_attention(q, k, v)
    want = "function" if grad and mode == "enabled" else "inference"
    assert routes == [want]
    assert out.requires_grad == (want == "function")
    if want == "function":
        (dk,) = torch.autograd.grad(out.square().sum(), (k,))
        assert torch.isfinite(dk).all() and dk.shape == k.shape


@pytest.mark.parametrize("shape", [(2, 64, 3, 16), (1, 136, 5, 8)], ids=["tiled", "odd_heads"])
def test_split_merge_heads_plain_match_pallas(shape):
    """Kernels 5 and 6: (B, S, H*D) <-> (B*H, S, D) against the Pallas relayouts, and the
    wrappers' round trip on a strided view (a slice of a fused projection)."""
    b, s, h, d = shape
    x = np.random.default_rng(12).normal(size=(b, s, 2 * h * d)).astype(np.float32)
    view = torch.from_numpy(x)[..., h * d:].unflatten(-1, (h, d))  # (B, S, H, D), strided
    dense = np.ascontiguousarray(x[..., h * d:])
    with pltpu.force_tpu_interpret_mode():
        split_j = np.asarray(jfa._split_heads(jnp.asarray(dense), h))
        merge_j = np.asarray(jfa._merge_heads(jnp.asarray(split_j), h))
    split = tfa.split_heads(view)
    assert split.shape == (b, h, s, d) and split.is_contiguous()
    np.testing.assert_array_equal(split.reshape(b * h, s, d).numpy(), split_j)
    merged = tfa.merge_heads(split)
    assert merged.shape == (b, s, h, d) and merged.is_contiguous()
    np.testing.assert_array_equal(merged.reshape(b, s, h * d).numpy(), merge_j)
    np.testing.assert_array_equal(merge_j, dense)


@pytest.mark.parametrize("s_q,s_k", [(64, 64), (64, 40)], ids=["sq_eq_sk", "sq_ne_sk"])
def test_grouped_split_merge_heads_plain_match_pallas(s_q, s_k):
    """One grouped launch of kernels 5 and 6 (on the CPU, their plain versions and the
    wrappers that run them): q sliced from a fused qkv projection and k, v from a fused kv
    projection (strided views, S_q != S_k), against one ``_split_heads`` / ``_merge_heads``
    call a tensor, byte for byte."""
    b, h, d = 2, 3, 16
    rng = np.random.default_rng(14)
    qkv = rng.normal(size=(b, s_q, 3 * h * d)).astype(np.float32)
    kv = rng.normal(size=(b, s_k, 2 * h * d)).astype(np.float32)
    dense = [qkv[..., :h * d], kv[..., :h * d], kv[..., h * d:]]
    views = [torch.from_numpy(qkv)[..., :h * d].unflatten(-1, (h, d)),
             torch.from_numpy(kv)[..., :h * d].unflatten(-1, (h, d)),
             torch.from_numpy(kv)[..., h * d:].unflatten(-1, (h, d))]
    assert not any(x.is_contiguous() for x in views)
    with pltpu.force_tpu_interpret_mode():
        split_j = [np.asarray(jfa._split_heads(jnp.asarray(np.ascontiguousarray(x)), h))
                   for x in dense]
        merge_j = [np.asarray(jfa._merge_heads(jnp.asarray(x), h)) for x in split_j]
    lengths = (s_q, s_k, s_k)
    for split_fn, merge_fn in ((tfa.split_heads_many_plain, tfa.merge_heads_many_plain),
                               (tfa.split_heads_many, tfa.merge_heads_many)):
        split = split_fn(*views)  # (B, S_i, H, D) shapes, head-major bytes
        assert len(split) == 3
        for got, want, s in zip(split, split_j, lengths):
            assert got.shape == (b, s, h, d) and got.transpose(1, 2).is_contiguous()
            np.testing.assert_array_equal(got.transpose(1, 2).reshape(b * h, s, d).numpy(),
                                          want)
        merged = merge_fn(*split)
        assert len(merged) == 3
        for got, want, x, s in zip(merged, merge_j, dense, lengths):
            assert got.shape == (b, s, h, d) and got.is_contiguous()
            np.testing.assert_array_equal(got.reshape(b, s, h * d).numpy(), want)
            np.testing.assert_array_equal(want, x)


@pytest.mark.parametrize("heads", [1, 3])
def test_function_splits_and_merges_heads(monkeypatch, heads):
    """With more than one head the Function relayouts in four grouped calls, as
    _flash_attention_local's relayouts and their VJPs: one split of q, k, v and one merge of
    out forward, one split of dO and one merge of dq, dk, dv backward; with one head it does
    neither."""
    calls = []
    for name in ("split_heads_many", "merge_heads_many"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *xs, _n=name, _r=real:
                            calls.append((_n, len(xs))) or _r(*xs))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(13, (1, 64, heads, 16)))
    out = tfa.flash_attention_differentiable(q, k, v)
    assert out.shape == q.shape and out.is_contiguous()
    forward = list(calls)
    out.square().sum().backward()
    split = heads > 1
    assert forward == [("split_heads_many", 3), ("merge_heads_many", 1)] * split
    assert calls[len(forward):] == [("split_heads_many", 1), ("merge_heads_many", 3)] * split
    for x in (q, k, v):
        assert x.grad.shape == x.shape and x.grad.is_contiguous()
