"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test is marked ``cuda`` and skips without a CUDA device: the kernels have no CPU
mode. The card's machine has no JAX, which ``tests/conftest.py`` imports, so run them
there with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.

Tolerances: bf16 inputs through the kernel against the plain version in fp32 on the same
(bf16-rounded) inputs, so the difference is the kernel's bf16 rounding of probabilities
and outputs: flash outputs within FLASH_TOL * max|ref|, GroupNorm <= 3e-2; fp32
GroupNorm <= 1e-5 (summation order only). The training kernels: lse within 1e-2 log2
units (summation order and exp2 only: lse is rounded nowhere), and dq, dk, dv within
2e-2 * max|ref|, as the kernels round P and dS to bf16 before their products over up to
4096 keys or queries. The head split and merge kernels copy bytes: bit-exact, one tensor
or three a launch.

The gradient tests hold the autograd Functions of flash attention and GroupNorm against
autograd through the plain versions: on the card an output without a gradient would drop
every path through the op from ``loss.backward()``.
"""

import pytest
import torch

from lkgd_torch.models.layers import Attention, init_params, materialize
from lkgd_torch.ops import flash_attention as tfa
from lkgd_torch.ops import group_norm as gn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _randn(device, shape, scale=1.0, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=g) * scale


def _qkv(device, shape, scale=1.0):
    return [(_randn(device, shape, scale if i < 2 else 1.0, seed=i)).bfloat16()
            for i in range(3)]


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# flash outputs relative to max|ref|: P and the output are rounded to bf16 (at most 4.8e-3
# of max|ref| in chip_smoke.py's cases on an H100)
FLASH_TOL = 1e-2


TRAIN_SHAPES = [(8, 4096, 5, 64), (8, 1024, 10, 64), (2, 1100, 5, 64), (1, 1030, 2, 128)]
TRAIN_IDS = ["unet_level0", "unet_level1", "ragged", "d128"]
# the LSE forward alone also above the backward's D <= 128: every tile width, a last tile
# of one row, and several waves of 64-row blocks at D=512
LSE_SHAPES = TRAIN_SHAPES + [(1, 1024, 2, 40), (1, 129, 3, 64), (1, 1030, 2, 256),
                             (3, 65, 1, 512), (3, 9216, 1, 512)]
LSE_IDS = TRAIN_IDS + ["d40", "one_row_tile", "d256", "d512_short", "d512_waves"]


# S ragged against the 128-row and 128-key tiles (64 above D=128), every tile width the
# kernel is built for, and enough batch x heads x tiles for several waves of 132 blocks; the
# last one CogVideoX-like: 48 heads over a joint sequence no tile divides
FLASH_SHAPES = [(2, 1100, 5, 64), (1, 1030, 1, 512), (1, 1024, 2, 40), (1, 1030, 2, 128),
                (1, 1030, 2, 256), (1, 129, 3, 64), (3, 65, 1, 512), (1, 1100, 1, 8),
                (12, 1100, 5, 64), (3, 9216, 1, 512), (2, 1250, 48, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("maxtrack", [False, True], ids=["flash_bound", "flash_maxtrack"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_matches_plain(cuda_device, monkeypatch, shape, maxtrack):
    if maxtrack:
        monkeypatch.setenv("LKGD_FLASH_MAXTRACK", "1")
    q, k, v = _qkv(cuda_device, shape)
    before = dict(tfa.launches)
    got = tfa.flash_attention(q, k, v).float()
    want = torch.cat([tfa.flash_attention_maxtrack_plain(*(x[i:i + 1].float() for x in (q, k, v)))
                      for i in range(shape[0])])
    assert _rel_err(got, want) <= FLASH_TOL
    assert tfa.launches["flash_maxtrack"] == before["flash_maxtrack"] + 1
    assert tfa.launches["flash_bound"] == before["flash_bound"] + (0 if maxtrack else 1)
    assert tfa.launches["flash_key_norm"] == before["flash_key_norm"] + (0 if maxtrack else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("maxtrack", [False, True], ids=["flash_bound", "flash_maxtrack"])
@pytest.mark.parametrize("d,heads", [(64, 5), (512, 1)])
def test_flash_kernel_takes_strided_views_and_other_key_lengths(cuda_device, monkeypatch, d,
                                                                heads, maxtrack):
    """q from one fused projection, k and v as slices of another (S_q != S_k): the tensor
    maps read the views through their strides."""
    if maxtrack:
        monkeypatch.setenv("LKGD_FLASH_MAXTRACK", "1")
    c = heads * d
    q = _randn(cuda_device, (2, 700, 2 * c)).bfloat16()[..., c:].unflatten(-1, (heads, d))
    kv = _randn(cuda_device, (2, 1333, 2 * c), seed=1).bfloat16()
    k, v = (kv[..., i * c:(i + 1) * c].unflatten(-1, (heads, d)) for i in range(2))
    assert not q.is_contiguous() and not k.is_contiguous()
    got = tfa.flash_attention(q, k, v)
    assert got.shape == q.shape
    want = tfa.flash_attention_maxtrack_plain(q.float(), k.float(), v.float())
    assert _rel_err(got, want) <= FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1100, 2, 64), (1, 1100, 1, 512)], ids=["d64", "d512"])
def test_flash_fallback_recomputes_tiles(cuda_device, shape):
    q, k, v = _qkv(cuda_device, shape, scale=60.0)
    counter = tfa.recomputed_tiles(cuda_device)
    counter.zero_()
    got = tfa.flash_attention(q, k, v).float()
    want = tfa.flash_attention_maxtrack_plain(q.float(), k.float(), v.float())
    assert counter.item() > 0
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("lse", [False, True], ids=["inference", "lse"])
@pytest.mark.parametrize("shape", [(1, 1100, 2, 64), (1, 1100, 1, 512)], ids=["d64", "d512"])
def test_one_call_bound_forward_on_the_fallback_input(cuda_device, monkeypatch, shape, lse):
    """The bound forward is one call into C: key norms, bound kernel and guard. On the
    huge-norm input every row underflows the bound, so the guard recomputes every tile and
    the outputs carry the bits of the max-tracking kernel alone; one launch of each."""
    q, k, v = _qkv(cuda_device, shape, scale=60.0)
    fwd = tfa.flash_fwd_lse if lse else tfa.flash_attention
    suffix = "_lse" if lse else ""
    counter = tfa.recomputed_tiles(cuda_device)
    counter.zero_()
    before = dict(tfa.launches)
    got = fwd(q, k, v)
    torch.cuda.synchronize()
    b, s, h, d = shape
    tiles = b * h * -(-s // tfa.flash_plan(b, s, s, h, d, lse).tile_rows)
    assert counter.item() == tiles
    delta = {n: tfa.launches[n] - before[n] for n in tfa.launches}
    assert delta["flash_key_norm"] == delta["flash_bound" + suffix] == 1, delta
    assert delta["flash_maxtrack" + suffix] == 1, delta
    monkeypatch.setenv("LKGD_FLASH_MAXTRACK", "1")
    want = fwd(q, k, v)
    for g, w in zip(got if lse else (got,), want if lse else (want,)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["flash_fwd_lse", "split_heads_many", "group_norm"])
def test_kernels_launch_from_a_fresh_thread(cuda_device, call):
    """A launch of the port's may be the first CUDA call of its thread, as on autograd's
    backward thread when it recomputes a checkpointed forward: the entry makes the
    device's context current before ``cuTensorMapEncodeTiled`` runs (and before the
    GroupNorm entry's memset and launches). Same bits as the launch from the main thread."""
    import threading

    if call == "group_norm":
        x, w, b = _gn_inputs(cuda_device, (3, 1001, 96), torch.bfloat16)

        def fn():
            return (gn.group_norm(x, w, b, num_groups=32, eps=1e-5, act="silu"),)
    else:
        q, k, v = _qkv(cuda_device, (2, 1100, 5, 64))

        def fn():
            return getattr(tfa, call)(q, k, v)
    want = fn()
    result = {}

    def run():
        try:
            result["got"] = fn()
            torch.cuda.synchronize()
        except Exception as e:  # handed to the main thread, which raises it
            result["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    if "error" in result:
        raise result["error"]
    assert all(torch.equal(g, w) for g, w in zip(result["got"], want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1100, 5, 64), (3, 777, 1, 512), (1, 100, 2, 40)])
def test_key_norm_kernel_matches_plain(cuda_device, shape):
    """The key-norm kernel against its plain version on a strided view: fp32 sums of
    squares in another order (rtol 1e-5)."""
    b, s, h, d = shape
    k = _randn(cuda_device, (b, s, 2 * h * d), 3.0).bfloat16()[..., h * d:].unflatten(-1, (h, d))
    before = tfa.launches["flash_key_norm"]
    got = tfa.key_norm_max(k)
    assert got.shape == (b, h) and got.dtype == torch.float32
    torch.testing.assert_close(got, tfa.key_norm_max_plain(k), rtol=1e-5, atol=0)
    assert tfa.launches["flash_key_norm"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 64, 128, 256, 512])
def test_flash_plan_is_the_kernels_tiling(cuda_device, d):
    """The host-side plan and the library agree on tile rows and shared memory, and the
    card grants that much to a block."""
    from lkgd_torch.ops import _build

    lib = _build.library()
    plan = tfa.flash_plan(1, 1024, 1024, 1, d)
    assert plan.tile_rows == lib.lkgd_flash_block_rows(d, 0)
    assert plan.smem_bytes == lib.lkgd_flash_smem_bytes(d)
    assert plan.smem_bytes <= torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert tfa.flash_plan(1, 1024, 1024, 1, d, lse=True).tile_rows == lib.lkgd_flash_block_rows(d, 1)


@pytest.mark.cuda
def test_flash_kernel_reads_projection_memory(cuda_device, monkeypatch):
    """The kernel gets the data pointer of the to_q projection's output: no copy."""
    from lkgd_torch.ops import _build

    lib = _build.library()
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def lkgd_flash_forward(self, q_ptr, *args):
            seen.append(q_ptr)
            return lib.lkgd_flash_forward(q_ptr, *args)

    monkeypatch.setattr(_build, "library", lambda: Spy())
    attn = materialize(lambda: Attention(64, heads=2, dim_head=32), cuda_device, torch.bfloat16)
    init_params(attn, torch.Generator(device=cuda_device).manual_seed(0))
    outputs = []
    attn.to_q.register_forward_hook(lambda m, i, o: outputs.append(o))
    with torch.no_grad():
        attn(_randn(cuda_device, (1, 1024, 64)).bfloat16())
    assert seen and seen[0] == outputs[0].data_ptr()


@pytest.mark.cuda
def test_flash_kernel_rejects_fp32(cuda_device):
    q, k, v = (x.float() for x in _qkv(cuda_device, (1, 1024, 1, 64)))
    with pytest.raises(TypeError):
        tfa.flash_attention(q, k, v)


def _gn_inputs(device, shape, dtype, mean=0.5, std=2.0):
    x = (_randn(device, shape, std) + mean).to(dtype)
    w = (_randn(device, shape[-1:], 0.1, 1) + 1.0).to(dtype)
    return x, w, _randn(device, shape[-1:], 0.1, 2).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 1024, 320), (2, 4 * 1001, 96), (28, 9216, 320),
                                   (3, 1001, 96), (2, 777, 128)])
def test_group_norm_stats_kernel_matches_plain(cuda_device, shape, dtype):
    """Kernel 3, statistics and fold on the device, against the plain statistics: the
    affine a, b (fp32), within 1e-4 relative (the plain bf16 form's one-pass fp32 variance
    cancels to ~1e-5); one launch, and weight and bias in the other type give the same."""
    x, w, b = _gn_inputs(cuda_device, shape, dtype)
    before = dict(gn.launches)
    got = gn.group_norm_affine(x, w, b, num_groups=32, eps=1e-5)
    assert gn.launches["gn_stats"] == before["gn_stats"] + 1
    assert gn.launches["gn_apply"] == before["gn_apply"]
    want = gn.group_norm_affine_plain(x.float(), w.float(), b.float(), num_groups=32, eps=1e-5)
    for g, wt in zip(got, want):
        assert g.shape == wt.shape and g.dtype == torch.float32
        assert (g - wt).abs().max().item() <= 1e-4 * max(1.0, wt.abs().max().item())
    other = torch.float32 if w.dtype == torch.bfloat16 else torch.bfloat16
    w2, b2 = w.to(other), b.to(other)
    want2 = gn.group_norm_affine_plain(x.float(), w2.float(), b2.float(), num_groups=32,
                                       eps=1e-5)
    for g, wt in zip(gn.group_norm_affine(x, w2, b2, num_groups=32, eps=1e-5), want2):
        assert (g - wt).abs().max().item() <= 1e-4 * max(1.0, wt.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_stats_are_bit_identical_across_calls(cuda_device, dtype):
    """The last block of a sample folds its chunks in a fixed order: whichever block came
    last, three calls give the same bits."""
    x, w, b = _gn_inputs(cuda_device, (28, 9216, 320), dtype)
    first = gn.group_norm_affine(x, w, b, num_groups=32, eps=1e-5)
    for _ in range(2):
        again = gn.group_norm_affine(x, w, b, num_groups=32, eps=1e-5)
        assert all(torch.equal(g, f) for g, f in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_stats_keep_precision_when_the_mean_dwarfs_the_std(cuda_device, eps):
    """fp32 with mean 1e3 and std 1: the kernel's shifted sums and Chan merges against an
    fp64 two-pass reference, within 1e-4 relative."""
    x, w, b = _gn_inputs(cuda_device, (3, 1001, 96), torch.float32, mean=1e3, std=1.0)
    got = gn.group_norm_affine(x, w, b, num_groups=32, eps=eps)
    xg = x.double().view(3, 1001, 32, 3)
    mean = xg.mean(dim=(1, 3))
    inv = torch.rsqrt(((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3)) + eps)
    a = inv.repeat_interleave(3, dim=-1) * w.double()
    want = (a, b.double() - mean.repeat_interleave(3, dim=-1) * a)
    for g, wt in zip(got, want):
        assert (g.double() - wt).abs().max().item() <= 1e-4 * wt.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(3, 1001, 96), (28, 2304, 320)])
def test_group_norm_forward_matches_plain(cuda_device, shape, dtype, tol, act):
    """One forward from one call into C (statistics, fold, normalise) against the plain
    GroupNorm in fp32 on the same inputs; one launch of each kernel."""
    x, w, b = _gn_inputs(cuda_device, shape, dtype)
    before = dict(gn.launches)
    got = gn.group_norm(x, w, b, num_groups=32, eps=1e-6, act=act)
    assert got.dtype == dtype and got.shape == x.shape
    assert {k: gn.launches[k] - before[k] for k in before} == {"gn_stats": 1, "gn_apply": 1}
    want = gn.group_norm_plain(x.float(), w.float(), b.float(), num_groups=32, eps=1e-6,
                               act=act)
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_group_norm_one_sample_past_2_24_rows(cuda_device):
    """N=1 over M = 2^24 + 1001 rows (the CogVideoX decode normalises a whole clip, up to
    49 x 480 x 720 rows): the stats plan stays within the grid, a, b within 1e-4 relative and
    the forward within the bf16 tolerance of the plain version, compared in row blocks."""
    shape = (1, 2 ** 24 + 1001, 64)
    x, w, b = _gn_inputs(cuda_device, shape, torch.bfloat16)
    plan = gn.chunk_plan(*shape, 32, 2)
    assert plan.n_chunks <= 65535 and plan.n_chunks * plan.rows_per_chunk >= shape[1]
    got_ab = gn.group_norm_affine(x, w, b, num_groups=32, eps=1e-6)
    want_ab = gn.group_norm_affine_plain(x, w, b, num_groups=32, eps=1e-6)
    for g, wt in zip(got_ab, want_ab):
        assert (g - wt).abs().max().item() <= 1e-4 * max(1.0, wt.abs().max().item())
    got = gn.group_norm(x, w, b, num_groups=32, eps=1e-6, act="silu")
    step = 1 << 22
    for i in range(0, shape[1], step):
        want = gn.group_norm_apply_plain(x[:, i:i + step], *want_ab, "silu")
        assert (got[:, i:i + step].float() - want.float()).abs().max().item() <= 3e-2


@pytest.mark.cuda
def test_group_norm_forward_is_three_device_operations(cuda_device):
    """One GroupNorm forward on the card enqueues at most three device operations (the
    tickets' memset, the statistics with their fold, the normalise pass), counted under
    ``torch.profiler``; no PyTorch arithmetic runs between the two kernels."""
    from lkgd_torch.experiments.group_norm_ab import profiled

    x, w, b = _gn_inputs(cuda_device, (28, 2304, 320), torch.bfloat16)
    before = dict(gn.launches)
    prof = profiled(lambda: gn.group_norm(x, w, b, num_groups=32, eps=1e-5, act="silu"),
                    calls=1)
    assert prof["ops"] <= 3, prof
    assert any("gn_stats_kernel" in k for k in prof["ms"]), prof
    assert any("gn_apply_kernel" in k for k in prof["ms"]), prof
    # the profiler's warm-up call and the profiled one
    assert gn.launches["gn_stats"] - before["gn_stats"] == 2
    assert gn.launches["gn_apply"] - before["gn_apply"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-5)])
def test_group_norm_apply_kernel_matches_plain(cuda_device, dtype, tol, act):
    x = (_randn(cuda_device, (3, 1001, 96), 2.0) + 0.5).to(dtype)
    w, b = _randn(cuda_device, (96,), 0.1, 1) + 1.0, _randn(cuda_device, (96,), 0.1, 2)
    a_, b_ = gn.group_norm_affine_plain(x.float(), w, b, num_groups=32, eps=1e-5)
    got = gn.group_norm_apply(x, a_, b_, act)
    assert got.dtype == dtype
    want = gn.group_norm_apply_plain(x.float(), a_, b_, act)
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("maxtrack", [False, True], ids=["flash_bound_lse", "flash_maxtrack_lse"])
@pytest.mark.parametrize("shape", LSE_SHAPES, ids=LSE_IDS)
def test_flash_lse_forward_matches_plain(cuda_device, monkeypatch, shape, maxtrack):
    if maxtrack:
        monkeypatch.setenv("LKGD_FLASH_MAXTRACK", "1")
    q, k, v = _qkv(cuda_device, shape)
    before = dict(tfa.launches)
    out, lse = tfa.flash_fwd_lse(q, k, v)
    want_out, want_lse = _lse_plain_by_rows(q, k, v)
    assert lse.shape == (shape[0], shape[2], shape[1]) and lse.dtype == torch.float32
    assert _rel_err(out, want_out) <= FLASH_TOL
    assert (lse - want_lse).abs().max().item() <= 1e-2
    assert tfa.launches["flash_maxtrack_lse"] == before["flash_maxtrack_lse"] + 1
    assert tfa.launches["flash_bound_lse"] == before["flash_bound_lse"] + (0 if maxtrack else 1)
    assert tfa.launches["flash_key_norm"] == before["flash_key_norm"] + (0 if maxtrack else 1)
    assert tfa.launches["flash_bound"] == before["flash_bound"]


def _lse_plain_by_rows(q, k, v):
    """``flash_fwd_lse_maxtrack_plain`` in fp32 a batch row at a time (its logits are
    (H, S_q, S_k) fp32 a row)."""
    rows = [tfa.flash_fwd_lse_maxtrack_plain(*(x[i:i + 1].float() for x in (q, k, v)))
            for i in range(q.shape[0])]
    return torch.cat([r[0] for r in rows]), torch.cat([r[1] for r in rows])


@pytest.mark.cuda
@pytest.mark.parametrize("maxtrack", [False, True], ids=["flash_bound_lse", "flash_maxtrack_lse"])
@pytest.mark.parametrize("d,heads", [(64, 5), (512, 1)])
def test_flash_lse_forward_takes_strided_views_and_other_key_lengths(cuda_device, monkeypatch, d,
                                                                     heads, maxtrack):
    """q from one fused projection, k and v as slices of another (S_q != S_k), and the
    head-major copies the autograd Function hands over: the tensor maps read each view
    through its strides, and out comes in q's layout."""
    if maxtrack:
        monkeypatch.setenv("LKGD_FLASH_MAXTRACK", "1")
    c = heads * d
    q = _randn(cuda_device, (2, 700, 2 * c)).bfloat16()[..., c:].unflatten(-1, (heads, d))
    kv = _randn(cuda_device, (2, 1333, 2 * c), seed=1).bfloat16()
    k, v = (kv[..., i * c:(i + 1) * c].unflatten(-1, (heads, d)) for i in range(2))
    assert not q.is_contiguous() and not k.is_contiguous()
    want_out, want_lse = tfa.flash_fwd_lse_maxtrack_plain(q.float(), k.float(), v.float())
    head_major = [tfa.split_heads(x).transpose(1, 2) for x in (q, k, v)]
    for views in ((q, k, v), head_major):
        out, lse = tfa.flash_fwd_lse(*views)
        assert out.shape == q.shape and lse.shape == (2, heads, 700) and lse.is_contiguous()
        assert _rel_err(out, want_out) <= FLASH_TOL
        assert (lse - want_lse).abs().max().item() <= 1e-2
    assert out.transpose(1, 2).is_contiguous()  # head-major, as q was


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1100, 2, 64), (1, 1100, 1, 512)], ids=["d64", "d512"])
def test_flash_lse_fallback_recomputes_tiles(cuda_device, shape):
    q, k, v = _qkv(cuda_device, shape, scale=60.0)
    counter = tfa.recomputed_tiles(cuda_device)
    counter.zero_()
    out, lse = tfa.flash_fwd_lse(q, k, v)
    want_out, want_lse = tfa.flash_fwd_lse_maxtrack_plain(q.float(), k.float(), v.float())
    assert counter.item() > 0
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _rel_err(out, want_out) <= FLASH_TOL
    # lse reaches ~2e4 log2 units here: the fp32 logits carry ~1e-3 of rounding
    assert (lse - want_lse).abs().max().item() <= 1e-2 * max(1.0, want_lse.abs().max().item() / 1e3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_flash_backward_kernels_match_plain(cuda_device, shape):
    q, k, v = _qkv(cuda_device, shape)
    do = _randn(cuda_device, shape, seed=3).bfloat16()
    out, lse = tfa.flash_fwd_lse(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    before = dict(tfa.launches)
    got = tfa.flash_bwd(q, k, v, do, lse, delta)
    want = tfa.flash_bwd_plain(q.float(), k.float(), v.float(), do.float(), lse, delta)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16, name
        assert _rel_err(g, w) <= 2e-2, (name, _rel_err(g, w))
    assert tfa.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert tfa.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1


def _bwd_args(device, q, k, v, seed=3):
    """dO (in q's layout, dense) and the lse and delta the autograd Function would hand the
    backward kernels: lse from the LSE forward, delta = rowsum(dO * O) in fp32."""
    do = _randn(device, q.shape, seed=seed).bfloat16()
    out, lse = tfa.flash_fwd_lse(q, k, v)
    return do, lse, (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _check_bwd_against_plain(q, k, v, do, lse, delta):
    got = tfa.flash_bwd(q, k, v, do, lse, delta)
    want = tfa.flash_bwd_plain(q.float(), k.float(), v.float(), do.float(), lse, delta)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16, name
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= 2e-2, (name, _rel_err(g, w))
    return got


# every padded width of the backward (D=8 and 40 into one 64-column panel, 96 into two), a
# 1100-query call against 1030 keys (both ragged against their tiles), and 540 blocks of
# each kernel: four waves of 132
BWD_SHAPES = [((1, 1030, 2, 8), 1030), ((1, 1024, 2, 40), 1024), ((2, 700, 3, 96), 700),
              ((2, 1100, 5, 64), 1030), ((12, 1100, 5, 64), 1100)]
BWD_IDS = ["d8", "d40", "d96", "sq_ne_sk", "waves"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s_k", BWD_SHAPES, ids=BWD_IDS)
def test_flash_backward_kernels_match_plain_at_more_shapes(cuda_device, shape, s_k):
    b, _, h, d = shape
    q = _randn(cuda_device, shape).bfloat16()
    k, v = (_randn(cuda_device, (b, s_k, h, d), seed=i).bfloat16() for i in (1, 2))
    _check_bwd_against_plain(q, k, v, *_bwd_args(cuda_device, q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads", [(64, 5), (128, 2)])
def test_flash_backward_kernels_take_strided_views_and_other_key_lengths(cuda_device, d, heads):
    """q and dO as slices of fused projections, k and v as slices of another (S_q != S_k),
    and the head-major copies the autograd Function hands over: the tensor maps read each
    view through its strides, and the same gradients come out."""
    c = heads * d
    q = _randn(cuda_device, (2, 700, 2 * c)).bfloat16()[..., c:].unflatten(-1, (heads, d))
    kv = _randn(cuda_device, (2, 1333, 2 * c), seed=1).bfloat16()
    k, v = (kv[..., i * c:(i + 1) * c].unflatten(-1, (heads, d)) for i in range(2))
    do = _randn(cuda_device, (2, 700, 2 * c), seed=3).bfloat16()[..., :c].unflatten(-1, (heads, d))
    assert not q.is_contiguous() and not k.is_contiguous() and not do.is_contiguous()
    out, lse = tfa.flash_fwd_lse(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = _check_bwd_against_plain(q, k, v, do, lse, delta)
    head_major = [tfa.split_heads(x).transpose(1, 2) for x in (q, k, v, do)]
    again = _check_bwd_against_plain(*head_major, lse, delta)
    for g, h_ in zip(got, again):
        assert torch.equal(g, h_.contiguous())  # the same arithmetic on the same values


@pytest.mark.cuda
def test_flash_backward_from_the_fallback_lse(cuda_device):
    """The huge-norm input: kernel 8 recomputes tiles of kernel 7, and the backward runs
    from that lse (~5e3 log2 units) as the Function would."""
    q, k, v = _qkv(cuda_device, (1, 1100, 2, 64), scale=60.0)
    counter = tfa.recomputed_tiles(cuda_device)
    counter.zero_()
    args = _bwd_args(cuda_device, q, k, v)
    assert counter.item() > 0 and torch.isfinite(args[1]).all()
    _check_bwd_against_plain(q, k, v, *args)


@pytest.mark.cuda
def test_flash_backward_kernels_are_deterministic(cuda_device):
    """No atomics: each output element is written once, in a fixed order, so two launches
    give the same bits."""
    q, k, v = _qkv(cuda_device, (2, 1100, 5, 64))
    args = _bwd_args(cuda_device, q, k, v)
    first = tfa.flash_bwd(q, k, v, *args)
    second = tfa.flash_bwd(q, k, v, *args)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dkv", [False, True], ids=["dq", "dkv"])
@pytest.mark.parametrize("d", [8, 40, 64, 96, 128])
def test_flash_bwd_plan_is_the_kernels_tiling(cuda_device, d, dkv):
    """The host-side backward plan and the library agree on resident rows and shared
    memory, and the card grants that much to a block."""
    from lkgd_torch.ops import _build

    lib = _build.library()
    plan = tfa.flash_bwd_plan(1, 1024, 1024, 1, d, dkv)
    assert plan.tile_rows == lib.lkgd_flash_bwd_block_rows(d, int(dkv))
    assert plan.smem_bytes == lib.lkgd_flash_bwd_smem_bytes(d, int(dkv))
    assert plan.smem_bytes <= torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 512])
def test_flash_training_kernels_refuse_wide_heads(cuda_device, d):
    """Above D=128 the LSE forward runs and matches its plain version; the backward
    kernels refuse, and the autograd Function refuses in its forward already."""
    q, k, v = _qkv(cuda_device, (1, 1024, 1, d))
    out, lse = tfa.flash_fwd_lse(q, k, v)
    want_out, want_lse = tfa.flash_fwd_lse_maxtrack_plain(q.float(), k.float(), v.float())
    assert _rel_err(out, want_out) <= FLASH_TOL
    assert (lse - want_lse).abs().max().item() <= 1e-2
    delta = torch.zeros_like(lse)
    with pytest.raises(NotImplementedError):
        tfa.flash_bwd(q, k, v, out, lse, delta)
    before = dict(tfa.launches)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_differentiable(q.requires_grad_(), k, v)
    assert tfa.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1100, 5, 64), (8, 1024, 10, 64)], ids=["ragged", "unet_level1"])
def test_flash_attention_output_carries_gradient(cuda_device, shape):
    """Through the dispatch, with inputs that require grad: the output has a gradient and
    dq, dk, dv equal autograd through the plain version."""
    from lkgd_torch.ops.attention import dot_product_attention

    q, k, v = (x.requires_grad_() for x in _qkv(cuda_device, shape))
    out = dot_product_attention(q, k, v)
    assert out.requires_grad and out.grad_fn is not None
    do = _randn(cuda_device, shape, seed=4).bfloat16()
    got = torch.autograd.grad(out, (q, k, v), do)
    ref = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(tfa.flash_attention_maxtrack_plain(*ref), ref, do.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= 2e-2, (name, _rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-4)])
def test_group_norm_output_carries_gradient(cuda_device, dtype, tol, act):
    """x, weight and bias grads of the kernels' GroupNorm equal autograd through the plain
    version (bf16: the output's rounding; fp32: summation order)."""
    x = (_randn(cuda_device, (4, 1001, 96), 2.0) + 0.5).to(dtype).requires_grad_()
    w = (_randn(cuda_device, (96,), 0.1, 1) + 1.0).to(dtype).requires_grad_()
    b = _randn(cuda_device, (96,), 0.1, 2).to(dtype).requires_grad_()
    before = dict(gn.launches)
    y = gn.group_norm(x, w, b, num_groups=32, eps=1e-5, act=act)
    assert y.requires_grad and y.grad_fn is not None
    assert gn.launches["gn_stats"] == before["gn_stats"] + 1
    g = _randn(cuda_device, y.shape, seed=5).to(dtype)
    got = torch.autograd.grad(y, (x, w, b), g)
    ref = [t.detach().float().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(gn.group_norm_plain(*ref, num_groups=32, eps=1e-5, act=act),
                               ref, g.float())
    for name, gt, wt in zip(("dx", "dweight", "dbias"), got, want):
        assert _rel_err(gt, wt) <= tol, (name, _rel_err(gt, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_split_merge_heads_kernels_match_plain(cuda_device, shape):
    """Kernels 5 and 6, bit for bit: split a strided view (a slice of a fused projection)
    into head-major order and merge it back."""
    b, s, h, d = shape
    x = _randn(cuda_device, (b, s, 2 * h * d)).bfloat16()[..., h * d:].unflatten(-1, (h, d))
    before = dict(tfa.launches)
    split = tfa.split_heads(x)
    assert split.shape == (b, h, s, d) and split.is_contiguous()
    assert torch.equal(split, tfa.split_heads_plain(x))
    merged = tfa.merge_heads(split)
    assert merged.shape == x.shape and merged.is_contiguous()
    assert torch.equal(merged, x)
    assert tfa.launches["split_heads"] == before["split_heads"] + 1
    assert tfa.launches["merge_heads"] == before["merge_heads"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_grouped_split_merge_heads_kernels_match_plain(cuda_device, shape):
    """One launch of kernel 5 over three strided views of different lengths (q from a
    fused qkv projection, two slices of a fused kv projection) and one launch of kernel 6
    back, bit for bit against the plain versions."""
    b, s, h, d = shape
    c = h * d
    lengths = (s, s // 2 + 3, s + 17)
    qkv = _randn(cuda_device, (b, lengths[0], 3 * c)).bfloat16()
    kv = _randn(cuda_device, (b, lengths[1] + lengths[2], 2 * c), seed=1).bfloat16()
    xs = (qkv[..., c:2 * c].unflatten(-1, (h, d)),
          kv[:, :lengths[1], :c].unflatten(-1, (h, d)),
          kv[:, lengths[1]:, c:].unflatten(-1, (h, d)))
    assert not any(x.is_contiguous() for x in xs)
    before = dict(tfa.launches)
    split = tfa.split_heads_many(*xs)
    for got, want, n in zip(split, tfa.split_heads_many_plain(*xs), lengths):
        assert got.shape == (b, n, h, d) and got.transpose(1, 2).is_contiguous()
        assert torch.equal(got, want)
    merged = tfa.merge_heads_many(*split)
    for got, x, n in zip(merged, xs, lengths):
        assert got.shape == (b, n, h, d) and got.is_contiguous()
        assert torch.equal(got, x)
    assert tfa.launches["split_heads"] == before["split_heads"] + 1
    assert tfa.launches["merge_heads"] == before["merge_heads"] + 1


@pytest.mark.cuda
def test_grouped_relayout_refuses(cuda_device):
    """What one launch does not take raises before the launch: four tensors, tensors that
    differ in heads, and rows that are not 16-byte aligned."""
    x = _randn(cuda_device, (1, 64, 2, 64)).bfloat16()
    with pytest.raises(ValueError):
        tfa.split_heads_many(x, x, x, x)
    with pytest.raises(ValueError):
        tfa.split_heads_many(x, x[:, :, :1])
    with pytest.raises(ValueError):
        tfa.split_heads(x[..., :4])


@pytest.mark.cuda
def test_flash_function_launches_split_and_merge(cuda_device):
    """One differentiable call with 5 heads: a grouped split of q, k, v and the merge of
    out forward, the split of dO and a grouped merge of dq, dk, dv backward, around
    kernels 7/8, 9 and 10."""
    q, k, v = (x.requires_grad_() for x in _qkv(cuda_device, (2, 1100, 5, 64)))
    before = dict(tfa.launches)
    out = tfa.flash_attention_differentiable(q, k, v)
    torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    delta = {n: tfa.launches[n] - before[n] for n in tfa.launches}
    assert delta["split_heads"] == 2 and delta["merge_heads"] == 2, delta
    assert delta["flash_bwd_dq"] == 1 and delta["flash_bwd_dkv"] == 1, delta


# kernel 11 against the fp32 product: fp32 accumulation, one bf16 rounding of the output
# (2^-9 relative), so within 1e-2 of max|ref|
MATMUL_TOL = 1e-2
# K=72 and N=200 / N=8 leave zero-filled panels and masked stores; 133 x 256 + 5 rows
# give a persistent block (132 on an H100) a second and third row block, the last one
# ragged; K=1024 is deeper than the resident x panels and streams x for every tile
MATMUL_SHAPES = [(256, 64, 128), (1000, 72, 200), (130, 320, 320), (4097, 320, 1280),
                 (133 * 256 + 5, 320, 320), (1000, 72, 8), (2048, 320, 1280), (300, 1024, 128)]
MATMUL_IDS = ["tile_multiple", "ragged_all", "ragged_m", "wide_n", "second_row_block", "n8",
              "n1280", "deep_k_streamed"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES, ids=MATMUL_IDS)
def test_blocked_matmul_kernel_matches_plain(cuda_device, m, k, n):
    """Kernel 11 against the fp32 product, within MATMUL_TOL of max|ref|."""
    from lkgd_torch.ops import matmul as mm

    x = _randn(cuda_device, (m, k)).bfloat16()
    w = _randn(cuda_device, (k, n), seed=1).bfloat16()
    before = mm.launches["blocked_matmul"]
    got = mm.blocked_matmul(x, w)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel_err(got, mm.blocked_matmul_plain(x.float(), w.float())) <= MATMUL_TOL
    assert mm.launches["blocked_matmul"] == before + 1


@pytest.mark.cuda
def test_blocked_matmul_kernel_is_deterministic(cuda_device):
    """Each output is one sum in a fixed order: two launches are bit-identical."""
    from lkgd_torch.ops import matmul as mm

    x = _randn(cuda_device, (133 * 256 + 5, 320)).bfloat16()
    w = _randn(cuda_device, (320, 1280), seed=1).bfloat16()
    assert torch.equal(mm.blocked_matmul(x, w), mm.blocked_matmul(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES + [(258048, 320, 320), (258048, 320, 1280)],
                         ids=MATMUL_IDS + ["unet_level0_qkv", "unet_level0_ff"])
def test_matmul_plan_is_the_kernels_tiling(cuda_device, m, k, n):
    """``matmul_plan`` and the library agree on the tiling on this card, and the card
    grants that much shared memory to a block."""
    import ctypes

    from lkgd_torch.ops import _build
    from lkgd_torch.ops import matmul as mm

    props = torch.cuda.get_device_properties(cuda_device)
    got = (ctypes.c_int * 8)()
    assert _build.library().lkgd_matmul_plan(m, k, n, props.multi_processor_count, got) == 0
    plan = mm.matmul_plan(m, k, n, props.multi_processor_count)
    assert list(got) == [int(v) for v in plan]
    assert plan.smem_bytes <= props.shared_memory_per_block_optin


@pytest.mark.cuda
def test_blocked_matmul_kernel_refuses(cuda_device):
    from lkgd_torch.ops import matmul as mm

    x, w = _randn(cuda_device, (64, 64)), _randn(cuda_device, (64, 64))
    with pytest.raises(TypeError):
        mm.blocked_matmul(x, w)
    with pytest.raises(ValueError, match="K = 20"):
        mm.blocked_matmul(x[:, :20].bfloat16().contiguous(), w[:20].bfloat16())
    with pytest.raises(ValueError, match="N = 20"):
        mm.blocked_matmul(x.bfloat16(), w[:, :20].bfloat16().contiguous())
    with pytest.raises(ValueError, match="dense"):
        mm.blocked_matmul(x.bfloat16().t(), w.bfloat16())


# kernel 12 relative to max|ref|: P and the output are rounded to bf16; the packed bf16
# exp2 may differ from PyTorch's by an ulp per probability
VARIANT_TOL = {"base": 1e-2, "prescale": 1e-2, "noexp": 1e-2, "bf16exp": 3e-2,
               "prescale_bf16exp": 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(64, 64), (128, 64), (64, 128), (128, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("mode", ["base", "prescale", "bf16exp", "prescale_bf16exp", "noexp"])
@pytest.mark.parametrize("shape,s_k", [((2, 256, 64), 256), ((3, 1100, 64), 1100),
                                       ((2, 300, 40), 300), ((2, 1000, 64), 1000),
                                       ((2, 1000, 64), 700), ((2, 1000, 32), 1300)],
                         ids=["tile_multiple", "ragged", "d40", "s1000", "sq_gt_sk", "d32_sq_lt_sk"])
def test_flash_variant_kernel_matches_plain(cuda_device, shape, s_k, mode, tile):
    """Kernel 12 against its plain version in every mode and tile, within VARIANT_TOL of
    max|ref|."""
    from lkgd_torch.ops import flash_variants as fv

    bh, _, d = shape
    q = _randn(cuda_device, shape).bfloat16()
    k, v = ((_randn(cuda_device, (bh, s_k, d), seed=i)).bfloat16() for i in (1, 2))
    t = fv.bound_t(q, k)
    before = fv.launches["flash_variant"]
    got = fv.flash_variant(q, k, v, t, mode, tile)
    want = fv.flash_variant_plain(q, k, v, t, mode)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _rel_err(got, want) <= VARIANT_TOL[mode]
    assert fv.launches["flash_variant"] == before + 1


@pytest.mark.cuda
def test_flash_variant_base_matches_the_bound_forward(cuda_device):
    """``base`` at the production tile (128 x 128) with the production bound as t is the
    bound kernel's loop with nothing around it. The production forwards (kernels 1 and 7)
    compute t themselves (|q_i| summed from their Q tile) and sum in another order: against
    them, and against the plain bound version in fp32, FLASH_TOL x max|ref|."""
    from lkgd_torch.ops import flash_variants as fv

    q, k, v = ((_randn(cuda_device, (3, 1100, 64), seed=i)).bfloat16() for i in range(3))
    got = fv.flash_variant(q, k, v, fv.bound_t(q, k), "base", fv.PRODUCTION_TILE).float()
    q4, k4, v4 = q[:, :, None], k[:, :, None], v[:, :, None]
    plain = tfa.flash_attention_bound_plain(q4.float(), k4.float(), v4.float())[:, :, 0]
    assert (got - plain).abs().max().item() <= FLASH_TOL * plain.abs().max().item()
    for production in (tfa.flash_attention(q4, k4, v4), tfa.flash_fwd_lse(q4, k4, v4)[0]):
        production = production[:, :, 0].float()
        assert (got - production).abs().max().item() <= FLASH_TOL * production.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(64, 64), (128, 64), (64, 128), (128, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_flash_variant_plan_is_the_kernels_tiling(cuda_device, tile):
    """``variant_plan`` and the library agree on the tiling, and the card grants that much
    shared memory to a block."""
    import ctypes

    from lkgd_torch.ops import _build
    from lkgd_torch.ops import flash_variants as fv

    got = (ctypes.c_int * 5)()
    assert _build.library().lkgd_flash_variant_plan(tile[0], tile[1], 140, 9216, got) == 0
    plan = fv.variant_plan(140, 9216, tile)
    assert list(got) == [plan.warpgroups, plan.threads, plan.stages, plan.smem_bytes,
                         plan.blocks]
    props = torch.cuda.get_device_properties(cuda_device)
    assert plan.smem_bytes <= props.shared_memory_per_block_optin


@pytest.mark.cuda
def test_flash_variant_kernel_refuses(cuda_device):
    from lkgd_torch.ops import flash_variants as fv

    q = _randn(cuda_device, (1, 128, 128)).bfloat16()
    with pytest.raises(ValueError, match="head dim 128"):
        fv.flash_variant(q, q, q, torch.zeros(1, 128, device=cuda_device))
    q = _randn(cuda_device, (1, 128, 64))
    with pytest.raises(TypeError):
        fv.flash_variant(q, q, q, torch.zeros(1, 128, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("temporal", [False, True], ids=["spatial", "temporal"])
@pytest.mark.parametrize("post", ["conv", "scale", "conv_fuse"])
def test_joint_branch_gpu_matches_cpu(cuda_device, post, temporal):
    """The joint branch at fp32 on the card against the CPU on the same weights (TF32 off;
    rtol 1e-4, atol 2e-4: summation order only). 256 tokens: below the flash dispatch's
    1024, whose kernels take bf16 alone, so ``attn1n`` runs the plain attention here."""
    from lkgd_torch.models.blocks_svd import JointAttentionBranch
    from lkgd_torch.models.configs import JointAttentionConfig, LoraRouter, LoraRule

    torch.backends.cuda.matmul.allow_tf32 = False
    mask = (0, 1, 0, 1)
    joint = JointAttentionConfig(post=post, flip=True, mask=mask, temporal=temporal)
    lora = LoraRouter((LoraRule("*attn1n*", "yx", 2, 2.0, mask),))

    def build(device):
        return materialize(lambda: JointAttentionBranch(64, 2, 32, joint, "b", lora,
                                                        temporal=temporal), device, torch.float32)

    cpu = build("cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    gpu = build(cuda_device)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.randn((len(mask) * 2, 256, 64), generator=gen)
    with torch.no_grad():
        want = cpu(x, 2, not temporal)
        got = gpu(x.to(cuda_device), 2, not temporal).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)


@pytest.mark.cuda
def test_joint_branch_bf16_attends_through_flash(cuda_device):
    """In bf16 at 1024 tokens the spatial branch's ``attn1n`` (K and V from the partner
    stream) goes through the flash kernels, and agrees with the fp32 CPU branch within
    bf16's rounding (3e-2 of max|ref|)."""
    from lkgd_torch.models.blocks_svd import JointAttentionBranch
    from lkgd_torch.models.configs import JointAttentionConfig

    joint = JointAttentionConfig(post="conv", flip=True, mask=(0, 1, 0, 1))
    cpu = materialize(lambda: JointAttentionBranch(64, 2, 32, joint, "b"), "cpu", torch.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    gpu = materialize(lambda: JointAttentionBranch(64, 2, 32, joint, "b"), cuda_device,
                      torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.randn((8, 1024, 64), generator=gen)
    before = tfa.launches["flash_bound"]
    with torch.no_grad():
        want = cpu(x, 2, True)
        got = gpu(x.to(cuda_device, torch.bfloat16), 2, True)
    assert tfa.launches["flash_bound"] == before + 1
    assert _rel_err(got.cpu(), want) <= 3e-2


# ------------------------------------------------------------------ the smooth and trans-training shapes
def _partner(x, frames, mask):
    """The joint branch's partner streams of ``x`` (rows, S, H, D): stream blocks swapped by
    the mask, each partner's frames reversed (``models/blocks_svd.py`` ``_partner_streams``)."""
    from lkgd_torch.models.blocks_svd import _partner_streams
    from lkgd_torch.models.configs import JointAttentionConfig

    rows, s, h, d = x.shape
    joint = JointAttentionConfig(flip=True, mask=mask)
    return _partner_streams(x.reshape(rows, s, h * d), joint, frames, True).view(x.shape)


# smoothing: 4 x 5 chunks of 14 frames at 576x1024 (latent level 0 and 1)
SMOOTH_FLASH = [(280, 9216, 5, 64), (280, 2304, 10, 64)]
SMOOTH_ROWS = [0, 1, 13, 14, 139, 140, 141, 266, 279]  # chunk and stream edges, the last row


@pytest.mark.cuda
@pytest.mark.parametrize("partner", [False, True], ids=["self", "partner_kv"])
@pytest.mark.parametrize("shape", SMOOTH_FLASH, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_at_the_smooth_shapes(cuda_device, shape, partner):
    """Self-attention, and the joint branch's attention with K and V from the partner
    streams (mask (0, 1, 0, 1), frames flipped): sampled rows against the plain version."""
    q, k, v = _qkv(cuda_device, shape)
    if partner:
        k, v = _partner(k, 14, (0, 1, 0, 1)), _partner(v, 14, (0, 1, 0, 1))
    before = dict(tfa.launches)
    got = tfa.flash_attention(q, k, v)
    assert tfa.launches["flash_bound"] == before["flash_bound"] + 1
    assert torch.isfinite(got).all()
    rows = torch.tensor(SMOOTH_ROWS, device=cuda_device)
    want = torch.cat([tfa.flash_attention_maxtrack_plain(*(x[i:i + 1].float() for x in
                                                           (q, k, v))) for i in SMOOTH_ROWS])
    assert _rel_err(got[rows], want) <= FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape", [(280, 9216, 320), (20, 129024, 320)],
                         ids=["spatial_280", "temporal_20"])
def test_group_norm_at_the_smooth_shapes(cuda_device, shape, act):
    """825M elements a call (the spatial and temporal resblocks of a smoothing step): the
    statistics within 1e-4 relative and the forward within 3e-2 of the plain version."""
    x, w, b = _gn_inputs(cuda_device, shape, torch.bfloat16)
    before = dict(gn.launches)
    got = gn.group_norm(x, w, b, num_groups=32, eps=1e-5, act=act)
    assert {k: gn.launches[k] - before[k] for k in before} == {"gn_stats": 1, "gn_apply": 1}
    a, c = gn.group_norm_affine(x, w, b, num_groups=32, eps=1e-5)
    want_a, want_c = gn.group_norm_affine_plain(x.float(), w.float(), b.float(), num_groups=32,
                                                eps=1e-5)
    for g, wt in ((a, want_a), (c, want_c)):
        assert (g - wt).abs().max().item() <= 1e-4 * max(1.0, wt.abs().max().item())
    for i in (0, shape[0] // 2, shape[0] - 1):  # the plain forward a sample at a time
        want = gn.group_norm_plain(x[i:i + 1].float(), w.float(), b.float(), num_groups=32,
                                   eps=1e-5, act=act)
        assert (got[i:i + 1].float() - want).abs().max().item() <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 4096, 5, 64), (16, 1024, 10, 64)],
                         ids=["level0", "level1"])
def test_flash_training_kernels_with_partner_kv(cuda_device, shape):
    """The trans fine-tune's joint branch (one [x, y] pair of 8 frames, mask (0, 1), flip):
    the LSE forward and the dq / dk-dv backward with K and V from the flipped, block-swapped
    partner streams, against the plain versions."""
    q, k, v = _qkv(cuda_device, shape)
    k, v = _partner(k, 8, (0, 1)), _partner(v, 8, (0, 1))
    before = dict(tfa.launches)
    out, lse = tfa.flash_fwd_lse(q, k, v)
    want_out, want_lse = _lse_plain_by_rows(q, k, v)
    assert _rel_err(out, want_out) <= FLASH_TOL
    assert (lse - want_lse).abs().max().item() <= 1e-2
    do, lse, delta = _bwd_args(cuda_device, q, k, v)
    _check_bwd_against_plain(q, k, v, do, lse, delta)
    assert tfa.launches["flash_bound_lse"] == before["flash_bound_lse"] + 2
    assert tfa.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert tfa.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1


# ---------------------------------------------------------------- ControlNet and flow training
_TINY_UNET = dict(block_out_channels=(32, 64),
                  down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
                  up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
                  layers_per_block=1, num_attention_heads=(2, 4), cross_attention_dim=32)


def _twins(build, device, seed):
    """A module on the CPU with every parameter 0.1 x normal, and its copy on ``device``."""
    cpu = build("cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    gpu = build(device)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    return cpu, gpu


def _step_with_grads(step, state, batch, **draws):
    """One train step; returns (loss, the gradients it took, on the CPU)."""
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().cpu().clone()))
        for n, p in state.trainables.items()]
    state, loss = step(state, batch, **draws)
    for h in hooks:
        h.remove()
    return loss.item(), grads


def _adamw_from(start, grads, lr=1e-3):
    """The port's AdamW on the CPU from ``start`` with ``grads`` (None where absent)."""
    from lkgd_torch.training import train_state as ts

    params = torch.nn.ParameterList([torch.nn.Parameter(start[n].clone()) for n in start])
    optimizer = ts.make_optimizer(lr)
    optimizer.init(params)
    for p, name in zip(params, start):
        p.grad = grads[name].clone() if name in grads else None
    optimizer.step()
    return {name: p.detach() for name, p in zip(start, params)}


@pytest.mark.cuda
def test_tiny_controlnet_step_gpu_matches_cpu(cuda_device, monkeypatch):
    """The ControlNet train step (frozen UNet, EMA) at fp32 on the card against the CPU, the
    draws injected: the loss, the gradients (each scaled by its largest entry or by 1% of
    the largest of all: the biases before one-channel GroupNorm groups have rounding-level
    gradients), the update against the CPU's AdamW on the card's gradients (Adam's first
    step amplifies last-bit differences), the EMA; the UNet bit-identical."""
    from lkgd_torch.models.configs import SVDUNetConfig
    from lkgd_torch.models.controlnet_svd import ControlNetSDV, ControlNetSDVConfig
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_torch.training import train_state as ts
    from lkgd_torch.training import variants

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    unets = _twins(lambda d: materialize(lambda: UNetSpatioTemporalCondition(
        SVDUNetConfig(**_TINY_UNET)), d, torch.float32), cuda_device, 1)
    config = ControlNetSDVConfig(unet=SVDUNetConfig(**_TINY_UNET),
                                 conditioning_embedding_out_channels=(16, 32, 96))
    cns = _twins(lambda d: materialize(lambda: ControlNetSDV(config), d, torch.float32),
                 cuda_device, 2)
    g = torch.Generator().manual_seed(3)
    batch = {"latents": torch.randn((2, 2, 8, 8, 4), generator=g) * 0.5,
             "cond_latents": torch.randn((2, 8, 8, 4), generator=g),
             "image_embeddings": torch.randn((2, 1, 32), generator=g),
             "control": torch.rand((2, 2, 32, 32, 3), generator=g)}
    draws = {"sigmas": torch.tensor([0.7, 3.0]), "noise": torch.randn((2, 2, 8, 8, 4), generator=g)}
    out = []
    for unet, controlnet, device in zip(unets, cns, ("cpu", cuda_device)):
        frozen = {n: p.detach().clone() for n, p in unet.named_parameters()}
        state = ts.init_train_state(controlnet, ts.make_optimizer(1e-3), ema=True)
        start = {n: p.detach().cpu().clone() for n, p in state.trainables.items()}
        loss, grads = _step_with_grads(
            variants.make_controlnet_train_step(unet), state,
            {k: v.to(device) for k, v in batch.items()},
            **{k: v.to(device) for k, v in draws.items()})
        assert all(torch.equal(p, frozen[n]) for n, p in unet.named_parameters())
        out.append((loss, grads, {n: p.detach().cpu() for n, p in state.trainables.items()},
                    {n: e.cpu() for n, e in state.ema_params.items()}))
    (loss_c, grads_c, after_c, ema_c), (loss_g, grads_g, after_g, ema_g) = out
    assert abs(loss_g - loss_c) <= 2e-4 + 1e-4 * abs(loss_c)
    assert sorted(grads_g) == sorted(grads_c)
    floor = 1e-2 * max(x.abs().max().item() for x in grads_c.values())
    for name, want in grads_c.items():
        scale = max(floor, want.abs().max().item())
        torch.testing.assert_close(grads_g[name] / scale, want / scale, rtol=1e-4, atol=2e-4,
                                   msg=name)
    want_after = _adamw_from(start, grads_g)
    for name in start:
        torch.testing.assert_close(after_g[name], want_after[name], rtol=1e-4, atol=2e-4,
                                   msg=name)
        torch.testing.assert_close(ema_g[name], ema_c[name], rtol=1e-4, atol=2e-4, msg=name)


@pytest.mark.cuda
def test_tiny_flow_step_gpu_matches_cpu(cuda_device, monkeypatch):
    """The "of_fix" flow batch (tiny UniMatch, a VAE of factor 4, 32x32, 3 frames, the
    augmentation noise given) and an SVD step on it through the dual-``conv_in`` UNet, its
    input convolutions trained, at fp32 on the card against the CPU: the batch, the loss,
    the gradients and the update (against the CPU's AdamW on the card's gradients)."""
    from lkgd_torch.models.configs import SVDUNetConfig, TemporalVAEConfig
    from lkgd_torch.models.unet_svd import UNetSpatioTemporalCondition
    from lkgd_torch.models.unimatch import UniMatchConfig, build_unimatch
    from lkgd_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
    from lkgd_torch.training import flow as tflow
    from lkgd_torch.training import train_state as ts
    from lkgd_torch.utils.optical_flow import make_flow_fn

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    ums = _twins(lambda d: build_unimatch(UniMatchConfig.tiny(), device=d), cuda_device, 4)
    vaes = _twins(lambda d: materialize(lambda: AutoencoderKLTemporalDecoder(TemporalVAEConfig(
        block_out_channels=(32, 64, 64), layers_per_block=1)), d, torch.float32).eval(),
        cuda_device, 5)
    fix = SVDUNetConfig(**_TINY_UNET, in_channels=12, dual_cond_conv_in=True)
    unets = _twins(lambda d: materialize(lambda: UNetSpatioTemporalCondition(fix), d,
                                         torch.float32), cuda_device, 6)
    g = torch.Generator().manual_seed(7)
    frames = torch.rand((2, 3, 32, 32, 3), generator=g) * 2 - 1
    emb = torch.randn((2, 1, 32), generator=g)
    noise = torch.randn((2, 32, 32, 3), generator=g)
    draws = {"sigmas": torch.tensor([0.5, 4.0]), "noise": torch.randn((2, 2, 8, 8, 4), generator=g),
             "dropout_u": torch.tensor([0.95, 0.15])}
    trained = lambda name: "conv_in" in name  # noqa: E731
    out = []
    for um, vae, unet, device in zip(ums, vaes, unets, ("cpu", cuda_device)):
        prep = tflow.make_flow_batch_fn(make_flow_fn(um, (32, 32)), vae, "of_fix")
        batch = prep(frames.to(device), emb.to(device), noise=noise.to(device))
        state = ts.init_train_state(unet, ts.make_optimizer(1e-3, trainable_predicate=trained))
        start = {n: p.detach().cpu().clone() for n, p in state.trainables.items()}
        loss, grads = _step_with_grads(
            ts.make_svd_train_step(ts.SVDTrainConfig(conditioning_dropout_prob=0.3)), state,
            batch, **{k: v.to(device) for k, v in draws.items()})
        out.append(({k: v.cpu() for k, v in batch.items()}, loss, grads,
                    {n: p.detach().cpu() for n, p in state.trainables.items()}))
    (batch_c, loss_c, grads_c, _), (batch_g, loss_g, grads_g, after_g) = out
    for key, want in batch_c.items():
        torch.testing.assert_close(batch_g[key], want, rtol=1e-4, atol=2e-4, msg=key)
    assert batch_g["cond_latents"].shape == (2, 8, 8, 8)
    assert abs(loss_g - loss_c) <= 2e-4 + 1e-4 * abs(loss_c)
    assert sorted(grads_g) == sorted(grads_c) == sorted(start)
    for name, want in grads_c.items():
        scale = want.abs().max().clamp_min(1e-12)
        torch.testing.assert_close(grads_g[name] / scale, want / scale, rtol=1e-4, atol=2e-4,
                                   msg=name)
    want_after = _adamw_from(start, grads_g)
    for name in start:
        torch.testing.assert_close(after_g[name], want_after[name], rtol=1e-4, atol=2e-4,
                                   msg=name)


@pytest.mark.cuda
def test_flash_backward_kernels_at_48_heads_ragged(cuda_device):
    """The CogVideoX fine-tune's 48 heads at 1250 = 9 x 128 + 98 rows: a ragged last tile of
    queries (kernel 10's lse = +inf rows) and of keys (kernel 9's peeled last tile)."""
    q, k, v = _qkv(cuda_device, (1, 1250, 48, 64))
    _check_bwd_against_plain(q, k, v, *_bwd_args(cuda_device, q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["i2v", "t2v"])
def test_tiny_cogvideox_step_gpu_matches_cpu(cuda_device, monkeypatch, mode):
    """The CogVideoX train step (the CLI's LoRA on every attn1 projection and the fusion,
    remat) at fp32 on the card against the CPU, every parameter random and the draws
    injected: the loss, the gradients (scaled as the ControlNet step's), the update against
    the CPU's AdamW on the card's gradients; frozen weights bit-identical."""
    from lkgd_torch.cli import train_cogvideox_lora as cli
    from lkgd_torch.models.cogvideox import CogVideoXTransformer3D
    from lkgd_torch.pipelines.cogvideox_i2v import make_cogvideox_train_step
    from lkgd_torch.training import train_state as ts

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    args = cli.make_parser().parse_args(["--tiny", "--rank", "2", "--lora-alpha", "4",
                                         "--remat", "--mode", mode])
    config = cli.transformer_config(args)
    models = _twins(lambda d: materialize(lambda: CogVideoXTransformer3D(config), d,
                                          torch.float32, fp32=cli.trainable), cuda_device, 4)
    g = torch.Generator().manual_seed(5)
    batch = {"latents": torch.randn((2, 3, 8, 8, 4), generator=g),
             "prompt_embeds": torch.randn((2, 8, 64), generator=g),
             "domain_features": torch.randn((2, 1, 1000), generator=g),
             "flow_features": torch.randn((2, 1, 1000), generator=g)}
    if mode == "i2v":
        batch["image_latents"] = torch.randn((2, 8, 8, 4), generator=g)
    draws = {"timesteps": torch.tensor([37, 901]), "noise": torch.randn((2, 3, 8, 8, 4), generator=g)}
    out = []
    for model, device in zip(models, ("cpu", cuda_device)):
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not cli.trainable(n)}
        optimizer = ts.make_optimizer(1e-3, trainable_predicate=cli.trainable)
        state = ts.init_train_state(model, optimizer)
        start = {n: p.detach().cpu().clone() for n, p in state.trainables.items()}
        loss, grads = _step_with_grads(
            make_cogvideox_train_step(model, optimizer, mode=mode), state,
            {k: v.to(device) for k, v in batch.items()},
            **{k: v.to(device) for k, v in draws.items()})
        assert all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen)
        out.append((loss, grads, {n: p.detach().cpu() for n, p in state.trainables.items()}))
    (loss_c, grads_c, _), (loss_g, grads_g, after_g) = out
    assert abs(loss_g - loss_c) <= 2e-4 + 1e-4 * abs(loss_c)
    assert sorted(grads_g) == sorted(grads_c) == sorted(start) and len(start) == 45
    floor = 1e-2 * max(x.abs().max().item() for x in grads_c.values())
    for name, want in grads_c.items():
        scale = max(floor, want.abs().max().item())
        torch.testing.assert_close(grads_g[name] / scale, want / scale, rtol=1e-4, atol=2e-4,
                                   msg=name)
    want_after = _adamw_from(start, grads_g)
    for name in start:
        torch.testing.assert_close(after_g[name], want_after[name], rtol=1e-4, atol=2e-4,
                                   msg=name)


@pytest.mark.cuda
def test_tiny_t5_gpu_matches_cpu(cuda_device, monkeypatch):
    """The tiny T5 encoder at fp32 on the card against the CPU, on explicit ids with a
    padding mask."""
    from lkgd_torch.models.configs import T5Config
    from lkgd_torch.models.t5_text import build_t5_encoder

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu, gpu = (build_t5_encoder(T5Config.tiny(), torch.float32, d) for d in ("cpu", cuda_device))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    ids = torch.randint(0, 128, (2, 19), generator=g)
    mask = torch.ones(2, 19, dtype=torch.long)
    mask[1, 7:] = 0
    with torch.no_grad():
        want = cpu(ids, mask)
        got = gpu(ids.to(cuda_device), mask.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)


# ---------------------------------------------------------------- SD-2D at 512x512
# the SD2 UNet's spatial self-attention at levels 0 and 1 (CFG rows of one image; 4 rows in
# joint control) and the image VAE's mid-block attention
SD2D_FLASH = [(2, 4096, 5, 64), (2, 1024, 10, 64), (4, 4096, 5, 64), (1, 4096, 1, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("maxtrack", [False, True], ids=["flash_bound", "flash_maxtrack"])
@pytest.mark.parametrize("shape", SD2D_FLASH, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_at_the_sd2d_shapes(cuda_device, monkeypatch, shape, maxtrack):
    if maxtrack:
        monkeypatch.setenv("LKGD_FLASH_MAXTRACK", "1")
    q, k, v = _qkv(cuda_device, shape)
    before = dict(tfa.launches)
    got = tfa.flash_attention(q, k, v)
    assert _rel_err(got, _lse_plain_by_rows(q, k, v)[0]) <= FLASH_TOL
    assert tfa.launches["flash_bound"] == before["flash_bound"] + (0 if maxtrack else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4096, 5, 64), (2, 1024, 10, 64)], ids=["level0", "level1"])
def test_flash_training_kernels_at_the_sd2d_shapes(cuda_device, shape):
    """The SD-2D joint LoRA step's attention (one x/y pair): the LSE forward, dq and dk/dv
    against the plain versions, and the head split and merge bit-exact."""
    q, k, v = _qkv(cuda_device, shape)
    out, lse = tfa.flash_fwd_lse(q, k, v)
    want_out, want_lse = _lse_plain_by_rows(q, k, v)
    assert _rel_err(out, want_out) <= FLASH_TOL
    assert (lse - want_lse).abs().max().item() <= 1e-2
    _check_bwd_against_plain(q, k, v, *_bwd_args(cuda_device, q, k, v))
    split = tfa.split_heads_many(q, k, v)
    assert all(torch.equal(g, w) for g, w in zip(split, tfa.split_heads_many_plain(q, k, v)))
    assert all(torch.equal(g, w) for g, w in zip(tfa.merge_heads_many(*split), (q, k, v)))


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape", [(2, 4096, 320), (2, 1024, 640), (1, 262144, 128)],
                         ids=["unet_level0", "unet_level1", "vae_full_res"])
def test_group_norm_at_the_sd2d_shapes(cuda_device, shape, act):
    """eps 1e-6 (the transformer norms and the VAE): the forward within 3e-2 of the plain
    version in bf16."""
    x, w, b = _gn_inputs(cuda_device, shape, torch.bfloat16)
    got = gn.group_norm(x, w, b, num_groups=32, eps=1e-6, act=act)
    want = gn.group_norm_plain(x.float(), w.float(), b.float(), num_groups=32, eps=1e-6,
                               act=act)
    assert (got.float() - want).abs().max().item() <= 3e-2


@pytest.mark.cuda
def test_tiny_sd2d_unet_gpu_matches_cpu(cuda_device, monkeypatch):
    """The tiny 2D UNet with joint attention, stream-masked LoRA and track fusion at fp32 on
    the card against the CPU, every parameter random (the track scatter adds with atomics on
    the card: equal to rounding)."""
    from lkgd_torch.models.configs import JointAttentionConfig, LoraRouter, LoraRule, UNet2DConfig
    from lkgd_torch.models.unet_2d import UNet2DCondition

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    config = UNet2DConfig(
        block_out_channels=(32, 64), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
        num_attention_heads=(2, 4), cross_attention_dim=32, track_fusion=True,
        joint=JointAttentionConfig(post="conv", mask=(0, 1, 0, 1)),
        lora=LoraRouter((LoraRule("*attn1*", "xy", 2, 4.0, (1, 0, 1, 0)),)))
    models = _twins(lambda d: materialize(lambda: UNet2DCondition(config), d, torch.float32),
                    cuda_device, 7)
    g = torch.Generator().manual_seed(8)
    args = (torch.randn((4, 16, 16, 4), generator=g), torch.tensor([3.0, 999.0, 500.0, 41.0]),
            torch.randn((4, 5, 32), generator=g))
    tracks = (torch.rand((2, 40, 2), generator=g) * 64, torch.rand((2, 40, 2), generator=g) * 64,
              (torch.rand((2, 40), generator=g) > 0.3).float())
    outs = []
    for model, device in zip(models, ("cpu", cuda_device)):
        with torch.no_grad():
            outs.append(model(*(a.to(device) for a in args),
                              tracks=tuple(t.to(device) for t in tracks),
                              track_image_size=(64, 64)).cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=2e-4)
