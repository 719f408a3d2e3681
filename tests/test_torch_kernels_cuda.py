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
4096 keys or queries. The head split and merge kernels copy bytes: bit-exact.

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


@pytest.mark.cuda
@pytest.mark.parametrize("maxtrack", [False, True], ids=["flash_bound", "flash_maxtrack"])
@pytest.mark.parametrize("shape", [(2, 1100, 5, 64), (1, 1030, 1, 512), (1, 1024, 2, 40)])
def test_flash_kernel_matches_plain(cuda_device, monkeypatch, shape, maxtrack):
    if maxtrack:
        monkeypatch.setenv("LKGD_FLASH_MAXTRACK", "1")
    q, k, v = _qkv(cuda_device, shape)
    before = dict(tfa.launches)
    got = tfa.flash_attention(q, k, v).float()
    want = tfa.flash_attention_maxtrack_plain(q.float(), k.float(), v.float())
    assert _rel_err(got, want) <= FLASH_TOL
    assert tfa.launches["flash_maxtrack"] == before["flash_maxtrack"] + 1
    assert tfa.launches["flash_bound"] == before["flash_bound"] + (0 if maxtrack else 1)


@pytest.mark.cuda
def test_flash_fallback_recomputes_tiles(cuda_device):
    q, k, v = _qkv(cuda_device, (1, 1100, 2, 64), scale=60.0)
    counter = tfa.recomputed_tiles(cuda_device)
    counter.zero_()
    got = tfa.flash_attention(q, k, v).float()
    want = tfa.flash_attention_maxtrack_plain(q.float(), k.float(), v.float())
    assert counter.item() > 0
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= FLASH_TOL


@pytest.mark.cuda
def test_flash_kernel_reads_projection_memory(cuda_device, monkeypatch):
    """The kernel gets the data pointer of the to_q projection's output: no copy."""
    from lkgd_torch.ops import _build

    lib = _build.library()
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(lib, name)

        def lkgd_flash_fwd(self, q_ptr, *args):
            seen.append(q_ptr)
            return lib.lkgd_flash_fwd(q_ptr, *args)

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 1024, 320), (2, 4 * 1001, 96)])
def test_group_norm_stats_kernel_matches_plain(cuda_device, shape, dtype):
    """Kernel 3 + the fold against the plain statistics: the affine a, b (fp32), within
    1e-4 relative (the plain bf16 form's one-pass fp32 variance cancels to ~1e-5)."""
    x = (_randn(cuda_device, shape, 2.0) + 0.5).to(dtype)
    w, b = _randn(cuda_device, shape[-1:], 0.1, 1) + 1.0, _randn(cuda_device, shape[-1:], 0.1, 2)
    got = gn.group_norm_affine(x, w, b, num_groups=32, eps=1e-5)
    want = gn.group_norm_affine_plain(x.float(), w, b, num_groups=32, eps=1e-5)
    for g, wt in zip(got, want):
        assert (g - wt).abs().max().item() <= 1e-4 * max(1.0, wt.abs().max().item())


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
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=TRAIN_IDS)
def test_flash_lse_forward_matches_plain(cuda_device, monkeypatch, shape, maxtrack):
    if maxtrack:
        monkeypatch.setenv("LKGD_FLASH_MAXTRACK", "1")
    q, k, v = _qkv(cuda_device, shape)
    before = dict(tfa.launches)
    out, lse = tfa.flash_fwd_lse(q, k, v)
    want_out, want_lse = tfa.flash_fwd_lse_maxtrack_plain(q.float(), k.float(), v.float())
    assert lse.shape == (shape[0], shape[2], shape[1]) and lse.dtype == torch.float32
    assert _rel_err(out, want_out) <= FLASH_TOL
    assert (lse - want_lse).abs().max().item() <= 1e-2
    assert tfa.launches["flash_maxtrack_lse"] == before["flash_maxtrack_lse"] + 1
    assert tfa.launches["flash_bound_lse"] == before["flash_bound_lse"] + (0 if maxtrack else 1)
    assert tfa.launches["flash_bound"] == before["flash_bound"]


@pytest.mark.cuda
def test_flash_lse_fallback_recomputes_tiles(cuda_device):
    q, k, v = _qkv(cuda_device, (1, 1100, 2, 64), scale=60.0)
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


@pytest.mark.cuda
def test_flash_training_kernels_refuse_wide_heads(cuda_device):
    q, k, v = _qkv(cuda_device, (1, 1024, 1, 256))
    with pytest.raises(NotImplementedError):
        tfa.flash_fwd_lse(q, k, v)


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
def test_flash_function_launches_split_and_merge(cuda_device):
    """One differentiable call with 5 heads: three splits and one merge forward, one split
    and three merges backward, around kernels 7/8, 9 and 10."""
    q, k, v = (x.requires_grad_() for x in _qkv(cuda_device, (2, 1100, 5, 64)))
    before = dict(tfa.launches)
    out = tfa.flash_attention_differentiable(q, k, v)
    torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    delta = {n: tfa.launches[n] - before[n] for n in tfa.launches}
    assert delta["split_heads"] == 4 and delta["merge_heads"] == 4, delta
    assert delta["flash_bwd_dq"] == 1 and delta["flash_bwd_dkv"] == 1, delta
