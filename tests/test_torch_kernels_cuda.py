"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test is marked ``cuda`` and skips without a CUDA device: the kernels have no CPU
mode. The card's machine has no JAX, which ``tests/conftest.py`` imports, so run them
there with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.

Tolerances: bf16 inputs through the kernel against the plain version in fp32 on the same
(bf16-rounded) inputs, so the difference is the kernel's bf16 rounding of probabilities
and outputs: flash max |d| <= 2e-2 on unit-scale inputs, GroupNorm <= 3e-2; fp32
GroupNorm <= 1e-5 (summation order only).
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
    assert (got - want).abs().max().item() <= 2e-2
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
    assert (got - want).abs().max().item() <= 2e-2


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
