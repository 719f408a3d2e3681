"""The port's GroupNorm (``lkgd_torch.ops.group_norm``) against ``lkgd_tpu.ops.group_norm``:
the Pallas kernels run in interpret mode (``group_norm(..., interpret=True)``) and the XLA
form ``group_norm_xla``, at fp32. On the CPU the port runs the plain versions of its
kernels; ``fold_chunk_stats``, the plain version of the CUDA stats kernel's fold of its
per-chunk, per-group statistics, is checked here on statistics computed chunk by chunk in
PyTorch, and ``chunk_plan``, the stats kernel's grid, by arithmetic at the models' shapes.
The one-pass form: ``fused_plan``, its grid, by arithmetic and by the form it picks at each
of the models' shapes, and ``group_norm_affine_slabs_plain``, its statistics merged in its
order (each block's (mean, M2), merged in rank order with Chan's formula), against the JAX
package and an fp64 reference.

``GroupNormFunction``, the op with a gradient, is held against ``jax.vjp`` of the JAX
package's custom VJP (Pallas forward in interpret mode, backward through
``group_norm_xla``) and of ``group_norm_xla`` itself.

Tolerance rtol 2e-5, atol 2e-5: fp32 statistics summed in another order (the Pallas path
is one-pass, the port's plain fp32 form two-pass, as the XLA form); the same for the
gradients, which both sides take through the same two-pass formula."""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lkgd_tpu.ops import group_norm as jgn  # noqa: E402

from lkgd_torch.ops import group_norm as tgn  # noqa: E402

SHAPES = {"spatial": (4, 64, 64), "temporal": (2, 4 * 64, 64), "unet level": (2, 144, 320)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    w = (rng.normal(size=shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    b = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    return x, w, b


def _port(x, w, b, **kw):
    return tgn.group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                          num_groups=32, **kw).numpy()


@pytest.mark.parametrize("layout", sorted(SHAPES))
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_matches_pallas_interpret_and_xla(layout, act, eps):
    x, w, b = _inputs(SHAPES[layout])
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    pallas = np.asarray(jgn.group_norm(*args, num_groups=32, eps=eps, act=act, interpret=True))
    xla = np.asarray(jgn.group_norm_xla(*args, num_groups=32, eps=eps, act=act))
    got = _port(x, w, b, eps=eps, act=act)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("act", [None, "silu"])
def test_ragged_rows_match_xla(act):
    """M = 1001 is a multiple of no chunk: the Pallas path refuses it, the port's kernels
    mask the short last chunk."""
    x, w, b = _inputs((3, 1001, 96), seed=1)
    want = np.asarray(jgn.group_norm_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         num_groups=32, eps=1e-5, act=act))
    np.testing.assert_allclose(_port(x, w, b, eps=1e-5, act=act), want, rtol=2e-5, atol=2e-5)


def _chunk_group_stats(x, rows, n_chunks, num_groups=32):
    """Per-chunk, per-group (mean, M2) (N, K, G) as the stats kernel's blocks write them."""
    n, m, c = x.shape
    means, m2s = [], []
    for i in range(n_chunks):
        ch = x[:, i * rows:(i + 1) * rows].reshape(n, -1, num_groups, c // num_groups)
        mean = ch.mean(dim=(1, 3))
        means.append(mean)
        m2s.append(((ch - mean[:, None, :, None]) ** 2).sum(dim=(1, 3)))
    return torch.stack(means, dim=1), torch.stack(m2s, dim=1)


@pytest.mark.parametrize("shape", [(3, 1001, 96), (28, 9216 // 16, 320), (1, 5000, 64)])
def test_fold_of_chunk_statistics(shape):
    """Per-chunk, per-group (mean, M2) as the stats kernel's blocks write them, folded with
    Chan's formula, give the plain two-pass affine."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(shape, seed=2))
    n, m, c = shape
    plan = tgn.chunk_plan(n, m, c, 32, x.element_size())
    mean, m2 = _chunk_group_stats(x, plan.rows_per_chunk, plan.n_chunks)
    assert mean.shape == (n, plan.n_chunks, 32)
    got = tgn.fold_chunk_stats(mean, m2, plan.rows_per_chunk, m, w, b, eps=1e-5)
    want = tgn.group_norm_affine_plain(x, w, b, num_groups=32, eps=1e-5)
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt, rtol=2e-5, atol=2e-5)


def test_fold_keeps_precision_when_the_mean_dwarfs_the_std():
    """|mean| >> std (mean 1e3, std 1) at fp32: the fold of per-chunk (mean, M2) still
    matches the two-pass form, in fp32 and against the same form in fp64."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=(3, 1001, 96)) + 1e3).astype(np.float32))
    w, b = (torch.from_numpy(a) for a in _inputs((3, 1001, 96), seed=8)[1:])
    plan = tgn.chunk_plan(3, 1001, 96, 32, x.element_size())
    assert plan.n_chunks > 1
    mean, m2 = _chunk_group_stats(x, plan.rows_per_chunk, plan.n_chunks)
    got = tgn.fold_chunk_stats(mean, m2, plan.rows_per_chunk, 1001, w, b, eps=1e-5)
    want = tgn.group_norm_affine_plain(x, w, b, num_groups=32, eps=1e-5)
    xg = x.double().reshape(3, 1001, 32, 3)
    mean64 = xg.mean(dim=(1, 3))
    inv64 = torch.rsqrt(((xg - mean64[:, None, :, None]) ** 2).mean(dim=(1, 3)) + 1e-5)
    a64 = inv64.repeat_interleave(3, dim=-1) * w.double()
    want64 = (a64, b.double() - mean64.repeat_interleave(3, dim=-1) * a64)
    for g, wt, w64 in zip(got, want, want64):
        torch.testing.assert_close(g, wt, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(g.double(), w64, rtol=2e-5, atol=2e-5)


# every (N, M, C) GroupNorm of the base clip, the trans clip and the VAE decode, and a
# ragged one
PLAN_SHAPES = [(28, 9216, 320), (56, 9216, 320), (2, 129024, 320), (4, 129024, 320),
               (28, 2304, 640), (28, 576, 1280), (28, 144, 1280), (7, 589824, 128),
               (3, 1001, 96)]


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_chunk_plan_covers_every_row_once_and_channels_in_whole_groups(shape, element_size):
    """The stats kernel's grid: chunks cover M exactly once (only the last one short),
    tiles cover C in whole groups and whole 16-byte vectors (whole rows where a block has
    the threads), a block has the threads for its tile and every thread at least
    ``_UNROLL`` rows to read, and the grid is one wave of the card unless one chunk a
    (sample, tile) is already more."""
    n, m, c = shape
    plan = tgn.chunk_plan(n, m, c, 32, element_size)
    vec, cg = 16 // element_size, c // 32
    rows = plan.rows_per_chunk
    starts = range(0, plan.n_chunks * rows, rows)
    assert sum(min(rows, m - r) for r in starts) == m and all(r < m for r in starts)
    assert c % plan.tile == 0 and plan.tile % cg == 0 and plan.tile % vec == 0
    lanes_x = plan.tile // vec
    assert lanes_x <= tgn._THREADS and (plan.tile == c or 2 * lanes_x > tgn._THREADS)
    assert rows >= tgn._UNROLL * (tgn._THREADS // lanes_x) or plan.n_chunks == 1
    blocks = n * (c // plan.tile) * plan.n_chunks
    assert blocks <= tgn._STATS_BLOCKS or plan.n_chunks == 1


def test_module_reshapes_channels_last_input():
    """layers.GroupNorm normalises (N, H, W, C) as (N, H*W, C), SiLU fused, like the JAX
    module on the same weights."""
    from lkgd_tpu.models.layers import GroupNorm as JaxGroupNorm
    from lkgd_torch.models.layers import GroupNorm

    x, w, b = _inputs((2, 6, 6, 64), seed=3)
    mod = GroupNorm(64, 32, 1e-6, act="silu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
        got = mod(torch.from_numpy(x)).numpy()
    want = np.asarray(JaxGroupNorm(32, 1e-6, act="silu").apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("layout", ["spatial", "temporal"])
def test_function_backward_matches_jax_vjp(layout, act):
    x, w, b = _inputs(SHAPES[layout], seed=4)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    kw = dict(num_groups=32, eps=1e-5, act=act)
    _, vjp_pallas = jax.vjp(lambda *a: jgn.group_norm(*a, interpret=True, **kw), *args)
    _, vjp_xla = jax.vjp(lambda *a: jgn.group_norm_xla(*a, **kw), *args)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = tgn.group_norm(*inputs, **kw)
    assert type(y.grad_fn).__name__ == "GroupNormFunctionBackward"
    got = torch.autograd.grad(y, inputs, torch.from_numpy(g))
    for want in (vjp_pallas(jnp.asarray(g)), vjp_xla(jnp.asarray(g))):
        for name, gt, wt in zip(("dx", "dweight", "dbias"), got, want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=2e-5, atol=2e-5,
                                       err_msg=name)


@pytest.mark.parametrize("needs", ["x", "weight", "none"])
def test_function_only_where_a_gradient_is_wanted(needs):
    """Frozen weights with an input that needs a gradient (the UNet under LoRA) still get
    the Function, and only the grads asked for are made; with nothing requiring grad, or
    under no_grad, the forward kernels run alone."""
    x, w, b = (torch.from_numpy(a) for a in _inputs((2, 64, 64), seed=6))
    wanted = {"x": x, "weight": w}.get(needs)
    if wanted is not None:
        wanted.requires_grad_()
    y = tgn.group_norm(x, w, b, num_groups=32, eps=1e-5, act="silu")
    assert (y.grad_fn is not None) == (wanted is not None)
    if wanted is not None:
        (grad,) = torch.autograd.grad(y.square().sum(), (wanted,))
        assert grad.shape == wanted.shape and torch.isfinite(grad).all()
        with torch.no_grad():
            assert tgn.group_norm(x, w, b, num_groups=32, eps=1e-5).grad_fn is None


# (shape, element size, one pass?): every GroupNorm shape class of the SVD UNet step (levels
# 0-3, spatial over 28 rows of frames and temporal over 2 samples of 14 frames), the trans
# clip's, the VAE's full resolution, its 1/2 and 1/4, SD-2D's level 0 and the fp32
# fine-tune's. In whole 32-byte sectors a level-0 slab needs a cluster of 16, as do level
# 2's temporal norm and the VAE's 1/4; the 960-channel level-0 norm, level 1's temporal one,
# the full and half resolutions and a slab wider than a TMA box need two passes
FORM_SHAPES = [
    ((28, 9216, 320), 2, True), ((28, 9216, 640), 2, True), ((28, 9216, 960), 2, False),
    ((2, 129024, 320), 2, False), ((4, 129024, 320), 2, False),
    ((56, 9216, 320), 2, True), ((28, 2304, 640), 2, True),
    ((28, 2304, 1280), 2, True), ((28, 2304, 1920), 2, True),
    ((2, 32256, 640), 2, False), ((7, 36864, 512), 2, True),
    ((7, 36864, 512), 4, False), ((28, 576, 1280), 2, True),
    ((2, 8064, 1280), 2, True), ((2, 8064, 640), 2, True),
    ((28, 144, 1280), 2, True), ((2, 2016, 1280), 2, True),
    ((7, 589824, 128), 2, False), ((7, 147456, 256), 2, False), ((2, 4096, 320), 2, True),
    ((14, 4096, 320), 4, True), ((14, 1024, 640), 4, True), ((1, 57344, 320), 4, False),
    ((3, 1001, 96), 4, True), ((1, 64, 32 * 264), 2, False)]


@pytest.mark.parametrize("shape,element_size,one_pass", FORM_SHAPES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_fused_plan_picks_one_pass_or_two(shape, element_size, one_pass):
    """One pass where a (sample, slab) fits a cluster of 16 blocks, else two."""
    plan = tgn.fused_plan(*shape, 32, element_size)
    assert (plan is not None) == one_pass, plan


@pytest.mark.parametrize("element_size", [2, 4])
@pytest.mark.parametrize("num_groups", [32, 16])
def test_fused_plan_covers_every_row_once_in_slabs_of_whole_groups(element_size, num_groups):
    """At every shape that gets a plan: the slab is whole groups whose channels make rows of
    whole 32-byte sectors, no wider than a warp's lanes or a TMA box (256 channels); the
    cluster's blocks cover M once (only the last short) in whole TMA boxes of 64 rows; each
    block's two buffers and the form's own shared memory fit 232,448 bytes; a cluster has
    at most 16 blocks."""
    shapes = {s for s, *_ in FORM_SHAPES} | {(1, 64, 64), (3, 1001, 96), (1, 1, 320)}
    planned = 0
    for shape in sorted(shapes):
        n, m, c = shape
        plan = tgn.fused_plan(n, m, c, num_groups, element_size)
        if plan is None:
            continue
        planned += 1
        cg = c // num_groups
        row = plan.slab_groups * cg * element_size
        assert num_groups % plan.slab_groups == 0 and row % 32 == 0
        assert row // 16 <= 32 and plan.slab_groups <= tgn._MAX_SLAB_GROUPS
        assert plan.slab_groups * cg <= 256
        rows, k = plan.rows_per_block, plan.cluster
        assert rows % 64 == 0
        starts = range(0, k * rows, rows)
        assert sum(min(rows, m - r) for r in starts) == m and all(r < m for r in starts)
        assert 1 <= k <= 16
        extra = tgn._fused_extra(plan.slab_groups * cg)
        assert plan.smem_bytes == 2 * rows * row + extra <= 232448
    assert planned >= 10


def test_fused_plan_refuses_what_fits_no_cluster():
    """A group of more channels than a block has threads for, or a sample whose slab needs
    more blocks than the cluster allows, gets no plan; ``group_norm_one_pass`` raises."""
    assert tgn.fused_plan(1, 64, 32 * 1100, 32, 4) is None  # 275 vectors a group
    assert tgn.fused_plan(1, 10 ** 6, 320, 32, 2) is None
    x = torch.zeros(1, 10 ** 6, 320)
    with pytest.raises(ValueError, match="fits no cluster"):
        tgn.group_norm_one_pass(x, torch.ones(320), torch.zeros(320), num_groups=32, eps=1e-5)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape", [(3, 1001, 96), (2, 1024, 320)], ids=["ragged", "chunked"])
def test_one_pass_plain_matches_pallas_interpret_and_xla(shape, act):
    """The one-pass form's plain version (each block's (mean, M2), merged in rank order with
    Chan's formula) against the JAX package at fp32: the Pallas kernels in
    interpret mode where M is a multiple of a chunk (at M = 1001 the JAX wrapper takes the
    XLA form), and ``group_norm_xla``. rtol 1e-4, atol 2e-4: fp32 sums in another order."""
    x, w, b = _inputs(shape, seed=11)
    plan = tgn.fused_plan(*shape, 32, 4)
    assert plan is not None and plan.cluster > 1, plan
    y, a, bb = tgn.group_norm_one_pass(torch.from_numpy(x), torch.from_numpy(w),
                                       torch.from_numpy(b), num_groups=32, eps=1e-5, act=act)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    pallas = np.asarray(jgn.group_norm(*args, num_groups=32, eps=1e-5, act=act, interpret=True))
    xla = np.asarray(jgn.group_norm_xla(*args, num_groups=32, eps=1e-5, act=act))
    np.testing.assert_allclose(y.numpy(), pallas, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(y.numpy(), xla, rtol=1e-4, atol=2e-4)
    want = tgn.group_norm_affine_plain(*(torch.from_numpy(v) for v in (x, w, b)), num_groups=32,
                                       eps=1e-5)
    for got, wt in zip((a, bb), want):
        torch.testing.assert_close(got, wt, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cluster", [1, 3, 8])
def test_one_pass_plain_keeps_precision_when_the_mean_dwarfs_the_std(cluster):
    """|mean| >> std (mean 1e3, std 1) at fp32: the blocks' (mean, M2) merged in rank order
    (the weighted mean first, the M2 about it second) match an fp64 two-pass reference
    within 2e-5 relative, at any number of blocks."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.normal(size=(3, 1001, 96)) + 1e3).astype(np.float32))
    w, b = (torch.from_numpy(a) for a in _inputs((3, 1001, 96), seed=13)[1:])
    rows = math.ceil(1001 / cluster)
    plan = tgn.FusedPlan(4, cluster, rows, 0)
    got = tgn.group_norm_affine_slabs_plain(x, w, b, num_groups=32, eps=1e-5, plan=plan)
    xg = x.double().reshape(3, 1001, 32, 3)
    mean64 = xg.mean(dim=(1, 3))
    inv64 = torch.rsqrt(((xg - mean64[:, None, :, None]) ** 2).mean(dim=(1, 3)) + 1e-5)
    a64 = inv64.repeat_interleave(3, dim=-1) * w.double()
    want64 = (a64, b.double() - mean64.repeat_interleave(3, dim=-1) * a64)
    for g, w64 in zip(got, want64):
        assert ((g.double() - w64).abs().max() / w64.abs().max()).item() <= 2e-5
