"""The tilings of the microbenchmark kernels, 11 (``matmul_plan``) and 12 (``variant_plan``),
on the CPU: pure functions of the shapes that the card tests hold equal to the library's
own answers (``lkgd_matmul_plan``, ``lkgd_flash_variant_plan``). Here: the tiles, the
shared memory a block asks for against the 232,448 bytes an H100 grants, and the grid at
the microbenchmarks' shapes and at ragged ones."""

import math

import pytest

from lkgd_torch.ops import flash_variants as fv
from lkgd_torch.ops import matmul as mm

SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100


@pytest.mark.parametrize("m,k,n,tiles", [
    (258048, 320, 320, 16 * 3),    # the qkv shape: 2016 row blocks over 132 blocks
    (258048, 320, 1280, 16 * 10),  # the feed-forward shape
], ids=["unet_level0_qkv", "unet_level0_ff"])
def test_matmul_plan_at_the_microbenchmark_shapes(m, k, n, tiles):
    plan = mm.matmul_plan(m, k, n)
    assert (plan.tile_rows, plan.tile_cols) == (128, 128)
    assert (plan.x_stages, plan.w_stages) == (6, 6)
    assert (plan.blocks, plan.tiles_per_block) == (132, tiles)
    assert plan.x_resident  # K=320: five 64-deep panels of x stay for every column tile
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("m,k,n,blocks,tiles,resident", [
    (258048 + 7, 320, 320, 132, 16 * 3, True),      # one more row block, partly empty
    (133 * 256 + 5, 320, 320, 132, 3 * 3, True),    # a block's second and third row blocks
    (4097, 320, 1280, 33, 10, True),                # 33 row blocks, the last one row
    (1000, 72, 200, 8, 2, True),                    # K=72: a zero-padded second panel
    (1000, 72, 8, 8, 1, True),                      # N=8: one column tile, mostly zeros
    (130, 320, 320, 2, 3, True),
    (300, 1024, 128, 3, 1, False),                  # K > 384: x streamed for every tile
    (1, 8, 8, 1, 1, True),
], ids=["ragged_m", "second_row_block", "wide_n", "k72", "n8", "two_row_blocks", "deep_k",
        "one_row"])
def test_matmul_plan_at_ragged_shapes(m, k, n, blocks, tiles, resident):
    plan = mm.matmul_plan(m, k, n)
    assert plan.blocks == blocks == min(132, math.ceil(m / 128))
    assert plan.tiles_per_block == tiles
    assert plan.x_resident == resident
    assert plan.smem_bytes <= SMEM_LIMIT


def test_matmul_plan_shared_memory():
    """x panels + w ring + the staged output tile + barriers, with the swizzle's slack."""
    plan = mm.matmul_plan(1024, 320, 640)
    assert plan.smem_bytes == (1024 + 6 * 128 * 128 + 6 * 64 * 128 * 2 + 128 * 128 * 2
                               + 16 * (6 + 6)) == 230_592
    assert plan.smem_bytes <= SMEM_LIMIT


def test_matmul_plan_follows_the_card_and_refuses_empty_shapes():
    assert mm.matmul_plan(258048, 320, 320, sm_count=114).blocks == 114
    assert mm.matmul_plan(258048, 320, 320, sm_count=114).tiles_per_block == 18 * 3
    assert mm.matmul_plan(258048, 320, 320, sm_count=131).blocks == 131
    for shape in ((0, 8, 8), (8, 0, 8), (8, 8, 0)):
        with pytest.raises(ValueError):
            mm.matmul_plan(*shape)
    with pytest.raises(ValueError):
        mm.matmul_plan(8, 8, 8, sm_count=0)


def test_matmul_l2_bytes():
    """w read once for every 128-row block of x; x once, or for every column tile where it
    is streamed."""
    x_once = 258048 * 320 * 2
    assert mm.l2_bytes(258048, 320, 1280) == 2016 * 320 * 1280 * 2 + x_once  # 1.65 GB of w
    assert mm.l2_bytes(258048, 320, 320) == 2016 * 320 * 320 * 2 + x_once
    assert mm.l2_bytes(300, 1024, 256) == 3 * 1024 * 256 * 2 + 2 * 300 * 1024 * 2


@pytest.mark.parametrize("tile", fv.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_variant_plan_at_the_microbenchmark_shape(tile):
    plan = fv.variant_plan(140, 9216, tile)
    rows, keys = tile
    assert (plan.tile_rows, plan.key_tile) == tile
    assert plan.warpgroups == rows // 64 and plan.threads == 128 * (rows // 64 + 1)
    assert plan.blocks == 140 * 9216 // rows
    assert plan.smem_bytes == 1024 + rows * 128 + 6 * keys * 128 + 8 * 13
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("bh,s_q,tile,blocks", [(3, 1100, (128, 128), 27), (3, 1100, (64, 64), 54),
                                               (2, 1000, (64, 128), 32), (1, 1, (128, 64), 1)],
                         ids=["ragged", "ragged_64", "s1000", "one_row"])
def test_variant_plan_at_ragged_shapes(bh, s_q, tile, blocks):
    assert fv.variant_plan(bh, s_q, tile).blocks == blocks


def test_variant_plan_default_is_the_production_tile_and_refuses_unbuilt_tiles():
    assert fv.PRODUCTION_TILE == (128, 128)
    assert fv.variant_plan(140, 9216) == fv.variant_plan(140, 9216, (128, 128))
    with pytest.raises(ValueError, match="tile"):
        fv.variant_plan(1, 128, (256, 64))
    with pytest.raises(ValueError):
        fv.variant_plan(0, 128)
