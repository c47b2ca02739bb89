"""The PyTorch port's brickmap build and line table against the JAX package:
every integer table bit-equal (``meta``, ``brick_idx``, brick words,
``region_lines``, ``macro``, ``macro2``, brick lines)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelengine_tpu.core import brickmap as JB
from voxelengine_tpu.core.bitgrid import BitGrid
from voxelengine_tpu.core.layout import Layout as JL
from voxelengine_tpu.ops import pallas_bigtrace as JP
from voxelengine_tpu_torch.core import brickmap as TB
from voxelengine_tpu_torch.core.layout import Layout as TL
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops import bigtrace as TP
from torch_shared import terrain_128x64x128_f32_o3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port side on one CPU thread: the suite runs several workers at
    once, and torch's default of a thread per core each makes its eager
    loops crawl (results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_bm(bm):
    return {k: np.asarray(getattr(getattr(bm, k), "value", getattr(bm, k)))
            for k in ("meta", "brick_idx", "bricks", "grid_dims", "factor",
                      "coarse_layout", "brick_layout", "dense_slots")}


def _assert_bm_equal(t, j):
    assert t.grid_dims == tuple(j.grid_dims) and t.factor == j.factor
    assert (t.coarse_layout.value, t.brick_layout.value, t.dense_slots) == (
        j.coarse_layout.value, j.brick_layout.value, j.dense_slots)
    np.testing.assert_array_equal(t.meta.numpy(), np.asarray(j.meta))
    np.testing.assert_array_equal(t.brick_idx.numpy(), np.asarray(j.brick_idx))
    np.testing.assert_array_equal(t.bricks.numpy(), np.asarray(j.bricks).view(np.int32))


def _assert_lt_equal(t, j):
    assert t.num_regions == j.num_regions and t.region_dims == tuple(j.region_dims)
    for k in ("region_lines", "macro", "macro2"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)), err_msg=k)


def test_pack_unpack_meta_bit_equal(rng):
    occ = rng.random(500) < 0.7
    bmin = rng.integers(0, 32, (500, 3))
    bmax = rng.integers(0, 32, (500, 3))
    got = TB.pack_meta(torch.from_numpy(occ), torch.from_numpy(bmin), torch.from_numpy(bmax))
    want = np.asarray(JB.pack_meta(jnp.asarray(occ), jnp.asarray(bmin), jnp.asarray(bmax)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(TB.unpack_meta(got), JB.unpack_meta(jnp.asarray(want))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("factor", [2, 5, 6, 8, 32])
def test_full_brick_words_bit_equal(factor):
    np.testing.assert_array_equal(TB._full_brick_words(factor), JB._full_brick_words(factor).view(np.int32))


def test_choose_layout_matches():
    for dims in ((8, 8, 8), (9, 8, 8), (32, 32, 32), (5, 5, 5)):
        for lay in ("LINEAR", "TILED_LINEAR", "TILED_MORTON"):
            assert TB.choose_layout(dims, TL[lay]).name == JB.choose_layout(dims, JL[lay]).name


@pytest.mark.parametrize("factor,layout", [(8, "TILED_LINEAR"), (8, "TILED_MORTON"), (8, "LINEAR"),
                                           (5, "LINEAR"), (32, "TILED_LINEAR")])
def test_slab_to_chunks_bit_equal(rng, factor, layout):
    cy, cx = 2, 3
    slab = rng.random((factor, cy * factor, cx * factor)) < 0.05
    slab[:, :, :factor] = False  # one empty chunk column: bounds sentinel
    got = TB._slab_to_chunks(torch.from_numpy(slab), factor, cy, cx, TL[layout])
    want = JB._slab_to_chunks(jnp.asarray(slab), factor, cy, cx, JL[layout])
    for name, a, b in zip(("occ", "bmin", "bmax", "words"), got, want):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy(), b.view(np.int32) if b.dtype == np.uint32 else b, err_msg=name)


def test_build_brickmap_terrain_compact_bit_equal(tmp_path_factory):
    """The main path's builder at 128x64x128, factor 32, 3 octaves (the
    port's world shared with ``tests/test_torch_macro.py``)."""
    t = terrain_128x64x128_f32_o3(tmp_path_factory)
    j = JB.build_brickmap_terrain_compact((128, 64, 128), 32, octaves=3)
    _assert_bm_equal(t, j)
    assert bool((t.brick_idx == -1).any())  # empty chunks keep no brick
    _assert_lt_equal(TP.make_line_table(t), JP.make_line_table(j))


@pytest.mark.parametrize("dims,factor,coarse", [
    ((64, 64, 64), 8, "LINEAR"),
    ((64, 64, 64), 8, "TILED_LINEAR"),
    ((64, 64, 64), 8, "TILED_MORTON"),
    ((72, 40, 88), 8, "LINEAR"),  # 9 x 5 x 11 chunks: padded regions
    ((40, 24, 56), 8, "LINEAR"),  # 5 x 3 x 7 chunks
    ((60, 60, 60), 5, "LINEAR"),  # partial tail word per brick
])
def test_make_line_table_bit_equal(rng, dims, factor, coarse):
    X, Y, Z = dims
    dense = rng.random((Z, Y, X)) < 0.02
    dense[:, :3, :] = rng.random((Z, 3, X)) < 0.5
    layout = JL.TILED_LINEAR if all(d % 8 == 0 for d in dims) else JL.LINEAR
    j = JB.build_brickmap(BitGrid.from_dense(dense, layout=layout), factor, coarse_layout=JL[coarse])
    t = brickmap_from_numpy(_np_bm(j), device="cpu")
    jl, tl = JP.make_line_table(j), TP.make_line_table(t)
    _assert_lt_equal(tl, jl)
    tl = TP.materialize_brick_lines(t, tl)
    np.testing.assert_array_equal(tl.brick_lines.numpy(), np.asarray(JP.brick_lines_view(j)))
    assert tl.brick_lines.is_contiguous() and tl.brick_lines.shape[1] == 128


@pytest.mark.parametrize("grid", [(8, 1032, 8), (8, 8200, 8)])
def test_make_line_table_macro_levels_over_budget(rng, grid):
    """129 regions tall: L3 is over its word budget (all ones, never skips)
    while L2 is real; 1025 regions tall: L2 is over budget too."""
    n = grid[0] * grid[1] * grid[2]
    occ = rng.random(n) < 0.01
    j = JB.BrickMap(
        meta=jnp.asarray(np.where(occ, (1 << 30) | (31 << 15), 0).astype(np.int32)),
        brick_idx=jnp.asarray(np.where(occ, 0, -1).astype(np.int32)),
        bricks=jnp.zeros((1, 16), jnp.uint32), grid_dims=grid, factor=8,
        coarse_layout=JL.LINEAR, brick_layout=JL.TILED_LINEAR, dense_slots=False,
    )
    t = brickmap_from_numpy(_np_bm(j), device="cpu")
    tl = TP.make_line_table(t)
    _assert_lt_equal(tl, JP.make_line_table(j))
    assert (tl.macro2[TP.MACRO2_WORDS:] == -1).all()
