"""The PyTorch port's dense grid, terrain world and brickmap builders against
the JAX package: ``BitGrid`` words and reads, ``generate_world`` words and
``build_brickmap``'s ``meta``/``brick_idx``/``bricks``, all integer and
bit-equal.  Also: every entry point that makes tensors defaults to the card.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelengine_tpu.core import bitgrid as JG
from voxelengine_tpu.core import brickmap as JB
from voxelengine_tpu.core.layout import Layout as JL
from voxelengine_tpu.worldgen import terrain as JT
from voxelengine_tpu_torch import config as tcfg
from voxelengine_tpu_torch.core import bitgrid as TG
from voxelengine_tpu_torch.core import brickmap as TB
from voxelengine_tpu_torch.core.layout import Layout as TL
from voxelengine_tpu_torch.io import interop
from voxelengine_tpu_torch.render import frame as tframe
from voxelengine_tpu_torch.worldgen import terrain as TT

LAYOUTS = ("LINEAR", "TILED_LINEAR", "TILED_MORTON")


def _dense(seed, shape=(16, 24, 32), fill=0.3):
    return np.random.default_rng(seed).random(shape) < fill


def _words(g):
    return np.asarray(g.words).view(np.int32)


def _assert_bm_equal(t, j):
    assert t.grid_dims == tuple(j.grid_dims) and t.factor == j.factor
    assert (t.coarse_layout.value, t.brick_layout.value, t.dense_slots) == (
        j.coarse_layout.value, j.brick_layout.value, j.dense_slots)
    np.testing.assert_array_equal(t.meta.numpy(), np.asarray(j.meta))
    np.testing.assert_array_equal(t.brick_idx.numpy(), np.asarray(j.brick_idx))
    np.testing.assert_array_equal(t.bricks.numpy(), np.asarray(j.bricks).view(np.int32))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bitgrid_from_dense_round_trip_bit_equal(layout):
    dense = _dense(1)
    t = TG.BitGrid.from_dense(torch.from_numpy(dense), TL[layout])
    j = JG.BitGrid.from_dense(jnp.asarray(dense), JL[layout])
    assert t.dims == tuple(j.dims) == (32, 24, 16) and t.num_bits == j.num_bits
    assert t.words.dtype == torch.int32
    np.testing.assert_array_equal(t.words.numpy(), _words(j))
    np.testing.assert_array_equal(t.to_dense().numpy(), dense)
    assert int(t.count()) == int(j.count()) == int(dense.sum())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bitgrid_get_bits_bit_equal(layout):
    """Reads at random coords, out-of-range ones included (False)."""
    dense = _dense(2)
    t = TG.BitGrid.from_dense(torch.from_numpy(dense), TL[layout])
    j = JG.BitGrid.from_dense(jnp.asarray(dense), JL[layout])
    rng = np.random.default_rng(3)
    x, y, z = (rng.integers(-4, n + 4, 3000) for n in (32, 24, 16))
    got = t.get_bits(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z))
    want = np.asarray(j.get_bits(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_order_bits_inverse_bit_equal(layout):
    bits = np.random.default_rng(4).random(16 * 8 * 24) < 0.5
    got = TG.layout_order_bits_inverse(torch.from_numpy(bits), (24, 8, 16), TL[layout])
    want = JG.layout_order_bits_inverse(jnp.asarray(bits), (24, 8, 16), JL[layout])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_popcount32_and_zeros():
    w = np.random.default_rng(5).integers(0, 2**32, 1000, dtype=np.uint32)
    w[:3] = (0, 0xFFFFFFFF, 0x80000000)
    got = TG.popcount32(torch.from_numpy(w.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JG.popcount32(jnp.asarray(w))))
    z = TG.BitGrid.zeros((24, 8, 16), TL.TILED_MORTON, device="cpu")
    np.testing.assert_array_equal(z.words.numpy(), _words(JG.BitGrid.zeros((24, 8, 16), JL.TILED_MORTON)))
    assert int(z.count()) == 0


def test_bitgrid_from_numpy_takes_the_jax_grid_fields():
    j = JG.BitGrid.from_dense(jnp.asarray(_dense(6)), JL.TILED_MORTON)
    t = interop.bitgrid_from_numpy(
        dict(words=np.asarray(j.words), dims=np.asarray(j.dims), layout=j.layout.value), device="cpu")
    assert t.dims == tuple(j.dims) and t.layout is TL.TILED_MORTON
    np.testing.assert_array_equal(t.words.numpy(), _words(j))


# (dims, octaves, layout, slab_z): packed slab by slab, and the dense
# fallbacks (one slab; a slab height the tiles do not divide)
WORLDS = [
    ((32, 16, 32), 2, "TILED_LINEAR", 8),
    ((32, 16, 32), 2, "TILED_MORTON", 16),
    ((24, 16, 16), 3, "LINEAR", 4),
    ((32, 16, 16), 2, "TILED_LINEAR", 16),
    ((16, 16, 24), 2, "TILED_LINEAR", 12),
]


@pytest.mark.parametrize("dims,octaves,layout,slab_z", WORLDS)
def test_generate_world_words_bit_equal(dims, octaves, layout, slab_z):
    t = TT.generate_world(dims, octaves=octaves, layout=TL[layout], slab_z=slab_z, device="cpu")
    j = JT.generate_world(dims, octaves=octaves, layout=JL[layout], slab_z=slab_z)
    assert t.dims == tuple(j.dims) and t.layout.value == j.layout.value
    np.testing.assert_array_equal(t.words.numpy(), _words(j))
    assert 0 < int(t.count()) < t.num_bits


def test_generate_world_refuses_a_ragged_slab():
    with pytest.raises(ValueError):
        TT.generate_world((8, 8, 24), octaves=1, slab_z=16, device="cpu")


@pytest.fixture(scope="module")
def world():
    """A 32^3 world with a floor: a few full, many empty and mixed chunks."""
    dense = _dense(7, (32, 32, 32), 0.02)
    dense[:, :9, :] = True
    dense[:, 9:11, :] = np.random.default_rng(8).random((32, 2, 32)) < 0.5
    return dense


@pytest.mark.parametrize("coarse", LAYOUTS)
@pytest.mark.parametrize("brick", LAYOUTS)
@pytest.mark.parametrize("slots", ["dense", "compact", "compact_dedupe"])
def test_build_brickmap_bit_equal(world, coarse, brick, slots):
    kw = dict(dense_slots=slots == "dense", dedupe_uniform=slots == "compact_dedupe")
    j = JB.build_brickmap(JG.BitGrid.from_dense(jnp.asarray(world)), 8,
                          coarse_layout=JL[coarse], brick_layout=JL[brick], **kw)
    t = TB.build_brickmap(TG.BitGrid.from_dense(torch.from_numpy(world)), 8,
                          coarse_layout=TL[coarse], brick_layout=TL[brick], **kw)
    _assert_bm_equal(t, j)


@pytest.mark.parametrize("factor,grid_layout", [(5, "LINEAR"), (4, "LINEAR"), (16, "TILED_MORTON")])
def test_build_brickmap_other_factors_bit_equal(world, factor, grid_layout):
    """Factors whose chunk grid or brick is not tileable fall back to LINEAR,
    factor 5 has a partial tail word."""
    dense = world[:30, :30, :30] if factor == 5 else world
    for dense_slots in (True, False):
        j = JB.build_brickmap(JG.BitGrid.from_dense(jnp.asarray(dense), JL[grid_layout]), factor,
                              dense_slots=dense_slots, dedupe_uniform=not dense_slots)
        t = TB.build_brickmap(TG.BitGrid.from_dense(torch.from_numpy(dense), TL[grid_layout]), factor,
                              dense_slots=dense_slots, dedupe_uniform=not dense_slots)
        _assert_bm_equal(t, j)


def test_build_brickmap_from_fn_takes_numpy_slabs(world):
    f = 8

    def slab_fn(z0):
        return world[z0:z0 + f]

    j = JB.build_brickmap_from_fn(slab_fn, (32, 32, 32), f, coarse_layout=JL.TILED_MORTON)
    t = TB.build_brickmap_from_fn(slab_fn, (32, 32, 32), f, coarse_layout=TL.TILED_MORTON, device="cpu")
    _assert_bm_equal(t, j)
    with pytest.raises(ValueError):
        TB.build_brickmap_from_fn(slab_fn, (30, 32, 32), f, device="cpu")


ENTRY_POINTS = [
    (tcfg.Environment.default, "device"),
    (tframe.make_framebuffer, "device"),
    (TB.build_brickmap_terrain_compact, "device"),
    (TB.build_brickmap_from_fn, "device"),
    (TG.BitGrid.zeros, "device"),
    (TT.generate_world, "device"),
    (interop.brickmap_from_numpy, "device"),
    (interop.bitgrid_from_numpy, "device"),
    (interop.line_table_from_numpy, "device"),
    (interop.environment_from_numpy, "device"),
]


@pytest.mark.parametrize("fn,param", ENTRY_POINTS, ids=[f.__qualname__ for f, _ in ENTRY_POINTS])
def test_entry_points_default_to_the_card(fn, param):
    """Without a card too: the default is read from the signature, and no
    entry point probes for a device."""
    assert tcfg.default_device() == torch.device("cuda")
    assert inspect.signature(fn).parameters[param].default == torch.device("cuda")
