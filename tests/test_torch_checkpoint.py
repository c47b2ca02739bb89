"""The port's world and line-table checkpoints (``io/checkpoint.py``) against
the JAX package's: the same npz files load in either package with
bit-equal tables, stale and short line tables are handled as JAX handles
them, and the caches (``generate_or_load``, ``line_table_or_build``,
``memo_json``) build once, load after, and rebuild what is unreadable."""

import json

import numpy as np
import pytest
import torch

from voxelengine_tpu.core import brickmap as JB
from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
from voxelengine_tpu.io import checkpoint as JC
from voxelengine_tpu.ops import pallas_bigtrace as JP
from voxelengine_tpu_torch.core import brickmap as TB
from voxelengine_tpu_torch.io import checkpoint as TC
from voxelengine_tpu_torch.ops import bigtrace as TP


def _dense(seed=7):
    rng = np.random.default_rng(seed)
    dense = rng.random((32, 32, 48)) < 0.03
    dense[:, :6, :] = True  # all-full chunks at the floor (slot 0)
    dense[:, :, 40:] = False  # empty chunks (slot -1)
    return dense


def _assert_bm_equal(t, j):
    assert t.grid_dims == tuple(int(v) for v in j.grid_dims) and t.factor == j.factor
    assert (t.coarse_layout.value, t.brick_layout.value, t.dense_slots) == (
        j.coarse_layout.value, j.brick_layout.value, j.dense_slots)
    np.testing.assert_array_equal(t.meta.numpy(), np.asarray(j.meta))
    np.testing.assert_array_equal(t.brick_idx.numpy(), np.asarray(j.brick_idx))
    np.testing.assert_array_equal(t.bricks.numpy(), np.asarray(j.bricks).view(np.int32))


def _assert_lt_equal(t, j):
    assert t.num_regions == j.num_regions and t.region_dims == tuple(int(v) for v in j.region_dims)
    for k in ("region_lines", "macro", "macro2"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)), err_msg=k)


@pytest.mark.parametrize("dense_slots", [False, True], ids=["compact", "dense_slots"])
def test_world_saved_by_jax_loads_in_the_port(tmp_path, dense_slots):
    j = JB.build_brickmap(JGrid.from_dense(_dense()), 8, dense_slots=dense_slots)
    JC.save_world(str(tmp_path / "w"), j)
    _assert_bm_equal(TC.load_world(str(tmp_path / "w"), device="cpu"), j)
    _assert_bm_equal(TC.load_world(str(tmp_path / "w.npz"), device="cpu"), j)


def test_world_saved_by_the_port_loads_in_jax(tmp_path):
    t = TB.build_brickmap(TB.BitGrid.from_dense(torch.from_numpy(_dense())), 8, dense_slots=False)
    TC.save_world(str(tmp_path / "w"), t)
    assert (tmp_path / "w.npz").exists() and (tmp_path / "w.npz.bricks.npy").exists()
    assert np.load(tmp_path / "w.npz.bricks.npy").dtype == np.uint32
    j = JC.load_world(str(tmp_path / "w"))
    _assert_bm_equal(t, j)
    idx = t.brick_idx.numpy()
    assert (idx == -1).any() and (idx == 0).any() and (idx > 0).any()


def test_world_in_one_npz_loads(tmp_path):
    """The older form with the bricks inside the npz (no sidecar)."""
    j = JB.build_brickmap(JGrid.from_dense(_dense()), 8, dense_slots=False)
    np.savez_compressed(
        tmp_path / "old.npz", version=1, meta=np.asarray(j.meta), brick_idx=np.asarray(j.brick_idx),
        bricks=np.asarray(j.bricks), grid_dims=np.asarray(j.grid_dims), factor=j.factor,
        coarse_layout=j.coarse_layout.value, brick_layout=j.brick_layout.value, dense_slots=j.dense_slots,
    )
    _assert_bm_equal(TC.load_world(str(tmp_path / "old.npz"), device="cpu"), j)


def test_load_world_host_bricks(tmp_path):
    j = JB.build_brickmap(JGrid.from_dense(_dense()), 8, dense_slots=False)
    JC.save_world(str(tmp_path / "w"), j)
    bm, host = TC.load_world_host_bricks(str(tmp_path / "w"), device="cpu")
    assert bm.bricks is None and isinstance(host, np.memmap) and host.dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(host), np.asarray(j.bricks))
    np.testing.assert_array_equal(bm.meta.numpy(), np.asarray(j.meta))
    assert bm.words_per_brick == host.shape[1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_line_table_round_trip_between_packages(tmp_path, writer):
    j = JB.build_brickmap(JGrid.from_dense(_dense()), 8, dense_slots=False)
    t = TB.build_brickmap(TB.BitGrid.from_dense(torch.from_numpy(_dense())), 8, dense_slots=False)
    path = str(tmp_path / "w.lt.npz")
    if writer == "jax":
        JC.save_line_table(path, JP.make_line_table(j))
        _assert_lt_equal(TC.load_line_table(path, device="cpu"), JP.make_line_table(j))
    else:
        TC.save_line_table(path, TP.make_line_table(t))
        _assert_lt_equal(TP.make_line_table(t), JC.load_line_table(path))
    assert TC.LINE_TABLE_LAYOUT_VERSION == JC.LINE_TABLE_LAYOUT_VERSION


def _rewrite(path, **changes):
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    np.savez_compressed(path, **{**d, **changes})


def test_stale_line_table_is_refused_and_rebuilt(tmp_path):
    t = TB.build_brickmap(TB.BitGrid.from_dense(torch.from_numpy(_dense())), 8, dense_slots=False)
    lt = TC.line_table_or_build(str(tmp_path), "k", t)
    path = tmp_path / "k.lt.npz"
    _rewrite(path, layout_version=2, macro=np.zeros_like(lt.macro.numpy()))
    with pytest.raises(ValueError, match="stale"):
        TC.load_line_table(str(path), device="cpu")
    with pytest.raises(ValueError, match="stale"):
        JC.load_line_table(str(path))
    again = TC.line_table_or_build(str(tmp_path), "k", t)
    _assert_lt_equal(again, JP.make_line_table(JB.build_brickmap(JGrid.from_dense(_dense()), 8, dense_slots=False)))
    with np.load(path) as z:
        assert int(z["layout_version"]) == TC.LINE_TABLE_LAYOUT_VERSION


def test_short_macro2_is_padded_with_all_occupied_words(tmp_path):
    t = TB.build_brickmap(TB.BitGrid.from_dense(torch.from_numpy(_dense())), 8, dense_slots=False)
    path = str(tmp_path / "w.lt.npz")
    TC.save_line_table(path, TP.make_line_table(t))
    short = TP.make_line_table(t).macro2.numpy()[: TP.MACRO2_WORDS]
    _rewrite(path, macro2=short)
    got = TC.load_line_table(path, device="cpu").macro2.numpy()
    want = np.asarray(JC.load_line_table(path).macro2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[: TP.MACRO2_WORDS], short)
    assert got.shape == (TP.MACRO2_WORDS + TP.MACRO3_WORDS,) and (got[TP.MACRO2_WORDS:] == -1).all()


def test_generate_or_load_builds_once_then_loads_and_rebuilds_a_truncated_cache(tmp_path):
    calls = []

    def gen():
        calls.append(1)
        return TB.build_brickmap_terrain_compact((64, 32, 64), 16, octaves=3, device="cpu")

    a = TC.generate_or_load(str(tmp_path), "world", gen, device="cpu")
    b = TC.generate_or_load(str(tmp_path), "world", gen, device="cpu")
    assert len(calls) == 1
    for k in ("meta", "brick_idx", "bricks"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    assert (a.grid_dims, a.factor, a.brick_layout, a.coarse_layout) == (b.grid_dims, b.factor, b.brick_layout,
                                                                        b.coarse_layout)
    npz = tmp_path / "world.npz"
    npz.write_bytes(npz.read_bytes()[:40])  # truncated
    c = TC.generate_or_load(str(tmp_path), "world", gen, device="cpu")
    assert len(calls) == 2 and torch.equal(c.bricks, a.bricks)
    _assert_bm_equal(TC.load_world(str(npz), device="cpu"),
                     JB.build_brickmap_terrain_compact((64, 32, 64), 16, octaves=3))


def test_memo_json(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        return torch.tensor(True)

    assert TC.memo_json(str(tmp_path), "probe", fn) is True
    assert TC.memo_json(str(tmp_path), "probe", fn) is True and len(calls) == 1
    assert JC.memo_json(str(tmp_path), "probe", lambda: False) is True  # the same file
    path = tmp_path / "probe.memo.json"
    assert json.loads(path.read_text()) == {"key": "probe", "value": True}
    path.write_text("{corrupt")
    assert TC.memo_json(str(tmp_path), "probe", lambda: 7) == 7
    assert json.loads(path.read_text())["value"] == 7


