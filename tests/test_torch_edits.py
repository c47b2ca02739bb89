"""The port's brickmap functions and in-place edits against the JAX package.

Held bit for bit: ``BitGrid.set_bits``, ``BrickMap.voxel_bit`` /
``to_dense`` / ``chunk_index``, ``compact_brickmap``,
``build_brickmap_terrain`` (128x64x128 at factors 8 and 16),
``host_brick_lines``, ``apply_edits`` and ``apply_edits_hbm`` (``meta``,
``bricks``, ``region_lines``, ``macro``, ``macro2`` and the brick lines) on
a world whose brick lines are the bricks' own storage and on one whose
lines need padding (a copy), with repeated coordinates and neighbours in
one brick word, and on a world whose L2 and L3 macro levels are real, with
edits that fill an empty super-region and then empty a whole L3 block.
The edited tables also equal the port's ``make_line_table`` of the edited
world.

The JAX side runs once, in a subprocess, as in ``tests/test_torch_render.py``
but with XLA's default passes: nothing here is floating point, and
XLA:CPU without its algebraic simplifier fails to compile
``apply_edits_hbm``'s loops.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.core.bitgrid import BitGrid, write_bits
from voxelengine_tpu_torch.core.brickmap import (
    apply_edits,
    build_brickmap_terrain,
    compact_brickmap,
)
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops.bigtrace import (
    apply_edits_hbm,
    brick_lines_view,
    host_brick_lines,
    make_line_table,
    materialize_brick_lines,
)

ROOT = Path(__file__).resolve().parent.parent
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
LT_KEYS = ("region_lines", "macro", "macro2", "brick_lines")
# name: (world dims, factor, seed); "unpadded": 512 chunks x 16 words = 8 whole
# lines (the lines are the bricks' storage); "padded": 75 chunks x 16 words
WORLDS = {"unpadded": ((64, 64, 64), 8, 1), "padded": ((40, 24, 40), 8, 2)}
TERRAIN = (128, 64, 128)
TERRAIN_OCTAVES = 4


def _dense(dims, seed):
    X, Y, Z = dims
    rng = np.random.default_rng(seed)
    d = rng.random((Z, Y, X)) < 0.02
    d[:, 0:4, :] = rng.random((Z, 4, X)) < 0.5
    return d


def _edits(dims, seed, k=64):
    """``k`` edits: random voxels, repeats of them with other values, and
    runs of x-neighbours (one brick word in the TILED_LINEAR layout)."""
    rng = np.random.default_rng(seed)
    n = k // 4
    xyz = np.stack([rng.integers(0, d, n) for d in dims], axis=1)
    rep = xyz[rng.integers(0, n, n)]
    base = np.stack([rng.integers(0, d - 8, n // 2) for d in dims], axis=1)
    run = np.concatenate([base, base + [1, 0, 0], base + [2, 0, 0], base + [3, 0, 0]])
    pts = np.concatenate([xyz, rep, run])[:k]
    vals = rng.random(len(pts)) < 0.6
    vals[n:2 * n] = ~vals[:n][rng.integers(0, n, n)]
    return pts.astype(np.int32), vals


def _l2_dense():
    """256x64x256 at factor 4 (``tests/test_pallas_bigtrace.py::_world_l2``):
    8x2x8 regions, 2x2x2 super-regions, 1x2x1 L3 blocks; a quarter floor and
    a tower, so some super-regions are empty."""
    rng = np.random.default_rng(21)
    dense = np.zeros((256, 64, 256), bool)
    dense[:128, :3, :128] = rng.random((128, 3, 128)) < 0.3
    dense[200:216, :40, 200:216] = True
    return dense


def _l2_batches():
    """Fill an empty super-region with one voxel; empty it again and clear
    the tower above y = 32 (the whole upper L3 block); refill one voxel."""
    fill = np.array([[130, 40, 10]])
    tz, ty, tx = np.meshgrid(np.arange(200, 216), np.arange(32, 40), np.arange(200, 216), indexing="ij")
    tower = np.stack([tx.ravel(), ty.ravel(), tz.ravel()], axis=1)
    empty = np.concatenate([fill, tower])
    return [(fill, np.ones(1, bool)), (empty, np.zeros(len(empty), bool)), (tower[:1], np.ones(1, bool))]


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import jax
    import jax.numpy as jnp

    from voxelengine_tpu.core import brickmap as jb
    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.layout import Layout as JLayout
    from voxelengine_tpu.ops import pallas_bigtrace as jbt

    out = {}

    def save(prefix, obj, keys):
        for k in keys:
            v = getattr(obj, k)
            out[f"{prefix}/{k}"] = np.asarray(getattr(v, "value", v))

    def world(dense, f):
        return jb.build_brickmap(JGrid.from_dense(dense), f, coarse_layout=JLayout.LINEAR)

    copy = lambda t: jax.tree.map(jnp.copy, t)  # noqa: E731 (donation-safe)
    for name, (dims, f, seed) in WORLDS.items():
        bm = world(_dense(dims, seed), f)
        save(f"{name}/bm", bm, BM_KEYS)
        pts, vals = _edits(dims, seed)
        x, y, z = (jnp.asarray(pts[:, i]) for i in range(3))
        save(f"{name}/edited", jb.apply_edits(copy(bm), x, y, z, jnp.asarray(vals)), ("meta", "bricks"))
        lt = jbt.materialize_brick_lines(bm, jbt.make_line_table(bm))
        bm2, lt2 = jbt.apply_edits_hbm(copy(bm), copy(lt), x, y, z, jnp.asarray(vals))
        save(f"{name}/hbm_bm", bm2, ("meta", "bricks"))
        save(f"{name}/hbm_lt", lt2, LT_KEYS)

    bm = world(_l2_dense(), 4)
    save("l2/bm", bm, BM_KEYS)
    lt = jbt.materialize_brick_lines(bm, jbt.make_line_table(bm))
    for i, (pts, vals) in enumerate(_l2_batches()):
        bm, lt = jbt.apply_edits_hbm(bm, lt, *(jnp.asarray(pts[:, j]) for j in range(3)), jnp.asarray(vals))
        save(f"l2/{i}/bm", bm, ("meta", "bricks"))
        save(f"l2/{i}/lt", lt, LT_KEYS)

    # voxel_bit / to_dense / chunk_index / compact_brickmap / host_brick_lines
    bm = world(_dense(*WORLDS["padded"][::2]), 8)
    rng = np.random.default_rng(30)
    q = rng.integers(-4, 48, (4096, 3)).astype(np.int32)
    out["query"] = q
    out["voxel_bit"] = np.asarray(bm.voxel_bit(q[:, 0], q[:, 1], q[:, 2]))
    out["to_dense"] = np.asarray(bm.to_dense())
    for dedupe in (True, False):
        cb = jb.compact_brickmap(bm, dedupe_uniform=dedupe)
        save(f"compact{int(dedupe)}", cb, ("meta", "brick_idx", "bricks"))
        out[f"compact{int(dedupe)}/voxel_bit"] = np.asarray(cb.voxel_bit(q[:, 0], q[:, 1], q[:, 2]))
    out["host_brick_lines"] = jbt.host_brick_lines(np.asarray(bm.bricks))
    for lay in ("LINEAR", "TILED_LINEAR", "TILED_MORTON"):
        mb = jb.build_brickmap(JGrid.from_dense(_dense((64, 64, 64), 3)), 8, coarse_layout=JLayout[lay])
        c = rng.integers(0, 8, (512, 3))
        out[f"chunk_index/{lay}/c"] = c
        out[f"chunk_index/{lay}"] = np.asarray(mb.chunk_index(c[:, 0], c[:, 1], c[:, 2]))

    # set_bits on distinct coordinates, each layout
    for lay in ("LINEAR", "TILED_LINEAR", "TILED_MORTON"):
        g = JGrid.from_dense(_dense((32, 16, 24), 4), JLayout[lay])
        flat = rng.choice(32 * 16 * 24, 300, replace=False)
        c = np.stack([flat % 32, flat // 32 % 16, flat // 512], axis=1)
        v = rng.random(300) < 0.5
        out[f"set_bits/{lay}/c"], out[f"set_bits/{lay}/v"] = c, v
        out[f"set_bits/{lay}"] = np.asarray(g.set_bits(c[:, 0], c[:, 1], c[:, 2], v).words)

    for f in (8, 16):
        save(f"terrain{f}", jb.build_brickmap_terrain(TERRAIN, f, octaves=TERRAIN_OCTAVES), BM_KEYS)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port side on one CPU thread: the suite runs several workers at
    once, and torch's default of a thread per core each makes its eager
    loops crawl (results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "edits_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run(
        [sys.executable, __file__, str(path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _bm(ref, prefix, device="cpu"):
    return brickmap_from_numpy({k: ref[f"{prefix}/{k}"] for k in BM_KEYS}, device=device)


def _eq(got, want, what):
    np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=what)


def _edit_args(pts, vals, device="cpu"):
    return tuple(torch.from_numpy(pts[:, i].copy()).to(device) for i in range(3)) + (torch.from_numpy(vals).to(device),)


def _check_rebuild(bm, lt):
    """The incrementally edited tables equal a fresh line table of ``bm``."""
    fresh = make_line_table(bm)
    for k in ("region_lines", "macro", "macro2"):
        assert torch.equal(getattr(lt, k), getattr(fresh, k)), k
    assert torch.equal(lt.brick_lines, brick_lines_view(bm)), "brick_lines"


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_apply_edits_bit_equal(ref, name):
    bm = _bm(ref, f"{name}/bm")
    pts, vals = _edits(*WORLDS[name][::2])
    out = apply_edits(bm, *_edit_args(pts, vals))
    assert out is bm  # in place
    _eq(bm.meta, ref[f"{name}/edited/meta"], "meta")
    _eq(bm.bricks, ref[f"{name}/edited/bricks"].view(np.int32), "bricks")


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_apply_edits_hbm_bit_equal(ref, name):
    """Both worlds, with attached brick lines: the unpadded world's lines
    are the bricks' storage (nothing to sync), the padded world's a copy."""
    bm = _bm(ref, f"{name}/bm")
    lt = materialize_brick_lines(bm, make_line_table(bm))
    shared = lt.brick_lines.untyped_storage().data_ptr() == bm.bricks.untyped_storage().data_ptr()
    assert shared == (name == "unpadded")
    pts, vals = _edits(*WORLDS[name][::2])
    bm2, lt2 = apply_edits_hbm(bm, lt, *_edit_args(pts, vals))
    assert bm2 is bm and lt2 is lt
    _eq(bm.meta, ref[f"{name}/hbm_bm/meta"], "meta")
    _eq(bm.bricks, ref[f"{name}/hbm_bm/bricks"].view(np.int32), "bricks")
    for k in LT_KEYS:
        _eq(getattr(lt, k), ref[f"{name}/hbm_lt/{k}"], k)
    _check_rebuild(bm, lt)


def test_apply_edits_hbm_l2_l3_fill_and_empty(ref):
    """A world with real L2 and L3 levels: fill an empty super-region, empty
    it and a whole L3 block, refill; each batch bit-equal to JAX's and to a
    rebuilt table, and the levels really flip."""
    bm = _bm(ref, "l2/bm")
    lt = materialize_brick_lines(bm, make_line_table(bm))
    assert (lt.macro2 != -1).all()  # L2 and L3 real
    m2 = [lt.macro2.clone()]
    for i, (pts, vals) in enumerate(_l2_batches()):
        bm, lt = apply_edits_hbm(bm, lt, *_edit_args(pts, vals))
        _eq(bm.meta, ref[f"l2/{i}/bm/meta"], f"batch {i} meta")
        _eq(bm.bricks, ref[f"l2/{i}/bm/bricks"].view(np.int32), f"batch {i} bricks")
        for k in LT_KEYS:
            _eq(getattr(lt, k), ref[f"l2/{i}/lt/{k}"], f"batch {i} {k}")
        _check_rebuild(bm, lt)
        m2.append(lt.macro2.clone())
    assert not torch.equal(m2[0][:32], m2[1][:32])  # the fill set an L2 bit
    assert not torch.equal(m2[1][32:], m2[2][32:])  # emptying cleared an L3 bit
    assert torch.equal(m2[2][32:] | m2[3][32:], m2[3][32:]) and not torch.equal(m2[2][32:], m2[3][32:])


def test_write_bits_is_a_sequential_read_modify_write():
    """Last write of a bit wins, writes to one word compose: against a
    plain Python loop over the writes."""
    rng = np.random.default_rng(40)
    words = rng.integers(-2**31, 2**31, 6, dtype=np.int64).astype(np.int32)
    w = rng.integers(0, 6, 200)
    b = rng.integers(0, 32, 200)
    v = rng.random(200) < 0.5
    want = words.view(np.uint32).copy()
    for wi, bi, vi in zip(w, b, v):
        m = np.uint32(1) << np.uint32(bi)
        want[wi] = want[wi] | m if vi else want[wi] & ~m
    got = torch.from_numpy(words.copy())
    write_bits(got, torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("layout", ["LINEAR", "TILED_LINEAR", "TILED_MORTON"])
def test_set_bits_bit_equal(ref, layout):
    g = BitGrid.from_dense(torch.from_numpy(_dense((32, 16, 24), 4)), Layout[layout])
    c, v = ref[f"set_bits/{layout}/c"], ref[f"set_bits/{layout}/v"]
    words = g.words.clone()
    got = g.set_bits(*(torch.from_numpy(c[:, i]) for i in range(3)), torch.from_numpy(v))
    assert torch.equal(g.words, words)  # a new grid; the old one unchanged
    _eq(got.words, ref[f"set_bits/{layout}"].view(np.int32), layout)


def test_voxel_bit_and_to_dense_bit_equal(ref):
    bm = _bm(ref, "padded/bm")
    q = ref["query"]
    _eq(bm.voxel_bit(*(torch.from_numpy(q[:, i]) for i in range(3))), ref["voxel_bit"], "voxel_bit")
    _eq(bm.to_dense(), ref["to_dense"], "to_dense")
    np.testing.assert_array_equal(ref["to_dense"], _dense(*WORLDS["padded"][::2]))


def test_voxel_bit_refuses_host_bricks(ref):
    bm = dataclasses.replace(_bm(ref, "padded/bm"), bricks=None)
    with pytest.raises(ValueError, match="host-resident"):
        bm.voxel_bit(torch.zeros(1, dtype=torch.long), torch.zeros(1, dtype=torch.long),
                     torch.zeros(1, dtype=torch.long))


@pytest.mark.parametrize("layout", ["LINEAR", "TILED_LINEAR", "TILED_MORTON"])
def test_chunk_index_bit_equal(ref, layout):
    from voxelengine_tpu_torch.core.brickmap import build_brickmap

    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(_dense((64, 64, 64), 3))), 8,
                        coarse_layout=Layout[layout])
    c = ref[f"chunk_index/{layout}/c"]
    _eq(bm.chunk_index(*(torch.from_numpy(c[:, i]) for i in range(3))), ref[f"chunk_index/{layout}"], layout)


@pytest.mark.parametrize("dedupe", [True, False])
def test_compact_brickmap_bit_equal(ref, dedupe):
    bm = _bm(ref, "padded/bm")
    cb = compact_brickmap(bm, dedupe_uniform=dedupe)
    assert not cb.dense_slots
    for k in ("meta", "brick_idx", "bricks"):
        want = ref[f"compact{int(dedupe)}/{k}"]
        _eq(getattr(cb, k), want.view(np.int32) if k == "bricks" else want, k)
    q = ref["query"]
    _eq(cb.voxel_bit(*(torch.from_numpy(q[:, i]) for i in range(3))), ref[f"compact{int(dedupe)}/voxel_bit"],
        "voxel_bit")


@pytest.mark.parametrize("factor", [8, 16])
def test_build_brickmap_terrain_bit_equal(ref, factor):
    bm = build_brickmap_terrain(TERRAIN, factor, octaves=TERRAIN_OCTAVES, device="cpu")
    want = _bm(ref, f"terrain{factor}")
    assert bm.dense_slots and bm.coarse_layout is Layout.LINEAR and bm.brick_layout is want.brick_layout
    for k in ("meta", "brick_idx", "bricks"):
        assert torch.equal(getattr(bm, k), getattr(want, k)), k


def test_host_brick_lines_bit_equal(ref):
    bm = _bm(ref, "padded/bm")
    got = host_brick_lines(bm.bricks.numpy())
    np.testing.assert_array_equal(got, ref["host_brick_lines"])
    np.testing.assert_array_equal(got, brick_lines_view(bm).numpy())
    full = np.arange(2048, dtype=np.uint32).reshape(2, 1024)  # whole lines: a view
    assert np.shares_memory(host_brick_lines(full), full)


def test_edits_refuse_compact_worlds(ref):
    cb = compact_brickmap(_bm(ref, "padded/bm"))
    args = _edit_args(np.zeros((1, 3), np.int32), np.ones(1, bool))
    with pytest.raises(ValueError, match="dense_slots"):
        apply_edits(cb, *args)
    with pytest.raises(ValueError, match="dense_slots"):
        apply_edits_hbm(cb, make_line_table(cb), *args)


# ---------------------------------------------------------------------------
# card lane
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_apply_edits_hbm_on_card_matches_cpu(cuda_device, name):
    """The same edits on the card give the CPU's tables, and a rebuild's."""
    from voxelengine_tpu_torch.core.brickmap import build_brickmap

    dims, f, seed = WORLDS[name]
    pts, vals = _edits(dims, seed)
    tables = []
    for dev in ("cpu", cuda_device):
        grid = BitGrid.from_dense(torch.from_numpy(_dense(dims, seed)).to(dev))
        bm = build_brickmap(grid, f, coarse_layout=Layout.LINEAR)
        lt = materialize_brick_lines(bm, make_line_table(bm))
        apply_edits_hbm(bm, lt, *_edit_args(pts, vals, dev))
        _check_rebuild(bm, lt)
        tables.append([bm.meta, bm.bricks] + [getattr(lt, k) for k in LT_KEYS])
    for a, b in zip(*tables):
        assert torch.equal(a, b.cpu())


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
