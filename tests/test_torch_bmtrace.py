"""K4's wrapper (``voxelengine_tpu_torch/kernels/bmtrace.py``): its choice
between the two instantiations of ``csrc/bmtrace.cu`` (``meta`` in a block's
shared memory, or in global memory) by the table's size alone, its refusals,
and, on the card, both instantiations of both table forms (dense slots and
compact) against the plain ``trace_brickmap``.

The dense-slot DDA body is held against the JAX package on the CPU by
``tests/test_torch_gridtrace.py`` (its g++ build with the dense-slot fetch).
The compact instantiation's g++ build (``vx_trace_brickmap_compact_host``,
``CompactFetch``) is held here against the JAX package's
``trace_brickmap``, the XLA walk JAX takes over a compact world without a
line table, bit for bit, on ``compact_brickmap`` of random 64^3 worlds and
on terrains built compact; the JAX side runs once, in a subprocess whose
XLA:CPU neither contracts FMAs nor runs the algebraic simplifier (as in
``tests/test_torch_trace.py``).  The card lane holds the kernels
themselves, bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap, compact_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.kernels import bmtrace, build
from voxelengine_tpu_torch.ops import trace2
from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup, kernel_result, trace_brickmap
from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_mxu, trace_brickmap_no_table

ROOT = Path(__file__).resolve().parent.parent
LIMIT_CHUNKS = bmtrace.SMEM_META_LIMIT // 4  # 58,112 chunks: 227 KB of meta words
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
# compact worlds of the host-build case: name -> (kind, coarse layout, brick layout)
COMPACT_WORLDS = {
    "random_linear": ("random", "LINEAR", "LINEAR"),
    "random_tiled": ("random", "TILED_LINEAR", "TILED_MORTON"),
    "random_morton": ("random", "TILED_MORTON", "TILED_LINEAR"),
    "random_odd": ("random_odd", "LINEAR", "TILED_MORTON"),  # 9x5x7 = 315 chunks, not a multiple of 32
    "terrain_tiled": ("terrain", "LINEAR", "TILED_LINEAR"),
    "terrain_linear": ("terrain", "LINEAR", "LINEAR"),
}
# the random worlds' dense shapes, [z, y, x]
RANDOM_SHAPES = {"random": (64, 64, 64), "random_odd": (56, 40, 72)}

TERRAIN = ((128, 64, 128), 32, 6)  # world dims, factor, octaves
MAX_STEPS = 256


def _random_dense(shape=(64, 64, 64)):
    """A sparse random world of ``shape`` ([z, y, x]) over a floor, with one
    all-solid chunk (the compact form's shared full brick, slot 0) and empty
    chunks (slot -1)."""
    rng = np.random.default_rng(97)
    dense = rng.random(shape) < 0.001
    dense[:, :3, :] = rng.random((shape[0], 3, shape[2])) < 0.5
    dense[8:16, 16:24, 24:32] = True
    return dense


def _port_compact_world(name, device):
    """The port's build of compact world ``name`` (JAX's builders' tables,
    bit for bit: ``test_host_build_of_compact_instantiation_matches_jax``
    for the random worlds, ``tests/test_torch_terrain.py`` for the compact
    terrain build)."""
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact

    kind, cl, bl = COMPACT_WORLDS[name]
    if kind in RANDOM_SHAPES:
        dense = torch.from_numpy(_random_dense(RANDOM_SHAPES[kind])).to(device)
        return compact_brickmap(build_brickmap(BitGrid.from_dense(dense), 8, coarse_layout=Layout[cl],
                                               brick_layout=Layout[bl]))
    dims, f, octaves = TERRAIN
    return build_brickmap_terrain_compact(dims, f, octaves=octaves, brick_layout=Layout[bl], device=device)


def _compact_rays(dims, seed, n=1536):
    """Rays from inside and outside the world toward random points in it,
    with axis-aligned ones, one on each maximal face heading in (they start
    in the edge pad cells) and one that misses."""
    rng = np.random.default_rng(seed)
    w = np.asarray(dims, np.float32)
    o = (rng.random((n, 3)) * w * 1.8 - w * 0.4).astype(np.float32)
    d = (rng.random((n, 3)) * w).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[0:3] = w / 2
    d[0:3] = -np.eye(3)
    o[3], d[3] = [w[0], w[1] / 3, w[2] / 2], [-1.0, 0.0, 0.0]
    o[4], d[4] = [w[0] * 2, w[1] * 2, w[2] * 2], [0.0, 1.0, 0.0]
    o[5], d[5] = [w[0] / 3, w[1], w[2] / 3], [0.0, -1.0, 0.0]
    o[6], d[6] = [w[0] * 0.6, w[1] * 0.4, w[2]], [0.0, 0.0, -1.0]
    o[7], d[7] = [w[0], w[1] * 0.8, w[2]], np.asarray([-1.0, -0.5, -1.0]) / 1.5
    return o, d.astype(np.float32)


def _jax_reference():
    """JAX side (runs in the subprocess, module doc): each compact world's
    tables and ``trace_brickmap`` of its rays."""
    import jax.numpy as jnp

    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.brickmap import build_brickmap as j_build
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact as j_terrain
    from voxelengine_tpu.core.brickmap import compact_brickmap as j_compact
    from voxelengine_tpu.core.layout import Layout as JL
    from voxelengine_tpu.ops.trace import trace_brickmap as j_trace

    out = {}
    for name, (kind, cl, bl) in COMPACT_WORLDS.items():
        if kind in RANDOM_SHAPES:
            dense = _random_dense(RANDOM_SHAPES[kind])
            bm = j_compact(j_build(JGrid.from_dense(dense), 8, coarse_layout=JL[cl], brick_layout=JL[bl]))
        else:
            dims, f, octaves = TERRAIN
            bm = j_terrain(dims, f, octaves=octaves, brick_layout=JL[bl])
        for k in BM_KEYS:
            v = getattr(bm, k)
            out[f"{name}/{k}"] = np.asarray(getattr(v, "value", v))
        o, d = _compact_rays(bm.world_dims, 98)
        r = j_trace(bm, jnp.asarray(o), jnp.asarray(d), MAX_STEPS)
        for k in ("hit", "position", "normal", "steps"):
            out[f"{name}/{k}"] = np.asarray(getattr(r, k))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "bmtrace_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run(
        [sys.executable, __file__, str(path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port side on one CPU thread: the suite runs several workers at
    once, and torch's default of a thread per core each makes its eager
    ops crawl (results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_lib():
    import shutil

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler for the host build of the kernels' step logic")
    return build.load_dda_host()


def _host_compact(lib, bm, o, d, max_steps):
    """K4's compact instantiation built by g++, with the wrapper's ray setup
    and ``hit_imm`` fix-up."""
    dd, start_c, start_normal, active = _ray_setup(bm.grid_dims, bm.factor, o, d)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, o.device), dd)
    active = active.to(torch.int32)  # held: the C call reads these buffers
    n = o.shape[0]
    outs = (torch.empty(n, dtype=torch.int32), torch.empty(n, 3), torch.empty(n, 3), torch.empty(n, dtype=torch.int32))
    tables = (start_c, dd, active, pad, bm.meta, bm.brick_idx, bm.bricks)
    rc = lib.vx_trace_brickmap_compact_host(
        *(t.data_ptr() for t in tables), n, *bm.grid_dims, bm.factor, bm.words_per_brick, max_steps,
        bm.coarse_layout.value, bm.brick_layout.value, 3 * max_steps + 64, *(t.data_ptr() for t in outs),
    )
    assert rc == 0
    return kernel_result(*outs, start_c, start_normal, bm.factor)


@pytest.mark.parametrize("name", sorted(COMPACT_WORLDS))
def test_host_build_of_compact_instantiation_matches_jax(ref, host_lib, name):
    """``csrc/dda.cuh`` with ``CompactFetch`` built by g++ == JAX's
    ``trace_brickmap`` on the compact world, bit for bit in hits, steps,
    normals and positions (of every ray: a miss reports zeros on both)."""
    bm = brickmap_from_numpy({k: ref[f"{name}/{k}"] for k in BM_KEYS}, device="cpu")
    assert not bm.dense_slots
    slots = bm.brick_idx
    assert bool((slots == -1).any()), "the world should have empty chunks"
    if COMPACT_WORLDS[name][0] in RANDOM_SHAPES:
        assert bool((slots == 0).any()), "the random world should use the shared full brick"
    o, d = (torch.from_numpy(a) for a in _compact_rays(bm.world_dims, 98))
    got = _host_compact(host_lib, bm, o, d, MAX_STEPS)
    hit = ref[f"{name}/hit"]
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.steps.numpy(), ref[f"{name}/steps"])
    np.testing.assert_array_equal(got.normal.numpy(), ref[f"{name}/normal"])
    np.testing.assert_array_equal(got.position.numpy(), ref[f"{name}/position"])
    if COMPACT_WORLDS[name][0] in RANDOM_SHAPES:  # the card lane's world (terrains: tests/test_torch_terrain.py)
        port = _port_compact_world(name, "cpu")
        for k in ("meta", "brick_idx", "bricks"):
            assert torch.equal(getattr(port, k), getattr(bm, k)), k


@pytest.mark.parametrize("name", sorted(COMPACT_WORLDS))
def test_host_build_of_compact_instantiation_matches_plain_walk(ref, host_lib, name):
    """The same host build == the port's plain ``trace_brickmap`` on the
    compact world, bit for bit: LINEAR and both tiled coarse layouts, a
    chunk count that is not a multiple of 32, rays that start in the edge
    pad cells."""
    bm = brickmap_from_numpy({k: ref[f"{name}/{k}"] for k in BM_KEYS}, device="cpu")
    o, d = (torch.from_numpy(a) for a in _compact_rays(bm.world_dims, 98))
    got = _host_compact(host_lib, bm, o, d, MAX_STEPS)
    for f, g, w in zip(("hit", "position", "normal", "steps"), got, trace_brickmap(bm, o, d, MAX_STEPS)):
        assert torch.equal(g, w), f


def test_compact_card_route_reaches_the_compact_entry(ref, host_lib, monkeypatch):
    """A compact world's card call goes to ``bmtrace_compact_rays`` (CPU
    tensors routed as card tensors; the entry replaced by its g++ build),
    never to the dense entry, and gives the plain walk's results."""
    bm = brickmap_from_numpy({k: ref[f"terrain_tiled/{k}"] for k in BM_KEYS}, device="cpu")
    seen = []

    def compact(origins, rays, meta, brick_idx, bricks, *, grid_dims, factor, max_steps, coarse_layout,
                brick_layout):
        assert (meta, brick_idx, bricks) == (bm.meta, bm.brick_idx, bm.bricks)
        seen.append(origins.shape[0])
        n = origins.shape[0]
        outs = (torch.empty(n, dtype=torch.bool), torch.empty(n, 3), torch.empty(n, 3),
                torch.empty(n, dtype=torch.int32))
        host_lib.vx_trace_brickmap_compact_rays_host(
            origins.data_ptr(), 3, rays.data_ptr(), 3, *(t.data_ptr() for t in (meta, brick_idx, bricks)), n,
            *grid_dims, factor, bm.words_per_brick, max_steps, coarse_layout.value, brick_layout.value,
            3 * max_steps + 64, *(t.data_ptr() for t in outs))
        return outs

    def dense(*a, **k):
        raise AssertionError("a compact world reached the dense-slot entry")

    monkeypatch.setattr(trace2, "_is_cuda", lambda t: True)
    monkeypatch.setattr(bmtrace, "bmtrace_compact_rays", compact)
    monkeypatch.setattr(bmtrace, "bmtrace_rays", dense)
    o, d = (torch.from_numpy(a) for a in _compact_rays(bm.world_dims, 98))
    got = trace_brickmap_no_table(bm, o, d, MAX_STEPS)
    assert seen == [o.shape[0]]
    want = trace_brickmap(bm, o, d, MAX_STEPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dense-slot"):
        trace_brickmap_mxu(bm, o, d, MAX_STEPS)


@pytest.mark.parametrize("num_chunks,shared", [
    (1, True),
    (4096, True),             # 128^3 at factor 8, K4's documented scope
    (32768, True),            # pallas_trace2.py's own limit, ~32k chunks
    (LIMIT_CHUNKS, True),     # exactly 227 KB
    (LIMIT_CHUNKS + 1, False),
    (131072, False),          # 512x256x512 at factor 8: 512 KB
])
def test_instantiation_is_chosen_by_table_size(num_chunks, shared):
    assert bmtrace.SMEM_META_LIMIT == 227 * 1024
    assert bmtrace.meta_in_shared(num_chunks) is shared


def _rays(n, dev="cpu"):
    """``n`` origins and directions, all zero."""
    z3 = torch.zeros(n, 3, device=dev)
    return z3, z3.clone()


KW = dict(factor=8, max_steps=16, coarse_layout=Layout.LINEAR, brick_layout=Layout.TILED_LINEAR)


def test_wrapper_refuses_cpu_tensors():
    before = (bmtrace.launches, bmtrace.shared_launches, bmtrace.compact_launches)
    with pytest.raises(ValueError, match="CUDA"):
        bmtrace.bmtrace_rays(*_rays(4), torch.zeros(64, dtype=torch.int32), torch.zeros(64, 16, dtype=torch.int32),
                             grid_dims=(4, 4, 4), **KW)
    with pytest.raises(ValueError, match="CUDA"):
        bmtrace.bmtrace_compact_rays(*_rays(4), torch.zeros(64, dtype=torch.int32),
                                     torch.zeros(64, dtype=torch.int32), torch.zeros(3, 16, dtype=torch.int32),
                                     grid_dims=(4, 4, 4), **KW)
    assert (bmtrace.launches, bmtrace.shared_launches, bmtrace.compact_launches) == before


def test_compact_wrapper_refuses_brick_tables_outside_the_kernel():
    """The compact form's int32 bound is on its brick words, not its chunks:
    2^21 bricks of 1024 words are refused on a small grid."""
    big = torch.zeros(1, 1024, dtype=torch.int32).expand(2**21, 1024)  # no memory behind the rows
    with pytest.raises(ValueError, match="int32 indices"):
        bmtrace.bmtrace_compact_rays(*_rays(4), torch.zeros(64, dtype=torch.int32),
                                     torch.zeros(64, dtype=torch.int32), big, grid_dims=(4, 4, 4),
                                     **dict(KW, factor=32))


@pytest.mark.parametrize("grid,kw,match", [
    ((4, 4, 4), dict(factor=0), "int32 indices"),
    ((4, 4, 4), dict(factor=33), "int32 indices"),
    ((1024, 1024, 128), dict(factor=32), "int32 indices"),  # 2^27 chunks x 1024 words
    ((12, 8, 8), dict(coarse_layout=Layout.TILED_LINEAR), "divisible by 8"),
])
def test_wrapper_refuses_grids_outside_the_kernel(grid, kw, match):
    with pytest.raises(ValueError, match=match):
        bmtrace.bmtrace_rays(*_rays(4), torch.zeros(1, dtype=torch.int32), torch.zeros(1, 16, dtype=torch.int32),
                             grid_dims=grid, **dict(KW, **kw))


# ------------------------------------------------------------ card lane


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


def _world_and_rays(dims, seed, n, dev, coarse=Layout.TILED_LINEAR):
    """A random dense-slot brickmap at factor 8 over a floor, and rays from
    inside and outside it, from a numpy seed."""
    X, Y, Z = dims
    rng = np.random.default_rng(seed)
    dense = rng.random((Z, Y, X)) < 0.006
    dense[:, :4, :] = rng.random((Z, 4, X)) < 0.5
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense).to(dev)), 8, coarse_layout=coarse,
                        brick_layout=Layout.TILED_LINEAR)
    w = np.asarray(dims, np.float32)
    o = rng.random((n, 3)) * w * 1.8 - w * 0.4
    d = rng.random((n, 3)) * w - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[1:4] = np.eye(3)  # axis-aligned
    return bm, torch.from_numpy(o.astype(np.float32)).to(dev), torch.from_numpy(d.astype(np.float32)).to(dev)


def _assert_same(got, want):
    assert torch.equal(got.hit, want.hit) and torch.equal(got.steps, want.steps)
    assert torch.equal(got.position[got.hit], want.position[want.hit])
    assert torch.equal(got.normal[got.hit], want.normal[want.hit])


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared_meta", "global_meta"])
@pytest.mark.parametrize("coarse", ["LINEAR", "TILED_MORTON"])
def test_both_instantiations_match_plain_trace_on_card(cuda_device, monkeypatch, shared, coarse):
    """Each instantiation == the plain trace on a 64^3 world (512 chunks);
    the global one is forced by a zero limit."""
    bm, o, d = _world_and_rays((64, 64, 64), 90, 4096, cuda_device, Layout[coarse])
    if not shared:
        monkeypatch.setattr(bmtrace, "SMEM_META_LIMIT", 0)
    before = (bmtrace.launches, bmtrace.shared_launches)
    got = trace_brickmap_mxu(bm, o, d, 256)
    torch.cuda.synchronize()
    assert (bmtrace.launches, bmtrace.shared_launches) == (before[0] + 1, before[1] + shared)
    _assert_same(got, trace_brickmap(bm, o, d, 256))


@pytest.mark.cuda
def test_global_meta_on_a_world_over_the_limit_on_card(cuda_device):
    """A 384x256x384 world at factor 8 (73,728 chunks, 288 KB of meta) runs
    the global-meta instantiation by its size, and == the plain trace."""
    bm, o, d = _world_and_rays((384, 256, 384), 91, 16384, cuda_device)
    assert not bmtrace.meta_in_shared(bm.num_chunks)
    before = (bmtrace.launches, bmtrace.shared_launches)
    got = trace_brickmap_mxu(bm, o, d, 1024)
    torch.cuda.synchronize()
    assert (bmtrace.launches, bmtrace.shared_launches) == (before[0] + 1, before[1])
    _assert_same(got, trace_brickmap(bm, o, d, 1024))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared_meta", "global_meta"])
@pytest.mark.parametrize("name", sorted(COMPACT_WORLDS))
def test_compact_instantiations_match_plain_trace_on_card(cuda_device, monkeypatch, name, shared):
    """K4's compact instantiation, each meta placement (global forced by a
    zero limit), == the plain trace on the compact worlds, bit for bit, and
    its launches are counted as its own."""
    bm = _port_compact_world(name, cuda_device)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in _compact_rays(bm.world_dims, 98))
    if not shared:
        monkeypatch.setattr(bmtrace, "SMEM_META_LIMIT", 0)
    before = (bmtrace.launches, bmtrace.compact_launches, bmtrace.compact_shared_launches)
    got = trace_brickmap_no_table(bm, o, d, MAX_STEPS)
    torch.cuda.synchronize()
    assert (bmtrace.launches, bmtrace.compact_launches, bmtrace.compact_shared_launches) == (
        before[0], before[1] + 1, before[2] + shared)
    want = trace_brickmap(bm, o, d, MAX_STEPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_compact_global_meta_on_a_world_over_the_limit_on_card(cuda_device):
    """``compact_brickmap`` of a 384x256x384 world at factor 8 (288 KB of
    meta) runs the global-meta compact instantiation by its size, and ==
    the plain trace."""
    bm, o, d = _world_and_rays((384, 256, 384), 92, 16384, cuda_device)
    bm = compact_brickmap(bm)
    before = (bmtrace.compact_launches, bmtrace.compact_shared_launches)
    got = trace_brickmap_no_table(bm, o, d, 1024)
    torch.cuda.synchronize()
    assert (bmtrace.compact_launches, bmtrace.compact_shared_launches) == (before[0] + 1, before[1])
    _assert_same(got, trace_brickmap(bm, o, d, 1024))


@pytest.mark.cuda
def test_wrapper_refuses_malformed_tables_on_card(cuda_device):
    rays = _rays(4, cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="meta"):
        bmtrace.bmtrace_rays(*rays, torch.zeros(63, **i32), torch.zeros(64, 16, **i32), grid_dims=(4, 4, 4), **KW)
    with pytest.raises(ValueError, match="bricks"):
        bmtrace.bmtrace_rays(*rays, torch.zeros(64, **i32), torch.zeros(64, 15, **i32), grid_dims=(4, 4, 4), **KW)
    with pytest.raises(ValueError, match="meta"):
        bmtrace.bmtrace_rays(*rays, torch.zeros(64, dtype=torch.int64, device=cuda_device),
                             torch.zeros(64, 16, **i32), grid_dims=(4, 4, 4), **KW)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
