"""The port's macro skip levels, diagnostic counters, K5 and the staged trace
against the JAX package.

The JAX side (``trace_brickmap_hbm(use_macro=True, return_phases=True)`` and
``trace_brickmap_hbm_rr``, Pallas in interpret mode, as
``tests/test_pallas_bigtrace.py`` runs them) is computed once, in a
subprocess whose XLA:CPU neither contracts FMAs nor runs the algebraic
simplifier (``tests/test_torch_trace.py`` module doc).  Worlds and rays are
made from numpy seeds; the JAX package builds the worlds and hands them
over as numpy arrays.

Held bit for bit against it, on five worlds (a random 64^3 world at factor
8, a compact 128x64x128 terrain at factor 32, a floor-only 128^3 world at
factor 8 with rays fired down from its empty top regions (L1 skips), the
sparse 16384x512x16384 world at factor 32 (L2 and L3 skips) and a budget
case whose skips are charged past the step budget): the port's plain macro
walk (``ops/bigtrace.py::trace_brickmap_lt``) and the g++ build of
``csrc/dda.cuh`` with the macro levels on give the same hits, steps,
normals, positions and path counters (``mskip cadv pend desc fstep step2
asc xrun``).  ``stall``/``adjstall`` count the TPU line cache's waits and
are 0 in the port.  Iteration counts are not compared: the TPU's is its
tile's lockstep count, the port's the ray's own loop count (one DDA event
per iteration, so a descend and a double step take one and two).

K5's host entry (the kernel's per-lane refill schedule for one warp: 32
``csrc/dda.cuh::RayState`` lanes advanced in lockstep by ``ray_iterate``,
idle lanes refilled from the queue once ``refill`` of them are idle) and
``trace_brickmap_hbm_rr``'s CPU route equal JAX's ``trace_brickmap_hbm_rr``
bit for bit on the five worlds with the macro levels on and off, at refill
1, 8 and 32, and on a 1280-ray batch (JAX's own test of it allows
``atol=1e-5`` on positions, ``tests/test_pallas_bigtrace.py:482``, for its
f32 row-sum write-back; the bits agree here).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.config import Environment, RenderConfig
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap, build_brickmap_terrain_compact, pack_meta
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops.bigtrace import (
    PHASES,
    brick_lines_view,
    make_line_table,
    trace_brickmap_hbm,
    trace_brickmap_hbm_rr,
    trace_brickmap_hbm_staged,
    trace_brickmap_lt,
)
from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup, kernel_result, trace_brickmap
from voxelengine_tpu_torch.render import frame

ROOT = Path(__file__).resolve().parent.parent
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
PATH_COUNTERS = ("mskip", "cadv", "pend", "desc", "fstep", "step2", "asc", "xrun")
# name -> (max_steps, skips must fire)
CASES = {
    "random": (256, False),
    "terrain": (512, False),
    "floor": (512, True),
    "sparse16k": (1024, True),
    "budget": (12, True),
}
RR_RAYS = 1280  # tests/test_pallas_bigtrace.py:476: 10 rows of 128
RR_REFILLS = (1, 8, 32)  # K5's refill: every idle lane at once, a quarter of the warp, the whole warp


def _random_dense():
    rng = np.random.default_rng(300)
    dense = rng.random((64, 64, 64)) < 0.02
    dense[:, 0:4, :] = rng.random((64, 4, 64)) < 0.5
    return dense


def _floor_dense():
    """128^3, floor only: 2x2x2 regions at factor 8, the top ones empty."""
    dense = np.zeros((128, 128, 128), bool)
    dense[:, 0:2, :] = True
    return dense


def _spread_rays(seed, n, world, spread):
    rng = np.random.default_rng(seed)
    w = np.asarray(world, np.float32)
    o = (rng.random((n, 3)) * w * spread - w * (spread - 1) / 2).astype(np.float32)
    d = (rng.random((n, 3)) * w).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _sparse_16k_meta():
    """``tests/test_pallas_bigtrace.py:500-531``'s world as flat arrays:
    512x16x512 chunks at factor 32 (8192 regions, 16 L2 words, real L3), a
    floor pad with a small tower at the centre and one far lone chunk, all
    sharing one full brick."""
    gx, gy, gz = 512, 16, 512
    occ = np.zeros((gz, gy, gx), bool)
    occ[248:265, 0, 248:265] = True
    occ[254:257, 1:6, 254:257] = True
    occ[40, 0, 40] = True
    flat = occ.reshape(-1)
    full = int(pack_meta(torch.tensor(True), torch.zeros(3, dtype=torch.int32), torch.full((3,), 31, dtype=torch.int32)))
    meta = np.where(flat, full, 0).astype(np.int32)
    brick_idx = np.where(flat, 0, -1).astype(np.int32)
    bricks = np.full((1, 32**3 // 32), -1, np.int32)
    return dict(meta=meta, brick_idx=brick_idx, bricks=bricks, grid_dims=np.asarray((gx, gy, gz)), factor=32,
                coarse_layout=Layout.LINEAR.value, brick_layout=Layout.TILED_LINEAR.value, dense_slots=False)


# Two sky rays of the sparse world on which the TPU kernel's macro walk
# charges one step more than the chunk-by-chunk walk (22 and 12 against 21
# and 11; both leave the world without a hit): the port follows the kernel.
SPARSE_APART = np.asarray([[983.8653564453125, 124.68800354003906, 1854.737548828125],
                           [1675.7236328125, 255.24696350097656, 1281.6517333984375]], np.float32)
SPARSE_APART_DIRS = np.asarray([[0.2748611271381378, 0.9120317697525024, 0.30438363552093506],
                                [0.07762842625379562, 0.9829841256141663, -0.16648122668266296]], np.float32)
# case -> rays whose steps the macro walk charges one more than the chunk walk
CHUNK_WALK_APART = {"sparse16k": [128, 129]}


def _sparse_16k_rays(n=128):
    """Near, horizon and sky rays (``tests/test_pallas_bigtrace.py:550-577``),
    then the two rays of :data:`SPARSE_APART`."""
    rng = np.random.default_rng(301)
    kinds = rng.integers(0, 3, n)
    o_near = np.stack([rng.uniform(7940, 8480, n), rng.uniform(80, 400, n), rng.uniform(7940, 8480, n)], -1)
    d_near = np.stack([rng.normal(0, 0.3, n), -np.ones(n), rng.normal(0, 0.3, n)], -1)
    o_far = np.stack([rng.uniform(800, 2000, n), rng.uniform(100, 480, n), rng.uniform(800, 2000, n)], -1)
    d_far = np.asarray([8192.0, 120.0, 8192.0]) - o_far
    d_sky = np.stack([rng.normal(0, 0.2, n), np.ones(n), rng.normal(0, 0.2, n)], -1)
    o = np.where((kinds == 0)[:, None], o_near, o_far)
    d = np.where((kinds == 0)[:, None], d_near, np.where((kinds == 1)[:, None], d_far, d_sky))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.concatenate([o.astype(np.float32), SPARSE_APART]),
            np.concatenate([d.astype(np.float32), SPARSE_APART_DIRS]))


def _case_rays(name):
    if name == "random":
        o, d = _spread_rays(302, 256, (64, 64, 64), 2.0)
        d[1:4] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]  # zero direction components
        return o, d
    if name == "terrain":
        return _spread_rays(303, 256, (128, 64, 128), 1.5)
    if name == "floor":  # tests/test_pallas_bigtrace.py:740-744
        rng = np.random.default_rng(304)
        o = np.tile(np.asarray([[64.0, 126.0, 64.0]], np.float32), (256, 1))
        d = (rng.random((256, 3)) * np.asarray([128, 2, 128])).astype(np.float32) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return o, d.astype(np.float32)
    if name == "budget":  # grazing rays in the empty top regions and in the floor's
        n = 128
        o = np.tile(np.asarray([[1.0, 100.0, 1.0]], np.float32), (n, 1))
        o[n // 2:, 1] = 30.0
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        d = np.stack([np.cos(ang), np.full(n, -0.01), np.sin(ang)], axis=1).astype(np.float32)
        return o, d
    return _sparse_16k_rays()


def _jax_reference():
    """JAX side of every case (runs in the subprocess, module doc)."""
    import jax.numpy as jnp

    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.brickmap import BrickMap as JBrickMap
    from voxelengine_tpu.core.brickmap import build_brickmap as j_build
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact as j_terrain
    from voxelengine_tpu.core.layout import Layout as JL
    from voxelengine_tpu.ops.pallas_bigtrace import make_line_table as j_lt
    from voxelengine_tpu.ops.pallas_bigtrace import trace_brickmap_hbm as j_hbm
    from voxelengine_tpu.ops.pallas_bigtrace import trace_brickmap_hbm_rr as j_rr

    s = _sparse_16k_meta()
    worlds = {
        "random": j_build(JGrid.from_dense(_random_dense()), 8, coarse_layout=JL.LINEAR),
        "terrain": j_terrain((128, 64, 128), 32, octaves=3),
        "floor": j_build(JGrid.from_dense(_floor_dense()), 8),
        "sparse16k": JBrickMap(
            meta=jnp.asarray(s["meta"]), brick_idx=jnp.asarray(s["brick_idx"]),
            bricks=jnp.asarray(s["bricks"].view(np.uint32)), grid_dims=tuple(int(v) for v in s["grid_dims"]),
            factor=32, coarse_layout=JL.LINEAR, brick_layout=JL.TILED_LINEAR, dense_slots=False,
        ),
    }
    worlds["budget"] = worlds["floor"]
    out = {}
    for name, (max_steps, _) in CASES.items():
        bm = worlds[name]
        for k in BM_KEYS:
            v = getattr(bm, k)
            out[f"{name}/{k}"] = np.asarray(getattr(v, "value", v))
        o, d = _case_rays(name)
        res, ph = j_hbm(bm, j_lt(bm), o, d, max_steps, tile=128, num_slots=4, use_macro=True,
                        return_phases=True, interpret=True)
        for k in ("hit", "position", "normal", "steps"):
            out[f"{name}/{k}"] = np.asarray(getattr(res, k))
        for k, v in ph.items():
            out[f"{name}/ph/{k}"] = np.asarray(v)
        for use_macro in (True, False):
            res = j_rr(bm, j_lt(bm), o, d, max_steps, rows_inflight=4, num_slots=4, use_macro=use_macro,
                       interpret=True)
            for k in ("hit", "position", "normal", "steps"):
                out[f"rr/{name}/{use_macro}/{k}"] = np.asarray(getattr(res, k))

    bm = worlds["random"]
    o, d = _spread_rays(305, RR_RAYS, (64, 64, 64), 2.0)
    res = j_rr(bm, j_lt(bm), o, d, 256, rows_inflight=4, num_slots=4, interpret=True)
    for k in ("hit", "position", "normal", "steps"):
        out[f"rr/{k}"] = np.asarray(getattr(res, k))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "macro_ref.npz"
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


def _bm(ref, name):
    return brickmap_from_numpy({k: ref[f"{name}/{k}"] for k in BM_KEYS}, device="cpu")


def _rays(name):
    return tuple(torch.from_numpy(a) for a in _case_rays(name))


def _assert_trace_equal(got, ref, prefix):
    """Hits, steps, normals and positions bit-equal, on every ray."""
    for k in ("hit", "steps", "normal", "position"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[f"{prefix}/{k}"], err_msg=k)


def _assert_counters(dg, ref, name):
    """The path counters bit-equal to JAX's; the port's cache counters 0;
    every counted event its own iteration (``step2`` rides an ``fstep``)."""
    for i, k in enumerate(PHASES):
        if k in PATH_COUNTERS:
            np.testing.assert_array_equal(dg[i].numpy(), ref[f"{name}/ph/{k}"], err_msg=k)
        else:
            assert not dg[i].any(), k
    c = {k: dg[i].long() for i, k in enumerate(PHASES)}
    events = c["mskip"] + c["cadv"] + c["desc"] + c["fstep"] + c["asc"]
    assert (events <= dg[len(PHASES)]).all()
    assert (c["step2"] <= c["fstep"]).all() and (c["xrun"] <= c["fstep"]).all()
    # JAX's own accounting (tests/test_pallas_bigtrace.py:654-657)
    jax_active = sum(ref[f"{name}/ph/{k}"].astype(np.int64) for k in ("stall", "mskip", "cadv", "pend", "desc",
                                                                       "fstep", "asc"))
    assert (jax_active <= ref[f"{name}/ph/iters"]).all()


def _host_trace(bm, lt, origins, rays, max_steps, use_macro=True, rr_refill=None):
    """The line-table trace through the g++ build of csrc/dda.cuh: K1's
    host entry with the diag counters, or with ``rr_refill`` K5's, whose
    second result is then its counting sums (lanes iterating, warp-
    iterations)."""
    from voxelengine_tpu_torch.kernels import build

    lib = build.load_dda_host()
    d, start_c, start_normal, active = _ray_setup(bm.grid_dims, bm.factor, origins, rays)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, "cpu"), d).contiguous()
    start_c, d, active = start_c.contiguous(), d.contiguous(), active.to(torch.int32).contiguous()
    n = origins.shape[0]
    outs = (torch.empty(n, dtype=torch.int32), torch.empty(n, 3), torch.empty(n, 3), torch.empty(n, dtype=torch.int32))
    dg = torch.zeros((len(PHASES) + 1, n), dtype=torch.int32)
    (gx, gy, gz), (rx, ry, rz) = bm.grid_dims, lt.region_dims
    args = [t.data_ptr() for t in (start_c, d, active, pad, lt.region_lines, brick_lines_view(bm).contiguous(),
                                   lt.macro, lt.macro2)]
    args += [n, gx, gy, gz, rx, ry, rz, bm.factor, bm.words_per_brick, max_steps, bm.brick_layout.value,
             3 * max_steps + 64, int(use_macro)]
    if rr_refill is None:
        err = lib.vx_trace_host(*args, *(o.data_ptr() for o in outs), dg.data_ptr())
    else:
        dg = torch.zeros(2, dtype=torch.int64)
        err = lib.vx_rrtrace_host(*args, rr_refill, None, dg.data_ptr(), *(o.data_ptr() for o in outs))
    assert err == 0
    return kernel_result(*outs, start_c, start_normal, bm.factor), dg


@pytest.fixture(scope="module")
def host_build():
    import shutil

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler for the host build of csrc/dda.cuh")


@pytest.mark.parametrize("name", list(CASES))
def test_macro_walk_matches_jax(ref, name):
    """Plain macro walk (``trace_brickmap_hbm`` on the CPU) == JAX's
    ``trace_brickmap_hbm(use_macro=True, return_phases=True)``."""
    max_steps, skips = CASES[name]
    bm = _bm(ref, name)
    o, d = _rays(name)
    got, iters, phases = trace_brickmap_hbm(bm, make_line_table(bm), o, d, max_steps,
                                            return_iters=True, return_phases=True)
    _assert_trace_equal(got, ref, name)
    assert list(phases) == list(PHASES) + ["iters"] and torch.equal(iters, phases["iters"])
    dg = torch.stack([phases[k] for k in PHASES] + [iters])
    _assert_counters(dg, ref, name)
    assert (int(phases["mskip"].sum()) > 0) == skips
    if name == "budget":
        cut = got.steps == max_steps
        assert int(cut.sum()) >= 16 and not bool(got.hit[cut].any())
        assert bool((phases["mskip"][cut] > 0).any())  # a skip charged past the budget


@pytest.mark.parametrize("name", list(CASES))
def test_host_build_with_macro_matches_jax(ref, host_build, name):
    """csrc/dda.cuh with MACRO and DIAG, built by g++ == JAX, and its
    iteration counts == the plain walk's."""
    max_steps, _ = CASES[name]
    bm = _bm(ref, name)
    lt = make_line_table(bm)
    o, d = _rays(name)
    got, dg = _host_trace(bm, lt, o, d, max_steps)
    _assert_trace_equal(got, ref, name)
    _assert_counters(dg, ref, name)
    _, want = trace_brickmap_lt(bm, lt, o, d, max_steps, diag=True)
    assert torch.equal(dg, want)


@pytest.mark.parametrize("name", list(CASES))
def test_macro_off_is_the_chunk_walk(ref, host_build, name):
    """``use_macro=False``: the plain line-table walk and the host build give
    the chunk-by-chunk ``trace_brickmap``'s results, with no skips counted.
    With the skips on, hits, positions and normals stay the chunk walk's,
    and steps too but on the :data:`CHUNK_WALK_APART` rays (one more, as
    JAX's kernel charges them: ``test_macro_walk_matches_jax``)."""
    max_steps, _ = CASES[name]
    bm = _bm(ref, name)
    lt = make_line_table(bm)
    o, d = _rays(name)
    want = trace_brickmap(bm, o, d, max_steps)
    assert all(torch.equal(a, b) for a, b in zip(trace_brickmap_hbm(bm, lt, o, d, max_steps, use_macro=False), want))
    got, phases = trace_brickmap_hbm(bm, lt, o, d, max_steps, use_macro=False, return_phases=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and not phases["mskip"].any()
    host, dg = _host_trace(bm, lt, o, d, max_steps, use_macro=False)
    assert all(torch.equal(a, b) for a, b in zip(host, want))
    assert torch.equal(dg, torch.stack([phases[k] for k in PHASES + ("iters",)]))
    macro = trace_brickmap_hbm(bm, lt, o, d, max_steps)
    for k in ("hit", "position", "normal"):
        assert torch.equal(getattr(macro, k), getattr(want, k)), k
    apart = torch.nonzero(macro.steps != want.steps).squeeze(1)
    assert apart.tolist() == CHUNK_WALK_APART.get(name, [])
    assert (macro.steps[apart] - want.steps[apart] == 1).all() and not macro.hit[apart].any()


@pytest.mark.parametrize("refill", RR_REFILLS)
@pytest.mark.parametrize("use_macro", [True, False], ids=["macro", "nomacro"])
@pytest.mark.parametrize("name", list(CASES))
def test_rr_matches_jax(ref, host_build, name, use_macro, refill):
    """K5's host entry (the per-lane refill schedule at ``refill``) and
    ``trace_brickmap_hbm_rr``'s CPU route == JAX's row-retirement kernel,
    bit for bit (module doc), with the macro levels on and off; the
    counting sums add up to every ray's own iterations."""
    max_steps, _ = CASES[name]
    bm = _bm(ref, name)
    lt = make_line_table(bm)
    o, d = _rays(name)
    got, stats = _host_trace(bm, lt, o, d, max_steps, use_macro, rr_refill=refill)
    _assert_trace_equal(got, ref, f"rr/{name}/{use_macro}")
    _assert_trace_equal(trace_brickmap_hbm_rr(bm, lt, o, d, max_steps, use_macro, refill=refill), ref,
                        f"rr/{name}/{use_macro}")
    _, dg = trace_brickmap_lt(bm, lt, o, d, max_steps, use_macro, diag=True)
    _assert_lane_counts(stats, dg[len(PHASES)], refill)


def _assert_lane_counts(stats, own, refill):
    """K5's counting sums against the rays' own iteration counts ``own``:
    every iteration of every ray is one lane of one warp-iteration; at
    refill 32 a warp takes 32 consecutive rays and runs until the longest
    ends, as K1's warps do."""
    lanes, warp_iters = stats.tolist()
    assert lanes == int(own.sum())
    assert max(-(-lanes // 32), int(own.max())) <= warp_iters
    if refill == 32:
        assert warp_iters == int(_warp_max(own)[::32].sum())


@pytest.mark.parametrize("refill", RR_REFILLS)
def test_rr_batch_matches_jax(ref, host_build, refill):
    """The same on JAX's own 1280-ray batch of the random world
    (``tests/test_pallas_bigtrace.py:476``), ten rows of 128: the queue
    refills a warp's lanes many times over."""
    bm = _bm(ref, "random")
    lt = make_line_table(bm)
    o, d = (torch.from_numpy(a) for a in _spread_rays(305, RR_RAYS, (64, 64, 64), 2.0))
    got, _ = _host_trace(bm, lt, o, d, 256, rr_refill=refill)
    _assert_trace_equal(got, ref, "rr")
    _assert_trace_equal(trace_brickmap_hbm_rr(bm, lt, o, d, 256, refill=refill), ref, "rr")


def test_rr_host_entry_without_rays(ref, host_build):
    bm = _bm(ref, "random")
    z = torch.zeros((0, 3))
    got, stats = _host_trace(bm, make_line_table(bm), z, z, 256, rr_refill=32)
    assert got.hit.shape == (0,) and got.position.shape == (0, 3) and not stats.any()


@pytest.mark.parametrize("name,stride", [("random", 2), ("floor", 2), ("sparse16k", 4)])
def test_probe_use_macro_decisions(ref, name, stride):
    """``probe_use_macro`` (``render/frame.py``): False on the random world
    (every region occupied), True where rays cross empty regions; the same
    decision as JAX's counters on the same strided rays."""
    bm = _bm(ref, name)
    o, d = _rays(name)
    cfg = RenderConfig(max_steps=CASES[name][0])
    got = frame.probe_use_macro(bm, make_line_table(bm), o, d, cfg, stride=stride)
    assert got is (name != "random")
    assert got is bool(ref[f"{name}/ph/mskip"][::stride].sum() != 0)


@pytest.mark.parametrize("stage_steps,tail_frac,calls", [
    (24, 2, [(512, 24), (256, 256)]),  # the two survivor rows retraced
    (4, 2048, [(512, 4), (512, 256)]),  # more survivor rows than the buffer: the rescue
    (2048, 8, [(512, 2048)]),  # no survivors
])
def test_staged_equals_single_launch(ref, monkeypatch, stage_steps, tail_frac, calls):
    """Each path of ``trace_brickmap_hbm_staged`` equals one full-budget
    trace exactly; rays 256-511 leave the world at once, so only the first
    two 128-ray rows can hold survivors."""
    import voxelengine_tpu_torch.ops.bigtrace as B

    bm = _bm(ref, "random")
    lt = make_line_table(bm)
    o, d = (torch.from_numpy(a) for a in _spread_rays(306, 512, (64, 64, 64), 2.0))
    o[256:], d[256:] = torch.tensor([32.0, 200.0, 32.0]), torch.tensor([0.0, 1.0, 0.0])
    want = trace_brickmap_hbm(bm, lt, o, d, 256)
    seen = []
    single = B.trace_brickmap_hbm

    def spy(bm, lt, o, d, max_steps, *args):
        seen.append((o.shape[0], max_steps))
        return single(bm, lt, o, d, max_steps, *args)

    monkeypatch.setattr(B, "trace_brickmap_hbm", spy)
    got = trace_brickmap_hbm_staged(bm, lt, o, d, 256, stage_steps=stage_steps, tail_frac=tail_frac)
    assert seen == calls
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_shade_pixels_routes(ref):
    """``render_frame`` through the line table: macro on, macro off and the
    staged trace give the frame of the plain chunk walk (no ``lt``)."""
    bm = _bm(ref, "floor")
    lt = make_line_table(bm)
    env = Environment.default(device="cpu")
    origin, euler = torch.tensor([64.0, 120.0, 20.0]), torch.tensor([-0.6, 0.3, 0.0])
    base = RenderConfig(width=48, height=32, max_steps=512)

    def render(cfg, lt):
        fb = frame.make_framebuffer(cfg, device="cpu")
        return frame.render_frame(bm, fb, origin, euler, env, 1, cfg, lt=lt)

    want = render(base, None)
    for kw in (dict(), dict(trace_use_macro=False), dict(trace_stage_steps=16, trace_tail_frac=2)):
        cfg = RenderConfig(width=48, height=32, max_steps=512, **kw)
        assert torch.equal(render(cfg, lt), want), kw


def test_return_shapes_on_cpu(ref):
    """``trace_brickmap_hbm``'s return forms are the JAX function's."""
    bm = _bm(ref, "random")
    lt = make_line_table(bm)
    o, d = (t[:16] for t in _rays("random"))
    assert len(trace_brickmap_hbm(bm, lt, o, d, 64)) == 4  # a TraceOut
    res, iters = trace_brickmap_hbm(bm, lt, o, d, 64, return_iters=True)
    assert iters.shape == (16,) and iters.dtype == torch.int32
    res2, ph = trace_brickmap_hbm(bm, lt, o, d, 64, return_phases=True)
    assert torch.equal(ph["iters"], iters) and all(torch.equal(a, b) for a, b in zip(res, res2))


def test_kernel_wrappers_refuse_bad_inputs():
    from voxelengine_tpu_torch.kernels import bigtrace, rrtrace

    z3, zi = torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32)
    tables = (torch.zeros(8, 128, dtype=torch.int32), torch.zeros(8, 128, dtype=torch.int32))
    kw = dict(grid_dims=(8, 8, 8), region_dims=(1, 1, 1), factor=8, wpb=16, max_steps=16,
              brick_layout=Layout.TILED_LINEAR, use_macro=True)
    for fn in (bigtrace.bigtrace, rrtrace.rrtrace):
        with pytest.raises(ValueError, match="CUDA"):
            fn(z3, z3, zi, zi.new_zeros(4, 3), *tables, **kw)
    for refill in (0, 33):
        with pytest.raises(ValueError, match="1-32"):
            rrtrace.rrtrace(z3, z3, zi, zi.new_zeros(4, 3), *tables, refill=refill, **kw)


# ------------------------------------------------------- card lane (an H100)


def _port_world(name, device):
    """The case's world built by the port alone (no JAX), with its rays."""
    if name == "random":
        bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(_random_dense()).to(device)), 8,
                            coarse_layout=Layout.LINEAR)
    elif name == "terrain":
        bm = build_brickmap_terrain_compact((128, 64, 128), 32, octaves=3, device=device)
    elif name in ("floor", "budget"):
        bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(_floor_dense()).to(device)), 8)
    else:
        bm = brickmap_from_numpy(_sparse_16k_meta(), device=device)
    return bm, *(t.to(device) for t in _rays(name))


def test_port_worlds_match_the_jax_build(ref):
    """The card lane's port-built worlds are the JAX package's worlds."""
    for name in CASES:
        bm, _, _ = _port_world(name, "cpu")
        want = _bm(ref, name)
        for k in ("meta", "brick_idx", "bricks"):
            assert torch.equal(getattr(bm, k), getattr(want, k)), (name, k)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


def _warp_max(x):
    """Each ray's warp (32 consecutive rays) maximum."""
    n = x.shape[0]
    padded = torch.cat([x, x.new_zeros((-n) % 32)])
    return padded.reshape(-1, 32).amax(dim=1).repeat_interleave(32)[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_bigtrace_macro_and_diag_match_plain_on_card(cuda_device, name):
    """K1 with the macro levels on and off, and its diag build, == the plain
    walks on the card, bit for bit; iterations == the plain walk's warp max."""
    from voxelengine_tpu_torch.kernels import bigtrace

    max_steps, skips = CASES[name]
    bm, o, d = _port_world(name, cuda_device)
    lt = make_line_table(bm)
    before = bigtrace.launches
    for use_macro in (True, False):
        want, wdg = trace_brickmap_lt(bm, lt, o, d, max_steps, use_macro, diag=True)
        got = trace_brickmap_hbm(bm, lt, o, d, max_steps, use_macro=use_macro)
        got2, phases = trace_brickmap_hbm(bm, lt, o, d, max_steps, use_macro=use_macro, return_phases=True)
        for out in (got, got2):
            assert all(torch.equal(a, b) for a, b in zip(out, want))
        for i, k in enumerate(PHASES):
            assert torch.equal(phases[k], wdg[i]), k
        assert torch.equal(phases["iters"], _warp_max(wdg[len(PHASES)]))
        assert (int(phases["mskip"].sum()) > 0) == (skips and use_macro)
    torch.cuda.synchronize()
    assert bigtrace.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 20, 1000, 1 << 20])
def test_rrtrace_matches_plain_on_card(cuda_device, n):
    """K5 == the plain macro walk for no rays, fewer rays than a warp, a
    count that is not a multiple of 32, and far more rays than the card
    holds threads; at every refill of the CPU tests and the default, twice
    in a row (the counter is reset on the stream)."""
    from voxelengine_tpu_torch.kernels import rrtrace

    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(_floor_dense()).to(cuda_device)), 8)
    lt = make_line_table(bm)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in _spread_rays(307, n, (128, 128, 128), 1.5))
    want = trace_brickmap_lt(bm, lt, o, d, 512)
    refills = sorted(set(RR_REFILLS) | {rrtrace.REFILL})
    before = rrtrace.launches
    for refill in refills:
        for _ in range(2):
            got = trace_brickmap_hbm_rr(bm, lt, o, d, 512, refill=refill)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    assert rrtrace.launches == before + (2 * len(refills) if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("refill", RR_REFILLS)
@pytest.mark.parametrize("name", list(CASES))
def test_rrtrace_counting_build_on_card(cuda_device, name, refill):
    """K5's counting instantiation on the card: results equal the plain
    walk's, and its counting sums agree with the rays' own iterations
    (``_assert_lane_counts``: the card's warps take rays in another order
    than the host's one warp, but at refill 32 each takes 32 consecutive
    rays)."""
    from voxelengine_tpu_torch.kernels import rrtrace
    from voxelengine_tpu_torch.ops.bigtrace import _kernel_rays, _kernel_tables

    max_steps, _ = CASES[name]
    bm, o, d = _port_world(name, cuda_device)
    lt = make_line_table(bm)
    want, dg = trace_brickmap_lt(bm, lt, o, d, max_steps, diag=True)
    start_c, dd, active, pad, start_normal = _kernel_rays(bm, o, d)
    tables, kw = _kernel_tables(bm, lt, max_steps, True)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    outs = rrtrace.rrtrace(start_c, dd, active, pad, *tables, refill=refill, stats=stats, **kw)
    got = kernel_result(*outs, start_c, start_normal, bm.factor)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _assert_lane_counts(stats.cpu(), dg[len(PHASES)].cpu(), refill)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
