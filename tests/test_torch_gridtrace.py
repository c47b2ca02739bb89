"""The PyTorch port's small-world path against the JAX package: the dense-grid
traversal (``trace_grid``, ``trace_grid_vpu``, ``trace_grid_mxu``), the
on-chip brickmap traversal (``trace_brickmap_mxu``) and
``render_frame_dense``; and the host builds of the Hopper kernels' logic
(K2's and K3's whole function, ``csrc/ray_setup.cuh`` and
``csrc/grid_dda.cuh``, against JAX's ``trace_grid_vpu``; the grid walk alone
with both word fetches and ``csrc/dda.cuh`` with the dense-slot fetch
against the plain traces).

As in ``test_torch_trace.py``, the JAX side runs in a subprocess whose
XLA:CPU neither contracts FMAs nor runs the algebraic simplifier, and its
Pallas kernels run in interpret mode, as ``tests/test_pallas_trace.py`` and
``tests/test_pallas_trace2.py`` run them.  Inputs are made from numpy seeds.
Hits, steps, normals and positions are compared bit for bit; the TPU
kernels' ``BIG = 3.4e38`` stand-in for infinity gives the same results as
``inf`` on these rays, axis-aligned ones included.
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
from voxelengine_tpu_torch.core.brickmap import build_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.io.interop import bitgrid_from_numpy, brickmap_from_numpy
from voxelengine_tpu_torch.ops.gridtrace import trace_grid_mxu, trace_grid_vpu, words_to_limb_rows, words_to_rows_i32
from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup, kernel_result, trace_brickmap, trace_grid
from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_mxu
from voxelengine_tpu_torch.render import frame

ROOT = Path(__file__).resolve().parent.parent
LAYOUTS = ("LINEAR", "TILED_LINEAR", "TILED_MORTON")
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
# dense-grid cases: name -> (layout, max_steps, take_initial_step)
GRID_CASES = {
    "linear": ("LINEAR", 256, False),
    "tiled": ("TILED_LINEAR", 256, False),
    "morton": ("TILED_MORTON", 256, False),
    "budget": ("TILED_LINEAR", 10, False),
    "initial_step": ("LINEAR", 256, True),
}
# on-chip brickmap cases: name -> (coarse layout, brick layout)
BM_CASES = {
    "tiled": ("TILED_LINEAR", "TILED_LINEAR"),
    "linear": ("LINEAR", "LINEAR"),
    "morton": ("TILED_MORTON", "TILED_MORTON"),
    "mixed": ("LINEAR", "TILED_MORTON"),
}
# name -> (width, height, checkerboard, tile_order, frame numbers, secondary):
# with secondary, shadow_rays, ao_samples and reflections are set, which the
# dense path ignores (it traces no secondary rays), on JAX's side and the port's
DENSE_FRAMES = {
    "cb": (64, 48, True, False, (0, 1), False),
    "full_tiled": (64, 48, False, True, (0,), False),
    "cb_secondary_flags": (64, 48, True, False, (0, 1), True),
}
ORIGIN = np.array([16.0, 22.0, -10.0], np.float32)
EULER = np.array([-0.35, 3.14159, 0.0], np.float32)  # tests/test_pallas_trace.py:119


def _grid_dense():
    """A random 32^3 world with a floor (``tests/test_pallas_trace.py:80-81``)."""
    rng = np.random.default_rng(80)
    dense = rng.random((32, 32, 32)) < 0.015
    dense[:, :4, :] = rng.random((32, 4, 32)) < 0.6
    return dense


def _grid_rays(dense, n=640):
    """Rays from inside and outside (``tests/test_pallas_trace.py:82-86``),
    with axis-aligned ones, a start inside a solid voxel, a start on the
    grid's maximal face and rays that miss the grid."""
    rng = np.random.default_rng(81)
    o = (rng.random((n, 3)) * 60 - 15).astype(np.float32)
    t = (rng.random((n, 3)) * 32).astype(np.float32)
    d = t - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z, y, x = np.nonzero(dense[:, 4:, :])
    o[0] = [x[0] + 0.5, y[0] + 4.5, z[0] + 0.5]  # inside a solid voxel
    d[0] = [1.0, 0.0, 0.0]
    o[1:4] = [[5.5, 20.5, 7.5], [0.25, 30.0, 3.5], [10.5, 12.5, 0.75]]
    d[1:4] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    o[4], d[4] = [32.0, 10.5, 5.5], [-1.0, 0.0, 0.0]  # on the maximal x face
    o[5], d[5] = [40.0, 40.0, 40.0], [0.0, 1.0, 0.0]  # misses the grid
    o[6], d[6] = [-3.0, 2.5, 16.5], [1.0, 0.0, 0.0]  # axis-aligned from outside
    return o, d.astype(np.float32)


FULL_WORLDS = ("random", "terrain")


def _full_rays(dense):
    """Origins and raw (not normalized) directions for the fused kernels:
    starts inside and outside the grid, a start inside a solid voxel (a hit
    at the start cell, 0 steps), zero direction components, starts on the
    maximal x and y faces, a miss, an axis-aligned entry, and rays that
    enter the grid from below (a hit at the clipped start where the
    bottom voxel is solid: 0 steps and the world-entry normal, +y in the
    step-sign convention)."""
    rng = np.random.default_rng(84)
    n = 640
    o = (rng.random((n, 3)) * 60 - 15).astype(np.float32)
    v = ((rng.random((n, 3)) * 32).astype(np.float32) - o) * rng.uniform(0.1, 5.0, (n, 1)).astype(np.float32)
    z, y, x = np.nonzero(dense)
    o[0], v[0] = [x[0] + 0.5, y[0] + 0.5, z[0] + 0.5], [2.5, 0.0, 0.0]
    v[1:4] = [[0.0, -3.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.0, 7.0]]
    o[4], v[4] = [32.0, 10.5, 5.5], [-2.0, 0.0, 0.0]
    o[5], v[5] = [10.5, 32.0, 5.5], [0.3, -1.0, 0.2]
    o[6], v[6] = [40.0, 40.0, 40.0], [0.0, 1.0, 0.0]
    o[7], v[7] = [-3.0, 2.5, 16.5], [1.0, 0.0, 0.0]
    o[8:24] = np.stack([rng.uniform(0, 32, 16), np.full(16, -5.0), rng.uniform(0, 32, 16)], -1)
    v[8:24] = np.stack([rng.normal(0, 0.1, 16), np.full(16, 2.0), rng.normal(0, 0.1, 16)], -1)
    return o, v.astype(np.float32)


def _bm_dense():
    """``tests/test_pallas_trace2.py:13-19`` at 32^3."""
    rng = np.random.default_rng(82)
    dense = rng.random((32, 32, 32)) < 0.008
    dense[:, :5, :] = rng.random((32, 5, 32)) < 0.5
    return dense


def _bm_rays(dense, n=512):
    rng = np.random.default_rng(83)
    o = (rng.random((n, 3)) * 60 - 15).astype(np.float32)
    t = (rng.random((n, 3)) * 32).astype(np.float32)
    d = t - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z, y, x = np.nonzero(dense)
    o[0], d[0] = [x[0] + 0.5, y[0] + 0.5, z[0] + 0.5], [1.0, 0.0, 0.0]  # test_pallas_trace2.py:46-52
    d[1:3] = [[0.0, -1.0, 0.0], [0.0, 0.0, 1.0]]
    return o, d.astype(np.float32)


def _secondary_flags(on):
    return dict(shadow_rays=True, ao_samples=2, reflections=True) if on else {}


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import jax.numpy as jnp

    from voxelengine_tpu.config import Environment as JEnv
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.brickmap import build_brickmap as j_build
    from voxelengine_tpu.core.layout import Layout as JL
    from voxelengine_tpu.ops.pallas_trace import trace_grid_mxu as j_mxu
    from voxelengine_tpu.ops.pallas_trace import trace_grid_vpu as j_vpu
    from voxelengine_tpu.ops.pallas_trace2 import trace_brickmap_mxu as j_bm_mxu
    from voxelengine_tpu.ops.trace import trace_brickmap as j_trace_bm
    from voxelengine_tpu.ops.trace import trace_grid as j_trace_grid
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame_dense
    from voxelengine_tpu.worldgen.terrain import generate_world

    out = {}

    def put(prefix, r):
        for k in ("hit", "position", "normal", "steps"):
            out[f"{prefix}/{k}"] = np.asarray(getattr(r, k))

    dense = _grid_dense()
    o, d = (jnp.asarray(a) for a in _grid_rays(dense))
    for name, (lay, max_steps, initial) in GRID_CASES.items():
        g = JGrid.from_dense(dense, layout=JL[lay])
        out[f"grid/{name}/words"] = np.asarray(g.words)
        put(f"grid/{name}/trace_grid", j_trace_grid(g, o, d, max_steps, take_initial_step=initial))
        if not initial:
            put(f"grid/{name}/vpu", j_vpu(g, o, d, max_steps, tile=1024, interpret=True))
            put(f"grid/{name}/mxu", j_mxu(g, o, d, max_steps, interpret=True))

    terrain = np.asarray(generate_world((32, 32, 32), octaves=3).to_dense())
    out["full/terrain/dense"] = terrain
    for world, dense in (("random", _grid_dense()), ("terrain", terrain)):
        o, v = (jnp.asarray(a) for a in _full_rays(dense))
        for lay in LAYOUTS:
            g = JGrid.from_dense(dense, layout=JL[lay])
            out[f"full/{world}/{lay}/words"] = np.asarray(g.words)
            put(f"full/{world}/{lay}", j_vpu(g, o, v, 256, tile=1024, interpret=True))

    dense = _bm_dense()
    o, d = (jnp.asarray(a) for a in _bm_rays(dense))
    for name, (cl, bl) in BM_CASES.items():
        bm = j_build(JGrid.from_dense(dense), 8, coarse_layout=JL[cl], brick_layout=JL[bl])
        for k in BM_KEYS:
            v = getattr(bm, k)
            out[f"bm/{name}/{k}"] = np.asarray(getattr(v, "value", v))
        put(f"bm/{name}/mxu", j_bm_mxu(bm, o, d, 256, tile=512, interpret=True))
        put(f"bm/{name}/trace", j_trace_bm(bm, o, d, 256))

    g = generate_world((32, 32, 32), octaves=3)
    out["frame/words"] = np.asarray(g.words)
    env = JEnv.default()
    for name, (W, H, cb, to, frames, sec) in DENSE_FRAMES.items():
        cfg = JCfg(width=W, height=H, checkerboard=cb, tile_order=to, max_steps=256, **_secondary_flags(sec))
        fb = make_framebuffer(cfg)
        for fn in frames:
            fb = render_frame_dense(g, fb, jnp.asarray(ORIGIN), jnp.asarray(EULER), env, jnp.int32(fn), cfg,
                                    interpret=True)
            out[f"frame/{name}/{fn}"] = np.asarray(fb)
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
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "gridtrace_ref.npz"
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid(ref, name):
    return bitgrid_from_numpy(
        dict(words=ref[f"grid/{name}/words"], dims=(32, 32, 32), layout=Layout[GRID_CASES[name][0]].value),
        device="cpu",
    )


def _bm(ref, name):
    return brickmap_from_numpy({k: ref[f"bm/{name}/{k}"] for k in BM_KEYS}, device="cpu")


def _assert_equal(got, ref, prefix):
    """Hits, steps, normals and positions on hits bit-equal."""
    hit = ref[f"{prefix}/hit"]
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.steps.numpy(), ref[f"{prefix}/steps"])
    np.testing.assert_array_equal(got.normal.numpy()[hit], ref[f"{prefix}/normal"][hit])
    np.testing.assert_array_equal(got.position.numpy()[hit], ref[f"{prefix}/position"][hit])


def _assert_same(a, b):
    assert torch.equal(a.hit, b.hit) and torch.equal(a.steps, b.steps)
    assert torch.equal(a.position[a.hit], b.position[b.hit])
    assert torch.equal(a.normal[a.hit], b.normal[b.hit])


def _limb_rows_by_shifts(words):
    """``words_to_limb_rows``' earlier form (13 eager ops): limb ``k`` as
    ``(word >> 8k) & 0xFF``."""
    padn = (-words.shape[0]) % 128
    if padn:
        words = torch.cat([words, words.new_zeros((padn,))])
    rows = words.reshape(-1, 128)
    return torch.stack([((rows >> s) & 0xFF).to(torch.uint8) for s in (0, 8, 16, 24)])


@pytest.mark.parametrize("words", [3, 127, 300, 1024, 8192 + 5])
def test_word_tables_bit_equal_to_jax(words):
    import jax.numpy as jnp

    from voxelengine_tpu.ops import pallas_trace as JP

    w = np.random.default_rng(words).integers(0, 2**32, words, dtype=np.uint32)
    w[:2] = (0xFFFFFFFF, 0x80000001)
    t = _t(w.view(np.int32))
    rows = words_to_rows_i32(t)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(JP.words_to_rows_i32(jnp.asarray(w))))
    limbs = words_to_limb_rows(t)
    assert limbs.dtype == torch.uint8 and limbs.is_contiguous()
    np.testing.assert_array_equal(limbs.numpy(), np.asarray(JP.words_to_limb_rows(jnp.asarray(w))).astype(np.uint8))
    assert torch.equal(limbs, _limb_rows_by_shifts(t))


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_trace_grid_matches_jax(ref, name):
    """Plain ``trace_grid`` == JAX's ``trace_grid``, ``trace_grid_vpu`` and
    ``trace_grid_mxu``; the port's ``trace_grid_vpu``/``trace_grid_mxu`` on
    the CPU are the plain trace."""
    _, max_steps, initial = GRID_CASES[name]
    g = _grid(ref, name)
    o, d = (_t(a) for a in _grid_rays(_grid_dense()))
    got = trace_grid(g, o, d, max_steps, take_initial_step=initial)
    _assert_equal(got, ref, f"grid/{name}/trace_grid")
    if initial:
        return
    for fn, jname in ((trace_grid_vpu, "vpu"), (trace_grid_mxu, "mxu")):
        _assert_equal(got, ref, f"grid/{name}/{jname}")
        _assert_same(fn(g, o, d, max_steps), got)
    if name == "budget":
        assert (got.steps.numpy() == max_steps).sum() >= 16


@pytest.mark.parametrize("name", sorted(BM_CASES))
def test_trace_brickmap_mxu_matches_jax(ref, name):
    """Port ``trace_brickmap_mxu`` (the plain trace on the CPU) == JAX's,
    the degenerate start (ray 0: a solid voxel, steps 0) included."""
    bm = _bm(ref, name)
    o, d = (_t(a) for a in _bm_rays(_bm_dense()))
    got = trace_brickmap_mxu(bm, o, d, 256)
    _assert_equal(got, ref, f"bm/{name}/mxu")
    _assert_equal(got, ref, f"bm/{name}/trace")
    assert bool(got.hit[0]) and int(got.steps[0]) == 0
    np.testing.assert_allclose(got.position[0].numpy(), o[0].numpy(), atol=1e-5)


def test_trace_brickmap_mxu_refuses_compact_brickmaps():
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(_bm_dense())), 8, dense_slots=False)
    with pytest.raises(ValueError, match="dense-slot"):
        trace_brickmap_mxu(bm, torch.zeros(1, 3), torch.ones(1, 3))


@pytest.mark.parametrize("name", sorted(DENSE_FRAMES))
def test_render_frame_dense_bit_equal(ref, name):
    """The slice end to end: chained dense frames equal JAX's exactly, with
    the secondary-ray flags set too (both paths ignore them)."""
    W, H, cb, to, frames, sec = DENSE_FRAMES[name]
    g = bitgrid_from_numpy(dict(words=ref["frame/words"], dims=(32, 32, 32), layout=Layout.TILED_LINEAR.value),
                           device="cpu")
    cfg = RenderConfig(width=W, height=H, checkerboard=cb, tile_order=to, max_steps=256, **_secondary_flags(sec))
    fb = frame.make_framebuffer(cfg, device="cpu")
    for fn in frames:
        out = frame.render_frame_dense(g, fb, _t(ORIGIN), _t(EULER), Environment.default(device="cpu"), fn, cfg)
        assert out is fb
        np.testing.assert_array_equal(fb.numpy(), ref[f"frame/{name}/{fn}"])


# ---------------------------------------------------------------- host builds


@pytest.fixture(scope="module")
def host_lib():
    import shutil

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler for the host build of the kernels' step logic")
    from voxelengine_tpu_torch.kernels import build

    return build.load_dda_host()


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _host_grid(lib, g, o, d, max_steps, limbs):
    """K2's (``limbs=False``) or K3's step logic, built by g++, with the
    wrapper's ray setup and zero-step fix-up."""
    dd, start, start_normal, active = _ray_setup(g.dims, 1, o, d)
    pad = _edge_pad(start.to(torch.int32), _dims(g.dims, torch.int32, o.device), dd)
    active = active.to(torch.int32)  # held: the C call reads these buffers
    n = o.shape[0]
    hit, pos, nrm, steps = (torch.empty(n, dtype=torch.int32), torch.empty(n, 3), torch.empty(n, 3),
                            torch.empty(n, dtype=torch.int32))
    rays = _ptrs(start, dd, active, pad)
    outs = _ptrs(hit, pos, nrm, steps)
    tail = [n, *g.dims, g.layout.value, max_steps]
    if limbs:
        table = words_to_limb_rows(g.words)
        lib.vx_trace_grid_limbs_host(*rays, table.data_ptr(), table.shape[1] * 128, *tail, *outs)
    else:
        lib.vx_trace_grid_host(*rays, g.words.data_ptr(), *tail, *outs)
    hit = hit != 0
    zs = (hit & (steps == 0))[:, None]
    return hit, torch.where(zs, start, pos), torch.where(zs, start_normal, nrm), steps


@pytest.mark.parametrize("limbs", [False, True], ids=["words_K2", "limbs_K3"])
@pytest.mark.parametrize("name", ["linear", "tiled", "morton", "budget"])
def test_host_build_of_grid_step_matches_plain_trace(ref, host_lib, name, limbs):
    """``csrc/grid_dda.cuh`` built by g++ == plain ``trace_grid``, bit for bit
    (positions included), with either word fetch, on every layout."""
    _, max_steps, _ = GRID_CASES[name]
    g = _grid(ref, name)
    o, d = (_t(a) for a in _grid_rays(_grid_dense()))
    want = trace_grid(g, o, d, max_steps)
    hit, pos, nrm, steps = _host_grid(host_lib, g, o, d, max_steps, limbs)
    assert torch.equal(hit, want.hit) and torch.equal(steps, want.steps)
    assert torch.equal(pos[hit], want.position[hit]) and torch.equal(nrm[hit], want.normal[hit])


def _full_world(ref, world, layout):
    dense = _grid_dense() if world == "random" else ref["full/terrain/dense"]
    g = bitgrid_from_numpy(dict(words=ref[f"full/{world}/{layout}/words"], dims=(32, 32, 32),
                                layout=Layout[layout].value), device="cpu")
    return g, *(_t(a) for a in _full_rays(dense))


def _host_full(lib, g, o, v, max_steps, limbs):
    """K2's (``limbs=False``) or K3's whole function, built by g++, K3 in its
    global (``limbs=True``) or shared-memory (``limbs="staged"``)
    instantiation: origins (row stride 3, or 0 for one origin broadcast)
    and raw directions in, ``(hit bool, position, normal, steps)`` out."""
    n = v.shape[0]
    outs = (torch.empty(n, dtype=torch.bool), torch.empty(n, 3), torch.empty(n, 3), torch.empty(n, dtype=torch.int32))
    head = [o.data_ptr(), o.stride(0), v.data_ptr(), v.stride(0)]
    tail = [n, *g.dims, g.layout.value, max_steps]
    if limbs:
        table = words_to_limb_rows(g.words)
        staged = [int(limbs == "staged"), -(-g.words.numel() // 16), None]
        assert lib.vx_trace_grid_limbs_full_host(*head, table.data_ptr(), table.shape[1] * 128, *tail, *staged,
                                                 *_ptrs(*outs)) == 0
    else:
        assert lib.vx_trace_grid_full_host(*head, g.words.data_ptr(), *tail, *_ptrs(*outs)) == 0
    return outs


@pytest.mark.parametrize("words", [1, 17, 300, 1024 + 5])
def test_host_build_of_limb_staging(host_lib, words):
    """K3's staging (``grid_dda.cuh::limb_words16``), built by g++, rebuilds
    the words from ``words_to_limb_rows``' planes in groups of 16: the
    grid's words, then the planes' zero padding."""
    w = np.random.default_rng(words).integers(0, 2**32, words, dtype=np.uint32)
    w[0] = 0xFF00FF80
    limbs = words_to_limb_rows(_t(w.view(np.int32)))
    words16 = -(-words // 16)
    out = torch.full((16 * words16,), 7, dtype=torch.int32)
    assert host_lib.vx_limb_words_host(limbs.data_ptr(), limbs.shape[1] * 128, words16, out.data_ptr()) == 0
    np.testing.assert_array_equal(out[:words].numpy(), w.view(np.int32))
    assert not out[words:].any()


@pytest.mark.parametrize("limbs", [False, True, "staged"], ids=["words_K2", "limbs_K3", "staged_K3"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("world", FULL_WORLDS)
def test_host_build_of_fused_grid_kernel_matches_jax(ref, host_lib, world, layout, limbs):
    """K2's and K3's whole function (``ray_setup.cuh``, the walk, the
    zero-step fix-up), built by g++, == JAX's ``trace_grid_vpu`` on every
    ray, bit for bit: hit, steps, position and normal, from origins and raw
    directions; the special rays of ``_full_rays`` behave as described."""
    g, o, v = _full_world(ref, world, layout)
    hit, pos, nrm, steps = _host_full(host_lib, g, o, v, 256, limbs)
    prefix = f"full/{world}/{layout}"
    for k, got in (("hit", hit), ("steps", steps), ("position", pos), ("normal", nrm)):
        np.testing.assert_array_equal(got.numpy(), ref[f"{prefix}/{k}"], err_msg=k)
    assert bool(hit[0]) and int(steps[0]) == 0 and not nrm[0].any()
    assert not bool(hit[6]) and int(steps[6]) == 0
    entry = hit[8:24] & (steps[8:24] == 0)
    assert bool(entry.any()) and torch.equal(nrm[8:24][entry], torch.tensor([0.0, 1.0, 0.0]).expand(int(entry.sum()), 3))


def test_host_build_of_fused_grid_kernel_broadcast_origin(ref, host_lib):
    """One origin for every ray (row stride 0, as ``primary_rays`` makes
    them) gives what the same origin in every row gives, and the plain
    trace's results."""
    g, _, _ = _full_world(ref, "terrain", "TILED_LINEAR")
    o = torch.tensor([16.0, 40.0, -10.0])
    v = _t((np.random.default_rng(85).random((640, 3)) * 32).astype(np.float32)) - o
    want = trace_grid(g, o.expand(v.shape[0], 3), v, 256)
    for origins in (o.expand(v.shape[0], 3), o.repeat(v.shape[0], 1)):
        got = _host_full(host_lib, g, origins, v, 256, False)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want.hit.sum()) > 100


def test_ray_rows_strides():
    """The kernels' ray inputs: rows of 3 floats at stride 3, or one row
    broadcast at stride 0; other layouts are copied, wrong shapes refused."""
    from voxelengine_tpu_torch.kernels import build

    cpu = torch.device("cpu")
    t = torch.arange(12.0).reshape(4, 3)
    assert build.ray_rows("k", "o", t, 4, cpu) == (t, 3)
    b = torch.ones(3).expand(4, 3)
    assert build.ray_rows("k", "o", b, 4, cpu)[1] == 0
    tt, stride = build.ray_rows("k", "o", t.t().contiguous().t(), 4, cpu)
    assert stride == 3 and tt.is_contiguous() and torch.equal(tt, t)
    with pytest.raises(ValueError, match="float32"):
        build.ray_rows("k", "o", t.double(), 4, cpu)
    with pytest.raises(ValueError, match=r"\[5, 3\]"):
        build.ray_rows("k", "o", t, 5, cpu)


@pytest.mark.parametrize("name", sorted(BM_CASES))
def test_host_build_of_dense_slot_step_matches_plain_trace(ref, host_lib, name):
    """``csrc/dda.cuh`` with ``DenseSlotFetch`` (K4's step) built by g++ ==
    the plain ``trace_brickmap``, bit for bit, on each layout pair."""
    bm = _bm(ref, name)
    o, d = (_t(a) for a in _bm_rays(_bm_dense()))
    want = trace_brickmap(bm, o, d, 256)
    dd, start_c, start_normal, active = _ray_setup(bm.grid_dims, bm.factor, o, d)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, o.device), dd)
    active = active.to(torch.int32)  # held: the C call reads these buffers
    n = o.shape[0]
    outs = (torch.empty(n, dtype=torch.int32), torch.empty(n, 3), torch.empty(n, 3), torch.empty(n, dtype=torch.int32))
    host_lib.vx_trace_brickmap_dense_host(
        *_ptrs(start_c, dd, active, pad, bm.meta, bm.bricks), n, *bm.grid_dims, bm.factor,
        bm.words_per_brick, 256, bm.coarse_layout.value, bm.brick_layout.value, 3 * 256 + 64, *_ptrs(*outs),
    )
    got = kernel_result(*outs, start_c, start_normal, bm.factor)
    _assert_same(got, want)
    assert torch.equal(got.position[got.hit], want.position[want.hit])


# ------------------------------------------------------------ kernel wrappers


def test_kernel_wrappers_refuse_cpu_tensors_and_overflow():
    from voxelengine_tpu_torch.kernels import bmtrace, gridtrace

    z3 = torch.zeros(4, 3)
    kw = dict(dims=(32, 32, 32), layout=Layout.LINEAR, max_steps=16)
    with pytest.raises(ValueError, match="CUDA"):
        gridtrace.gridtrace(z3, z3, torch.zeros(1024, dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        gridtrace.gridtrace_limbs(z3, z3, torch.zeros(4, 8, 128, dtype=torch.uint8), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        bmtrace.bmtrace_rays(z3, z3, torch.zeros(64, dtype=torch.int32), torch.zeros(64, 16, dtype=torch.int32),
                             grid_dims=(4, 4, 4), factor=8, max_steps=16, coarse_layout=Layout.LINEAR,
                             brick_layout=Layout.TILED_LINEAR)
    # the grid's dims are checked first: 2^31 voxels overflow the int32 bit
    # index, 2^30 do not (the device check then refuses the CPU tensors)
    words = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 bit index"):
        gridtrace.gridtrace(z3, z3, words, dims=(2048, 1024, 1024), layout=Layout.LINEAR, max_steps=16)
    with pytest.raises(ValueError, match="CUDA"):
        gridtrace.gridtrace(z3, z3, words, dims=(1024, 1024, 1024), layout=Layout.LINEAR, max_steps=16)
    with pytest.raises(ValueError, match="divisible by 8"):
        gridtrace.gridtrace_limbs(z3, z3, words, dims=(12, 8, 8), layout=Layout.TILED_LINEAR, max_steps=16)


# ------------------------------------------------------------ card lane


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_grid_kernels_match_plain_trace_on_card(cuda_device, layout):
    """K2 and K3 on the card == the plain ``trace_grid`` on the card."""
    from voxelengine_tpu_torch.kernels import gridtrace

    dense = _grid_dense()
    g = BitGrid.from_dense(torch.from_numpy(dense).to(cuda_device), Layout[layout])
    o, d = (_t(a).to(cuda_device) for a in _grid_rays(dense))
    want = trace_grid(g, o, d, 256)
    before = (gridtrace.launches, gridtrace.limb_launches)
    a, b = trace_grid_vpu(g, o, d, 256), trace_grid_mxu(g, o, d, 256)
    torch.cuda.synchronize()
    assert (gridtrace.launches, gridtrace.limb_launches) == (before[0] + 1, before[1] + 1)
    _assert_same(a, want)
    _assert_same(b, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k3", ["staged", "global"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_grid_kernels_on_card(cuda_device, monkeypatch, layout, k3):
    """K2 and K3 from origins and raw directions on the card (the special
    rays of ``_full_rays``, and one origin broadcast to every ray) == the
    plain ``trace_grid`` on every ray, one launch each; K3 in its
    shared-memory instantiation and, with the wrapper's limit at 0, its
    global one."""
    from voxelengine_tpu_torch.kernels import gridtrace

    if k3 == "global":
        monkeypatch.setattr(gridtrace, "SMEM_WORDS_LIMIT", 0)
    dense = _grid_dense()
    g = BitGrid.from_dense(torch.from_numpy(dense).to(cuda_device), Layout[layout])
    o, v = (_t(a).to(cuda_device) for a in _full_rays(dense))
    for origins in (o, torch.tensor([16.0, 40.0, -10.0], device=cuda_device).expand_as(v)):
        want = trace_grid(g, origins, v, 256)
        before = (gridtrace.launches, gridtrace.limb_launches, gridtrace.staged_launches)
        a, b = trace_grid_vpu(g, origins, v, 256), trace_grid_mxu(g, origins, v, 256)
        torch.cuda.synchronize()
        staged = int(k3 == "staged")
        assert (gridtrace.launches, gridtrace.limb_launches, gridtrace.staged_launches) == (
            before[0] + 1, before[1] + 1, before[2] + staged)
        for got in (a, b):
            assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BM_CASES))
def test_bmtrace_kernel_matches_plain_trace_on_card(cuda_device, name):
    """K4 on the card == the plain ``trace_brickmap`` on the card."""
    from voxelengine_tpu_torch.kernels import bmtrace

    cl, bl = BM_CASES[name]
    dense = _bm_dense()
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense).to(cuda_device)), 8,
                        coarse_layout=Layout[cl], brick_layout=Layout[bl])
    o, d = (_t(a).to(cuda_device) for a in _bm_rays(dense))
    before = bmtrace.launches
    got = trace_brickmap_mxu(bm, o, d, 256)
    want = trace_brickmap(bm, o, d, 256)
    torch.cuda.synchronize()
    assert bmtrace.launches == before + 1
    _assert_same(got, want)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
