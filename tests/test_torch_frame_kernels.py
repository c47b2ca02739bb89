"""The frame's fused kernels: K1's and K4's rays entries (the ray setup, the
walk and the ``hit_imm`` fix-up in one launch, ``csrc/bigtrace.cu``,
``csrc/bmtrace.cu`` over ``csrc/ray_setup.cuh``) and the shading kernel
(``shade_traced`` after its traces, and ``composite_frame``,
``csrc/shade.cu`` over ``csrc/shade.cuh``).

Their host twins (``dda_host.cpp``, ``shade_host.cpp``, built by g++) run
behind the card's routes: ``render/frame.py``, ``ops/bigtrace.py`` and
``ops/trace2.py`` are told that CPU rays are on the card, and the wrappers
launch the host entries in place of the kernels' launchers, so the
routes, the wrappers' arguments and the per-ray code are all held to the
plain versions, bit for bit: K1's rays entry (macro levels on and off, the
diag counters) and K4's (dense slots and compact) on rays that start
inside the world, enter through each face, miss, start on a maximal face
(the edge pad), hit at their start (``hit_imm``), have zero direction
components, or share one origin or one direction (row stride 0); the
shading for every view, both frame parities, an odd height, no
checkerboard with the crosshair, a block permutation, and the shadow,
reflection and AO inputs; the composite entry against ``composite_frame``
over a framebuffer of stale values.  Whole frames through the twins are
held against JAX's ``render_frame`` and ``render_frame_dense`` at 64x48,
computed once in a subprocess whose XLA:CPU neither contracts FMAs nor
runs the algebraic simplifier (``tests/test_torch_render.py`` module doc).
On the card: the kernels against their plain versions, and a frame's
launches.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.config import DebugView, Environment, Projection, RenderConfig
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap, compact_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import bigtrace, bmtrace, build
from voxelengine_tpu_torch.kernels import rays as rays_kernel
from voxelengine_tpu_torch.kernels import shade as shade_kernel
from voxelengine_tpu_torch.ops import bigtrace as ops_bigtrace
from voxelengine_tpu_torch.ops import trace2
from voxelengine_tpu_torch.ops.trace import TraceOut, trace_brickmap
from voxelengine_tpu_torch.render import frame

ROOT = Path(__file__).resolve().parent.parent
ORIGIN = np.array([32.0, 48.0, 32.0], np.float32)
EULER = np.array([-0.5, 0.8, 0.0], np.float32)
MAX_STEPS = 128
BASE = dict(width=64, height=48, checkerboard=True, tile_order=True, max_steps=MAX_STEPS)
# JAX's frames: name -> (RenderConfig fields over BASE, frame numbers); enum fields by name
JAX_FRAMES = {
    "primary": (dict(), (1, 2)),
    "shadow": (dict(shadow_rays=True), (1,)),
    "ao": (dict(ao_samples=2), (1,)),
    "all_three": (dict(shadow_rays=True, ao_samples=2, reflections=True), (1,)),
    "DEBUG_cb": (dict(debug_view="DEBUG", shadow_rays=True), (1, 2)),
    "STEPS": (dict(debug_view="STEPS", shadow_rays=True), (2,)),
    "odd_height": (dict(height=47), (1, 2)),
}
# the shading cases against the plain version: name -> (fields over BASE, frame numbers)
SHADE_CASES = {
    "primary": (dict(), (1, 2)),
    "shadow": (dict(shadow_rays=True), (1,)),
    "reflections": (dict(reflections=True), (2,)),
    "ao": (dict(ao_samples=2), (1,)),
    "all_three": (dict(shadow_rays=True, ao_samples=2, reflections=True), (1, 2)),
    "DEBUG": (dict(debug_view="DEBUG", checkerboard=False, tile_order=False), (0,)),
    "DEBUG_cb": (dict(debug_view="DEBUG", shadow_rays=True), (1, 2)),
    "NORMALS": (dict(debug_view="NORMALS"), (1, 2)),
    "DEPTH": (dict(debug_view="DEPTH"), (1,)),
    "STEPS": (dict(debug_view="STEPS", shadow_rays=True), (2,)),
    "crosshair_no_cb": (dict(checkerboard=False), (0,)),
    "odd_height": (dict(width=48, height=31), (1, 2)),
    "block_perm": (dict(), (1, 2)),
    "ortho": (dict(projection="ORTHOGRAPHIC", ortho_size=(6.0, 4.5)), (1,)),
}


def _world():
    """``tests/test_torch_shade.py``'s 64^3 world: a sparse field over a floor."""
    rng = np.random.default_rng(0xC0FFEE)
    dense = rng.random((64, 64, 64)) < 0.01
    dense[:, 0:4, :] = rng.random((64, 4, 64)) < 0.5
    return dense


def _fields(change, enums):
    kw = dict(BASE, **change)
    if "debug_view" in kw:
        kw["debug_view"] = enums[0][kw["debug_view"]]
    if "projection" in kw:
        kw["projection"] = enums[1][kw["projection"]]
    return kw


def _jax_reference():
    """JAX side (runs in the subprocess, module doc): ``render_frame`` of
    each of :data:`JAX_FRAMES` (no line table: XLA's chunk walk) and
    ``render_frame_dense`` (K2 in interpret mode), chained frames."""
    import jax.numpy as jnp

    from voxelengine_tpu.config import DebugView as JView
    from voxelengine_tpu.config import Environment as JEnv
    from voxelengine_tpu.config import Projection as JProj
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.brickmap import build_brickmap as jbuild
    from voxelengine_tpu.core.layout import Layout as JLayout
    from voxelengine_tpu.render import frame as jframe

    out = {}
    grid = JGrid.from_dense(_world())
    bm = jbuild(grid, 8, coarse_layout=JLayout.LINEAR)
    env = JEnv.default()
    o, e = jnp.asarray(ORIGIN), jnp.asarray(EULER)
    for name, (change, frames) in JAX_FRAMES.items():
        cfg = JCfg(staged_trace=False, **_fields(change, (JView, JProj)))
        fb = jframe.make_framebuffer(cfg)
        for fn in frames:
            fb = jframe.render_frame(bm, fb, o, e, env, jnp.int32(fn), cfg)
            out[f"{name}/{fn}"] = np.asarray(fb)
    cfg = JCfg(**BASE)
    fb = jframe.make_framebuffer(cfg)
    for fn in (1, 2):
        fb = jframe.render_frame_dense(grid, fb, o, e, env, jnp.int32(fn), cfg, interpret=True)
        out[f"dense/{fn}"] = np.asarray(fb)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "frame_kernels_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """``(grid, dense-slot brickmap at factor 8, its line table)`` on the CPU."""
    grid = BitGrid.from_dense(torch.from_numpy(_world()))
    bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
    return grid, bm, ops_bigtrace.make_line_table(bm)


class _HostKernels:
    """The launchers the frame's routes reach, as their host entries (the
    same arguments, less the stream, which the fixture's ``launch`` drops;
    K1's also less its work counter and grid, K4's less its instantiation
    flag and work counter)."""

    def __init__(self):
        dda, cam, sh = build.load_dda_host(), build.load_host("camera_host"), build.load_host("shade_host")
        self.vx_rays_frame, self.vx_rays_pixels = cam.vx_rays_frame_host, cam.vx_rays_pixels_host
        rays, sec = dda.vx_bigtrace_rays_host, dda.vx_bigtrace_secondary_host
        self.vx_bigtrace_rays = lambda *a: rays(*a[:-2])
        self.vx_bigtrace_secondary = lambda *a: sec(*a[:-2])
        dense, compact = dda.vx_trace_brickmap_dense_rays_host, dda.vx_trace_brickmap_compact_rays_host
        self.vx_trace_brickmap_dense_rays = lambda *a: dense(*a[:16], *a[18:])
        self.vx_trace_brickmap_compact_rays = lambda *a: compact(*a[:17], *a[19:])
        sd, sc = dda.vx_trace_brickmap_dense_secondary_host, dda.vx_trace_brickmap_compact_secondary_host
        self.vx_trace_brickmap_dense_secondary = lambda *a: sd(*a[:23], *a[25:])
        self.vx_trace_brickmap_compact_secondary = lambda *a: sc(*a[:24], *a[26:])
        self.vx_shade, self.vx_shade_composite = sh.vx_shade_host, sh.vx_shade_composite_host
        self.vx_rrtrace_rays = dda.vx_rrtrace_rays_host


@pytest.fixture
def host_route(monkeypatch):
    """CPU rays take the card's routes, through the host twins: returns the
    list of the launches made, by kernel name."""
    seen = []
    kernels = _HostKernels()

    def launch(kernel, fn, *args, dev):
        seen.append(kernel)
        assert fn(*args) == 0

    for mod in (frame, ops_bigtrace, trace2):
        monkeypatch.setattr(mod, "_is_cuda", lambda t: True)
    monkeypatch.setattr(build, "require_cuda", lambda kernel, dev: None)
    monkeypatch.setattr(build, "load_kernel", lambda name: kernels)
    monkeypatch.setattr(build, "launch", launch)
    return seen


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype, g.shape, w.shape)
        assert torch.equal(_words(g.contiguous()), _words(w.contiguous())), (what, k)


def _ray_cases(world_dense):
    """name -> (origins, directions) f32 arrays in voxels (module doc)."""
    rng = np.random.default_rng(71)
    X = world_dense.shape[0]
    f32 = np.float32

    def dirs(n):
        return rng.normal(size=(n, 3)).astype(f32)

    cases = {"inside": ((rng.random((192, 3)) * X).astype(f32), dirs(192))}
    for axis in range(3):
        for side, at in (("lo", -7.5), ("hi", X + 7.5)):
            n = 48
            o = (rng.random((n, 3)) * X).astype(f32)
            o[:, axis] = at
            target = (rng.random((n, 3)) * X).astype(f32)
            cases[f"enter_{'xyz'[axis]}_{side}"] = (o, target - o)
            cases[f"miss_{'xyz'[axis]}_{side}"] = (o, o - target)
    # on a maximal face (x, y or z exactly the world's edge), heading back in or along it
    o = (rng.random((96, 3)) * X).astype(f32)
    o[np.arange(96), np.arange(96) % 3] = X
    d = dirs(96)
    d[np.arange(96), np.arange(96) % 3] = -np.abs(d[np.arange(96), np.arange(96) % 3])
    cases["max_face"] = (o, d)
    # starting inside a solid voxel: hit at the start
    solid = np.argwhere(world_dense)[rng.choice(int(world_dense.sum()), 64, replace=False)]
    cases["hit_imm"] = ((solid + rng.random((64, 3)) * 0.98 + 0.01).astype(f32), dirs(64))
    # zero direction components, one or two of them
    d = dirs(96)
    d[np.arange(0, 96, 2), rng.integers(0, 3, 48)] = 0.0
    d[np.arange(1, 96, 2), :2] = 0.0
    cases["zero_components"] = ((rng.random((96, 3)) * X).astype(f32), d)
    return cases


def _rays(case, o, d):
    """The case's tensors; ``stride0_*`` cases share one origin or one
    direction at row stride 0; ``strided`` rays are column-major views,
    which the wrappers copy."""
    ot, dt = _t(o), _t(d)
    if case == "stride0_origin":
        ot = ot[:1].expand(dt.shape[0], 3)
    if case == "stride0_dir":
        dt = dt[:1].expand(ot.shape[0], 3)
    if case == "strided":
        ot, dt = (t.t().contiguous().t() for t in (ot, dt))
    return ot, dt


def _all_rays():
    cases = _ray_cases(_world())
    cases["stride0_origin"] = (np.tile(ORIGIN, (128, 1)), np.random.default_rng(3).normal(size=(128, 3)).astype(np.float32))
    cases["stride0_dir"] = cases["inside"]
    cases["strided"] = cases["enter_x_lo"]
    return cases


RAY_CASES = _all_rays()


@pytest.mark.parametrize("use_macro", [False, True])
def test_k1_rays_entry_twin_equals_plain(world, host_route, use_macro):
    """K1's rays entry through ``trace_brickmap_hbm``'s card route, one
    launch a call, against the plain line-table walk (the diag counters
    too: the twin's iteration count is the ray's own)."""
    _, bm, lt = world
    for case, (o, d) in RAY_CASES.items():
        ot, dt = _rays(case, o, d)
        before = bigtrace.launches
        got, phases = ops_bigtrace.trace_brickmap_hbm(bm, lt, ot, dt, MAX_STEPS, use_macro, return_phases=True)
        assert bigtrace.launches == before + 1
        want, dg = ops_bigtrace.trace_brickmap_lt(bm, lt, ot, dt, MAX_STEPS, use_macro, diag=True)
        _equal(got, want, (case, use_macro))
        got_dg = torch.stack([phases[k] for k in ops_bigtrace.PHASES] + [phases["iters"]])
        assert torch.equal(got_dg, dg), case
        if case == "hit_imm":
            assert bool(((got.hit) & (got.steps == 0)).any())
    assert set(host_route) == {"bigtrace_rays"}


@pytest.mark.parametrize("form", ["dense", "compact"])
def test_k4_rays_entry_twin_equals_plain(world, host_route, form):
    """K4's rays entry (dense slots; compact, slots from ``brick_idx``)
    through ``trace_brickmap_no_table``'s card route against the plain
    walk."""
    _, bm, _ = world
    if form == "compact":
        bm = compact_brickmap(bm)
    launched = bmtrace.launches + bmtrace.compact_launches
    for case, (o, d) in RAY_CASES.items():
        ot, dt = _rays(case, o, d)
        _equal(trace2.trace_brickmap_no_table(bm, ot, dt, MAX_STEPS), trace_brickmap(bm, ot, dt, MAX_STEPS), case)
    assert bmtrace.launches + bmtrace.compact_launches == launched + len(RAY_CASES)
    assert set(host_route) == {"bmtrace"}


def _case_cfg(name):
    change, frames = SHADE_CASES[name]
    return RenderConfig(**_fields(change, (DebugView, Projection))), frames


def _block_perm(cfg):
    bw, bh, nb = frame.block_geometry(cfg)
    return _t(np.random.default_rng(11).permutation(nb))


@pytest.mark.parametrize("name", sorted(SHADE_CASES))
def test_shade_twin_equals_plain(world, host_route, name):
    """The shading kernel's two entries against ``shade_traced_plain`` and
    ``composite_frame``, on the frame's rays traced through K1's twin with
    the macro levels off: color and write word for word, and the
    framebuffer over stale values (every pixel the frame leaves alone is
    kept)."""
    _, bm, lt = world
    cfg, frames = _case_cfg(name)
    cfg = dataclasses.replace(cfg, trace_use_macro=False)
    env = Environment.default(device="cpu")
    origin = _t(ORIGIN)
    perm = _block_perm(cfg) if name == "block_perm" else None
    stale = torch.from_numpy(np.random.default_rng(5).random((cfg.height, cfg.width, 3)).astype(np.float32))
    for fn in frames:
        o, d, px, py, py_r = frame.primary_rays(cfg, origin, _t(EULER), fn, perm)
        out = frame.trace_primary(bm, o, d, cfg, lt)
        args = (bm, out, o, d, px, py, py_r, origin, env, fn, cfg, lt)
        before = shade_kernel.launches
        got = frame.shade_traced(*args)
        want = frame.shade_traced_plain(*args)
        _equal(got, want, (name, fn))
        fb_got = frame.shade_and_composite(stale.clone(), *args, block_perm=perm)
        fb_want = frame.composite_frame(stale.clone(), *want, cfg, fn, perm)
        assert shade_kernel.launches == before + 2
        _equal((fb_got,), (fb_want,), (name, fn, "composite"))
        assert not torch.equal(fb_got, stale)


def test_shade_twin_on_sharded_pixels(world, host_route):
    """The ``shade`` entry on a 4-rank layout's band and cyclic pixels (the
    halo rows included) through ``shade_pixels``, as the sharded frames
    call it."""
    from voxelengine_tpu_torch.parallel import sharded
    from voxelengine_tpu_torch.parallel.mesh import Mesh

    _, bm, lt = world
    cfg = RenderConfig(**dict(BASE, width=128, height=96, trace_use_macro=False))  # 8 pixel blocks
    env, origin = Environment.default(device="cpu"), _t(ORIGIN)
    for pixels in (sharded.band_pixels, sharded.cyclic_pixels):
        for rank in (0, 3):
            px, py_r = pixels(cfg, Mesh(None, rank, 4, "rows", torch.device("cpu")), "cpu")
            o, d, py = sharded._rays_for_pixels(cfg, origin, _t(EULER), 2, px, py_r, cfg.ortho_size)
            out = frame.trace_primary(bm, o, d, cfg, lt)
            args = (bm, out, o, d, px, py, py_r, origin, env, 2, cfg, lt)
            _equal(frame.shade_traced(*args), frame.shade_traced_plain(*args), (pixels.__name__, rank))


def test_primary_frame_is_three_launches(world, host_route):
    """A primary frame with a line table launches the ray kernel, K1's rays
    entry and the shading kernel's composite entry, once each, and nothing
    of the plain bodies runs; without a line table K4's rays entry takes
    K1's place; the dense frame has no launch for its shading but the
    composite entry."""
    def plain(*a, **k):
        raise AssertionError("the card route ran a plain body")

    grid, bm, lt = world
    cfg = RenderConfig(**BASE)
    env = Environment.default(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((frame, "primary_rays_plain"), (frame, "shade_traced_plain"), (frame, "composite_frame"),
                          (ops_bigtrace, "trace_brickmap_lt"), (ops_bigtrace, "trace_brickmap"),
                          (trace2, "trace_brickmap")):
            mp.setattr(mod, name, plain)
        fb = frame.make_framebuffer(cfg, device="cpu")
        frame.render_frame(bm, fb, _t(ORIGIN), _t(EULER), env, 1, cfg, lt=lt)
        assert host_route == ["rays_frame", "bigtrace_rays", "shade_composite"]
        host_route.clear()
        frame.render_frame(compact_brickmap(bm), fb, _t(ORIGIN), _t(EULER), env, 2, cfg)
        assert host_route == ["rays_frame", "bmtrace", "shade_composite"]
        host_route.clear()
        frame.render_frame_dense(grid, fb, _t(ORIGIN), _t(EULER), env, 1, cfg)
        assert host_route == ["rays_frame", "shade_composite"]  # K2 on the CPU: its route is ops/gridtrace.py's


def test_shaded_frame_is_six_launches(world, host_route):
    """A frame with shadows, AO and reflections launches the ray kernel,
    K1's rays entry, K1's secondary entry once a kind (shadow, reflection,
    AO) and the shading kernel's composite entry, and nothing of the plain
    bodies runs (the secondary rays' eager version included); without a
    line table K4's rays and secondary entries (compact world) take K1's
    place."""
    def plain(*a, **k):
        raise AssertionError("the card route ran a plain body")

    _, bm, lt = world
    cfg, _ = _case_cfg("all_three")
    env = Environment.default(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((frame, "primary_rays_plain"), (frame, "shade_traced_plain"), (frame, "composite_frame"),
                          (frame, "secondary_traced"), (ops_bigtrace, "secondary_plain"), (trace2, "secondary_plain"),
                          (ops_bigtrace, "trace_brickmap_lt"), (ops_bigtrace, "trace_brickmap"),
                          (trace2, "trace_brickmap")):
            mp.setattr(mod, name, plain)
        fb = frame.make_framebuffer(cfg, device="cpu")
        launched = dict(bigtrace.secondary_launches)
        frame.render_frame(bm, fb, _t(ORIGIN), _t(EULER), env, 1, cfg, lt=lt)
        assert host_route == ["rays_frame", "bigtrace_rays"] + ["bigtrace_secondary"] * 3 + ["shade_composite"]
        assert all(bigtrace.secondary_launches[k] == launched[k] + 1 for k in launched)
        host_route.clear()
        launched = dict(bmtrace.compact_secondary_launches)
        frame.render_frame(compact_brickmap(bm), fb, _t(ORIGIN), _t(EULER), env, 2, cfg)
        assert host_route == ["rays_frame"] + ["bmtrace"] * 4 + ["shade_composite"]
        assert all(bmtrace.compact_secondary_launches[k] == launched[k] + 1 for k in launched)


def test_card_route_reaches_each_wrapper(world, host_route, monkeypatch):
    """A card call of each entry point reaches its wrapper: spies on the
    wrappers see the frame's calls, the primary trace and one secondary
    launch a kind (K1's, or K4's for a world without a line table), and the
    shading once."""
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(name) or real(*a, **k))

    for mod, name in ((bigtrace, "bigtrace_rays"), (bigtrace, "bigtrace_secondary"), (bmtrace, "bmtrace_rays"),
                      (bmtrace, "bmtrace_compact_rays"), (bmtrace, "bmtrace_secondary"),
                      (bmtrace, "bmtrace_compact_secondary"), (shade_kernel, "shade"),
                      (shade_kernel, "shade_composite"), (rays_kernel, "frame_rays")):
        spy(mod, name)
    _, bm, lt = world
    cfg, _ = _case_cfg("all_three")
    env = Environment.default(device="cpu")
    fb = frame.make_framebuffer(cfg, device="cpu")
    frame.render_frame(bm, fb, _t(ORIGIN), _t(EULER), env, 1, cfg, lt=lt)
    assert calls == ["frame_rays", "bigtrace_rays"] + ["bigtrace_secondary"] * 3 + ["shade_composite"]
    calls.clear()
    frame.render_frame(bm, fb, _t(ORIGIN), _t(EULER), env, 2, dataclasses.replace(cfg, shadow_rays=False,
                                                                                     reflections=False, ao_samples=0))
    frame.render_frame(bm, fb, _t(ORIGIN), _t(EULER), env, 1, dataclasses.replace(cfg, reflections=False))
    frame.render_frame(compact_brickmap(bm), fb, _t(ORIGIN), _t(EULER), env, 2, dataclasses.replace(cfg, ao_samples=0))
    assert calls == ["frame_rays", "bmtrace_rays", "shade_composite",
                     "frame_rays", "bmtrace_rays", "bmtrace_secondary", "bmtrace_secondary", "shade_composite",
                     "frame_rays", "bmtrace_compact_rays", "bmtrace_compact_secondary", "bmtrace_compact_secondary",
                     "shade_composite"]


@pytest.mark.parametrize("name", sorted(JAX_FRAMES))
def test_frames_through_twins_equal_jax(ref, world, host_route, name):
    """Chained ``render_frame`` frames through the host twins (rays, K1's
    rays and secondary entries with the macro levels off, the composite
    entry), and through K4's rays and secondary entries without a line
    table, equal JAX's frames: the shadow, AO, all-three, DEBUG and STEPS
    frames' secondary rays go through the secondary entries."""
    _, bm, lt = world
    change, frames = JAX_FRAMES[name]
    cfg = dataclasses.replace(RenderConfig(**_fields(change, (DebugView, Projection))), trace_use_macro=False)
    env = Environment.default(device="cpu")
    for table in (lt, None):
        fb = frame.make_framebuffer(cfg, device="cpu")
        for fn in frames:
            frame.render_frame(bm, fb, _t(ORIGIN), _t(EULER), env, fn, cfg, lt=table)
            np.testing.assert_array_equal(fb.numpy(), ref[f"{name}/{fn}"], err_msg=f"{name} {fn} lt={table is not None}")


def test_dense_frames_through_twins_equal_jax(ref, world, host_route):
    grid, _, _ = world
    cfg = RenderConfig(**BASE)
    env = Environment.default(device="cpu")
    fb = frame.make_framebuffer(cfg, device="cpu")
    for fn in (1, 2):
        frame.render_frame_dense(grid, fb, _t(ORIGIN), _t(EULER), env, fn, cfg)
        np.testing.assert_array_equal(fb.numpy(), ref[f"dense/{fn}"], err_msg=f"dense {fn}")


# launcher -> (its host twin, where the launcher's own arguments go into
# the twin's list (None: last), those arguments): K1's work counter and
# grid; K4's instantiation flag and work counter, before the outputs
_K1_OWN = (None, [build._P, build._P])
_K4_OWN = [build._I, build._P]
LAUNCHER_TWINS = {
    "vx_bigtrace_rays": ("vx_bigtrace_rays_host", *_K1_OWN),
    "vx_bigtrace_record": ("vx_bigtrace_record_host", *_K1_OWN),
    "vx_bigtrace_secondary": ("vx_bigtrace_secondary_host", *_K1_OWN),
    "vx_trace_brickmap_dense_rays": ("vx_trace_brickmap_dense_rays_host", -4, _K4_OWN),
    "vx_trace_brickmap_compact_rays": ("vx_trace_brickmap_compact_rays_host", -4, _K4_OWN),
    "vx_trace_brickmap_dense_record": ("vx_trace_brickmap_dense_record_host", -6, _K4_OWN),
    "vx_trace_brickmap_compact_record": ("vx_trace_brickmap_compact_record_host", -6, _K4_OWN),
    "vx_trace_brickmap_dense_secondary": ("vx_trace_brickmap_dense_secondary_host", -5, _K4_OWN),
    "vx_trace_brickmap_compact_secondary": ("vx_trace_brickmap_compact_secondary_host", -5, _K4_OWN),
    "vx_rrtrace_rays": ("vx_rrtrace_rays_host", None, []),
    "vx_zslab_rays": ("vx_zslab_rays_host", None, []),
    "vx_trace_crossings": ("vx_trace_crossings_host", None, []),
    "vx_trace_grid": ("vx_trace_grid_full_host", None, []),
    "vx_trace_grid_limbs": ("vx_trace_grid_limbs_full_host", None, []),
    "vx_secondary_build": ("vx_secondary_build_host", None, []),
    "vx_secondary_reduce": ("vx_secondary_reduce_host", None, []),
    "vx_terrain_slab": ("vx_terrain_slab_host", None, []),
    "vx_noise_points": ("vx_noise_points_host", None, []),
    "vx_camera_basis": ("vx_camera_basis_host", None, []),
    "vx_rays_frame": ("vx_rays_frame_host", None, []),
    "vx_rays_pixels": ("vx_rays_pixels_host", None, []),
    "vx_shade": ("vx_shade_host", None, []),
    "vx_shade_composite": ("vx_shade_composite_host", None, []),
}


@pytest.mark.parametrize("launcher", sorted(build.SIGNATURES))
def test_launcher_signatures_are_the_host_entries(launcher):
    """Each launcher takes its host twin's arguments plus its own stated
    ones (and the stream, added at load): every launcher has a twin, and
    both are defined in the sources the libraries build."""
    host, at, own = LAUNCHER_TWINS[launcher]
    twin = build.HOST_ENTRIES[host]
    at = len(twin) if at is None else at
    assert build.SIGNATURES[launcher] == twin[:at] + own + twin[at:]
    for sources, fn in ((build.KERNEL_SOURCES, launcher), (build.HOST_SOURCES, host)):
        assert any(f'extern "C" int {fn}(' in (build.CSRC / src).read_text() for src in sources.values()), fn


def test_wrappers_refuse_cpu_tensors(world):
    _, bm, lt = world
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        bigtrace.bigtrace_rays(z, z, lt.region_lines, ops_bigtrace.brick_lines_view(bm), grid_dims=bm.grid_dims,
                               region_dims=lt.region_dims, factor=8, wpb=16, max_steps=8, brick_layout=bm.brick_layout)
    with pytest.raises(ValueError, match="CUDA"):
        bmtrace.bmtrace_rays(z, z, bm.meta, bm.bricks, grid_dims=bm.grid_dims, factor=8, max_steps=8,
                             coarse_layout=bm.coarse_layout, brick_layout=bm.brick_layout)
    out = TraceOut(torch.zeros(4, dtype=torch.bool), z, z, torch.zeros(4, dtype=torch.int32))
    px = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        shade_kernel.shade(out, z, z, px, px, px, torch.zeros(3), Environment.default(device="cpu"),
                           RenderConfig(**BASE))


VIEWS = ["SHADED", "DEBUG", "NORMALS", "DEPTH", "STEPS"]


def _special_inputs(view, dev):
    """A frame's shading inputs with signed zeros and NaNs in the trace's
    positions and normals, the rays' directions and the light, for the
    clamps' edge cases (``shade.cuh::clamp_t``, ``clamp_min_t``): ``(args
    of shade_traced, cfg)``.  Drawn from a numpy seed."""
    cfg = RenderConfig(**dict(BASE, debug_view=DebugView[view]))
    origin = _t(ORIGIN).to(dev)
    o, d, px, py, py_r = frame.primary_rays(cfg, origin, _t(EULER).to(dev), 1)
    n = o.shape[0]
    rng = np.random.default_rng(23)
    pool = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -2.5, np.nan, 1e30, -1e-30, 40.0], np.float32)

    def special(shape):
        return torch.from_numpy(pool[rng.integers(len(pool), size=shape)]).to(dev)

    d = torch.where(torch.from_numpy(rng.random((n, 1)) < 0.3).to(dev), special((n, 3)), d)
    out = TraceOut(torch.from_numpy(rng.random(n) < 0.7).to(dev), special((n, 3)), special((n, 3)),
                   torch.from_numpy(rng.integers(0, 300, n).astype(np.int32)).to(dev))
    env = Environment(light_direction=_t(np.array([-0.0, 0.6, 0.8], np.float32)).to(dev),
                      light_color=_t(np.array([2.0, 0.0, 1.0], np.float32)).to(dev),
                      ambient_color=_t(np.array([0.5, -0.0, 0.25], np.float32)).to(dev))
    return (None, out, o, d, px, py, py_r, origin, env, 1, cfg, None), cfg


def _equal_nan(got, want, what):
    """:func:`_equal`, with any NaN equal to any NaN (the payload is the
    instruction's, not the function's); zeros compared by sign."""
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.contiguous().cpu(), w.contiguous().cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        if g.dtype.is_floating_point:
            nan = torch.isnan(g)
            assert torch.equal(nan, torch.isnan(w)), (what, k)
            g, w = torch.where(nan, 0.0, g), torch.where(nan, 0.0, w)
        assert torch.equal(_words(g), _words(w)), (what, k)


@pytest.mark.parametrize("view", VIEWS)
def test_shade_twin_signed_zeros_and_nans(host_route, view):
    """The host twin on :func:`_special_inputs` against the plain version:
    the g++ build's clamps keep torch's CPU results, signed zeros and NaN
    included (the card's build, whose clamps are ``fmaxf`` and ``fminf``
    as torch's CUDA kernels, has the same test on the card)."""
    args, cfg = _special_inputs(view, "cpu")
    want = frame.shade_traced_plain(*args)
    assert bool(torch.isnan(want[0]).any()) and bool((want[0] == 0).any())
    _equal_nan(frame.shade_traced(*args), want, view)
    stale = torch.zeros((cfg.height, cfg.width, 3))
    _equal_nan((frame.shade_and_composite(stale.clone(), *args),),
               (frame.composite_frame(stale.clone(), *want, cfg, 1),), (view, "composite"))


# the secondary entries' routes: name -> (line table?, macro levels, world form)
SECONDARY_ROUTES = {"k1": (True, False, "dense"), "k1_macro": (True, True, "dense"),
                    "k4_dense": (False, False, "dense"), "k4_compact": (False, False, "compact")}
SECONDARY_CFG = dict(shadow_rays=True, ao_samples=3, reflections=True)


def _secondary_case(world, route, inputs, dev):
    """``(run(kind) -> the route's results, plain(kind) -> the plain
    version's)`` for :data:`SECONDARY_ROUTES`' ``route`` on ``inputs``: the
    frame's rays and their plain primary trace (``"frame"``), or
    :func:`_special_inputs`' trace with signed zeros and NaN (``"special"``).
    The plain version is ``secondary_plain`` over the route's plain walk."""
    from voxelengine_tpu_torch.ops.secondary import secondary_plain

    _, bm, lt = world
    table, use_macro, form = SECONDARY_ROUTES[route]
    bm = compact_brickmap(bm) if form == "compact" else bm
    cfg = RenderConfig(**dict(BASE, trace_use_macro=use_macro, **SECONDARY_CFG))
    if inputs == "special":
        (_, out, _, d, px, py, _, _, env, fn, _, _), _ = _special_inputs("SHADED", dev)
    else:
        env, fn = Environment.default(device=dev), 3
        _, d, px, py, _ = frame.primary_rays_plain(cfg, _t(ORIGIN).to(dev), _t(EULER).to(dev), fn)
        o = _t(ORIGIN).to(dev).expand_as(d)
        out = trace_brickmap(bm, o, d, MAX_STEPS)

    def walk(o_, d_, ms):
        if table:
            return ops_bigtrace.trace_brickmap_lt(bm, lt, o_, d_, ms, use_macro)
        return trace_brickmap(bm, o_, d_, ms)

    def run(kind):
        if table:
            return ops_bigtrace.trace_secondary_hbm(bm, lt, kind, out, d, px, py, env, fn, cfg)
        return trace2.trace_secondary_no_table(bm, kind, out, d, px, py, env, fn, cfg)

    return run, lambda kind: secondary_plain(kind, walk, out, d, px, py, env, fn, cfg)


def _tuple(r):
    return r if isinstance(r, tuple) else (r,)


@pytest.mark.parametrize("inputs", ["frame", "special"])
@pytest.mark.parametrize("route", sorted(SECONDARY_ROUTES))
@pytest.mark.parametrize("kind", ["shadow", "reflection", "ao"])
def test_secondary_twin_equals_plain(world, host_route, kind, route, inputs):
    """K1's (macro levels on and off) and K4's (dense slots and compact)
    secondary entries through their card routes, one launch a kind, against
    the plain version over the same walk, bit for bit: on the frame's rays,
    and on a trace of signed zeros, NaN and far positions (missed
    primaries' sentinels), where NaN equals NaN whatever its payload."""
    run, plain = _secondary_case(world, route, inputs, "cpu")
    got, want = _tuple(run(kind)), _tuple(plain(kind))
    assert host_route[-1:] == ["bigtrace_secondary" if route.startswith("k1") else "bmtrace"]
    assert "bigtrace_rays" not in host_route and host_route.count(host_route[-1]) == 1
    (_equal_nan if inputs == "special" else _equal)(got, want, (kind, route, inputs))
    if kind != "ao":
        assert bool(want[0].any()) and not bool(want[0].all())
    elif inputs == "frame":
        assert bool((want[0] < 1.0).any()) and bool((want[0] == 1.0).any())


@pytest.mark.parametrize("use_macro", [False, True])
def test_k5_rays_entry_twin_equals_plain(world, host_route, use_macro):
    """K5's rays entry (``vx_rrtrace_rays``: the refill sets each ray up,
    the store does the ``hit_imm`` fix-up) through
    ``trace_brickmap_hbm_rr``'s card route at refill 1, 8 and 32, one
    launch a call, against the plain line-table walk, bit for bit."""
    from voxelengine_tpu_torch.kernels import rrtrace

    _, bm, lt = world
    before = rrtrace.rays_launches
    calls = 0
    for case, (o, d) in RAY_CASES.items():
        ot, dt = _rays(case, o, d)
        want = ops_bigtrace.trace_brickmap_lt(bm, lt, ot, dt, MAX_STEPS, use_macro)
        for refill in (1, 8, 32):
            got = ops_bigtrace.trace_brickmap_hbm_rr(bm, lt, ot, dt, MAX_STEPS, use_macro, refill=refill)
            calls += 1
            _equal(got, want, (case, use_macro, refill))
        if case == "hit_imm":
            assert bool((want.hit & (want.steps == 0)).any())
    assert rrtrace.rays_launches == before + calls
    assert set(host_route) == {"rrtrace_rays"}


# the composite's destination form: (layout, checkerboard)
DEST_CASES = [("rows", True), ("rows", False), ("cyclic", True), ("cyclic", False)]


@pytest.mark.parametrize("layout,cb", DEST_CASES)
def test_composite_dest_twin_equals_pair_select(world, host_route, monkeypatch, layout, cb):
    """``render_frame_sharded`` and ``render_frame_cyclic`` on each rank of
    a 4-rank layout through the card's route (the primary and secondary
    traces, then one launch of the shading kernel's destination form, host
    twins) against their CPU route (the same shading, then
    ``checkerboard_pair_select`` or the plain copy), over a framebuffer of
    stale values: even and odd frames, rank 0's halo row included, word
    for word."""
    from voxelengine_tpu_torch.parallel import sharded
    from voxelengine_tpu_torch.parallel.mesh import Mesh

    _, bm, lt = world
    cfg = RenderConfig(**dict(BASE, width=128, height=96, checkerboard=cb, trace_use_macro=False, shadow_rays=True,
                              ao_samples=2, reflections=True))
    env, origin = Environment.default(device="cpu"), _t(ORIGIN)
    render = sharded.render_frame_sharded if layout == "rows" else sharded.render_frame_cyclic
    make = sharded.make_framebuffer_rows if layout == "rows" else sharded.make_framebuffer_cyclic
    rng = np.random.default_rng(7)
    for rank in range(4):
        mesh = Mesh(None, rank, 4, "rows", torch.device("cpu"))
        stale = torch.from_numpy(rng.random(tuple(make(cfg, mesh).shape)).astype(np.float32))
        for fn in (1, 2):
            for mod in (sharded, frame):
                monkeypatch.setattr(mod, "_is_cuda", lambda t: False)
            want = render(bm, stale.clone(), origin, _t(EULER), env, fn, cfg, mesh, lt)
            for mod in (sharded, frame):
                monkeypatch.setattr(mod, "_is_cuda", lambda t: True)
            host_route.clear()
            before = shade_kernel.launches
            got = render(bm, stale.clone(), origin, _t(EULER), env, fn, cfg, mesh, lt)
            assert host_route[0] == "rays_pixels" and host_route[-1] == "shade_composite"
            assert host_route.count("shade_composite") == 1 and "shade" not in host_route
            assert shade_kernel.launches == before + 1
            _equal((got,), (want,), (layout, cb, rank, fn))
            assert not torch.equal(got, stale)


def test_composite_dest_drops_rank_0_halo(world, host_route, monkeypatch):
    """On an even frame a band's first row holds only its halo row's rays
    (row -1's even columns, y = 2 (row0 - 1) + 1 + 1): rank 1's halo writes
    them, rank 0's halo ray of row -1 writes nothing, so rank 0's first
    row keeps its stale values."""
    from voxelengine_tpu_torch.parallel import sharded
    from voxelengine_tpu_torch.parallel.mesh import Mesh

    _, bm, lt = world
    cfg = RenderConfig(**dict(BASE, width=128, height=96, trace_use_macro=False))
    monkeypatch.setattr(sharded, "_is_cuda", lambda t: True)
    first = []
    for rank in (0, 1):
        mesh = Mesh(None, rank, 4, "rows", torch.device("cpu"))
        stale = torch.full(tuple(sharded.make_framebuffer_rows(cfg, mesh).shape), 0.25)
        got = sharded.render_frame_sharded(bm, stale, _t(ORIGIN), _t(EULER), Environment.default(device="cpu"), 2,
                                           cfg, mesh, lt)
        first.append(got[0])
    assert bool((first[0] == 0.25).all())
    assert not bool((first[1][0::2] == 0.25).all(dim=-1).any()) and bool((first[1][1::2] == 0.25).all())


# ---------------------------------------------------------------------------
# card lane
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_macro", [False, True])
def test_k1_rays_entry_equals_plain_on_card(cuda_device, use_macro):
    grid = BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device))
    bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
    lt = ops_bigtrace.make_line_table(bm)
    for case, (o, d) in RAY_CASES.items():
        ot, dt = (t.to(cuda_device) for t in _rays(case, o, d))
        got, phases = ops_bigtrace.trace_brickmap_hbm(bm, lt, ot, dt, MAX_STEPS, use_macro, return_phases=True)
        want, dg = ops_bigtrace.trace_brickmap_lt(bm, lt, ot, dt, MAX_STEPS, use_macro, diag=True)
        _equal(got, want, (case, use_macro))
        assert all(torch.equal(phases[k], dg[i]) for i, k in enumerate(ops_bigtrace.PHASES)), case


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "compact"])
def test_k4_rays_entry_equals_plain_on_card(cuda_device, form):
    grid = BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device))
    bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
    if form == "compact":
        bm = compact_brickmap(bm)
    for case, (o, d) in RAY_CASES.items():
        ot, dt = (t.to(cuda_device) for t in _rays(case, o, d))
        _equal(trace2.trace_brickmap_no_table(bm, ot, dt, MAX_STEPS), trace_brickmap(bm, ot, dt, MAX_STEPS), case)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHADE_CASES))
def test_shade_kernel_equals_plain_on_card(cuda_device, name):
    """Both entries against the plain versions, word for word, and a frame's
    launches: one ray kernel, one K1, one shading launch."""
    grid = BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device))
    bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
    lt = ops_bigtrace.make_line_table(bm)
    cfg, frames = _case_cfg(name)
    env = Environment.default(cuda_device)
    origin = _t(ORIGIN).to(cuda_device)
    perm = _block_perm(cfg).to(cuda_device) if name == "block_perm" else None
    stale = torch.rand((cfg.height, cfg.width, 3), generator=torch.Generator().manual_seed(5)).to(cuda_device)
    for fn in frames:
        o, d, px, py, py_r = frame.primary_rays(cfg, origin, _t(EULER).to(cuda_device), fn, perm)
        out = frame.trace_primary(bm, o, d, cfg, lt)
        args = (bm, out, o, d, px, py, py_r, origin, env, fn, cfg, lt)
        want = frame.shade_traced_plain(*args)
        _equal([t.cpu() for t in frame.shade_traced(*args)], [t.cpu() for t in want], (name, fn))
        got_fb = frame.shade_and_composite(stale.clone(), *args, block_perm=perm)
        _equal((got_fb.cpu(),), (frame.composite_frame(stale.clone(), *want, cfg, fn, perm).cpu(),), (name, fn))
    if not (cfg.shadow_rays or cfg.reflections or cfg.ao_samples):
        counts = (rays_kernel.launches, bigtrace.launches, shade_kernel.launches)
        frame.render_frame(bm, frame.make_framebuffer(cfg, cuda_device), origin, _t(EULER).to(cuda_device), env, 1,
                           cfg, lt=lt, block_perm=perm)
        assert (rays_kernel.launches, bigtrace.launches, shade_kernel.launches) == tuple(c + 1 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("view", VIEWS)
def test_shade_kernel_signed_zeros_and_nans_on_card(cuda_device, view):
    """The kernel's clamps (``fmaxf``, ``fminf`` under ``__CUDA_ARCH__``)
    against torch's CUDA clamps on :func:`_special_inputs`: both entries
    against the plain version, signed zeros and NaN included."""
    args, cfg = _special_inputs(view, cuda_device)
    want = frame.shade_traced_plain(*args)
    _equal_nan(frame.shade_traced(*args), want, view)
    stale = torch.zeros((cfg.height, cfg.width, 3), device=cuda_device)
    _equal_nan((frame.shade_and_composite(stale.clone(), *args),),
               (frame.composite_frame(stale.clone(), *want, cfg, 1),), (view, "composite"))


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["frame", "special"])
@pytest.mark.parametrize("route", sorted(SECONDARY_ROUTES))
def test_secondary_entries_equal_plain_on_card(cuda_device, route, inputs):
    """Each secondary entry on the card against its plain version on the
    same inputs (the cases of :func:`test_secondary_twin_equals_plain`)."""
    grid = BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device))
    bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
    run, plain = _secondary_case((grid, bm, ops_bigtrace.make_line_table(bm)), route, inputs, cuda_device)
    for kind in ("shadow", "reflection", "ao"):
        got, want = _tuple(run(kind)), _tuple(plain(kind))
        (_equal_nan if inputs == "special" else _equal)([t.cpu() for t in got], [t.cpu() for t in want],
                                                         (kind, route, inputs))


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(SECONDARY_ROUTES))
def test_shaded_frames_equal_plain_on_card(cuda_device, route):
    """Shaded frames (shadows, AO 3, reflections; both parities) through the
    kernels against the plain path (every trace the plain walk, the plain
    secondary rays, shading and composite): 0 word diffs; six launches a
    frame (ray kernel, K1 or K4, three secondary entries, shading)."""
    grid = BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device))
    bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
    lt = ops_bigtrace.make_line_table(bm)
    table, use_macro, form = SECONDARY_ROUTES[route]
    bm = compact_brickmap(bm) if form == "compact" else bm
    cfg = RenderConfig(**dict(BASE, trace_use_macro=use_macro, **SECONDARY_CFG))
    env = Environment.default(cuda_device)
    origin, euler = _t(ORIGIN).to(cuda_device), _t(EULER).to(cuda_device)

    def walk(o, d, ms):
        return ops_bigtrace.trace_brickmap_lt(bm, lt, o, d, ms, use_macro) if table else trace_brickmap(bm, o, d, ms)

    got_fb, want_fb = frame.make_framebuffer(cfg, cuda_device), frame.make_framebuffer(cfg, cuda_device)
    for fn in (1, 2):
        counts = (rays_kernel.launches, bigtrace.launches + bmtrace.launches + bmtrace.compact_launches,
                  shade_kernel.launches)
        frame.render_frame(bm, got_fb, origin, euler, env, fn, cfg, lt=lt if table else None)
        assert (rays_kernel.launches, bigtrace.launches + bmtrace.launches + bmtrace.compact_launches,
                shade_kernel.launches) == (counts[0] + 1, counts[1] + 4, counts[2] + 1)
        o, d, px, py, py_r = frame.primary_rays(cfg, origin, euler, fn)
        out = walk(o, d, cfg.max_steps)
        color, write = frame.shade_traced_plain(bm, out, o, d, px, py, py_r, origin, env, fn, cfg, secondary=walk)
        frame.composite_frame(want_fb, color, write, cfg, fn)
        _equal((got_fb.cpu(),), (want_fb.cpu(),), (route, fn))


@pytest.mark.cuda
@pytest.mark.parametrize("use_macro", [False, True])
def test_k5_rays_entry_equals_plain_on_card(cuda_device, use_macro):
    """K5's rays entry (``trace_brickmap_hbm_rr`` on the card, one launch a
    call) against the plain line-table walk on every ray case, and against
    its prepared entry after the eager setup and fix-up."""
    from voxelengine_tpu_torch.kernels import rrtrace

    grid = BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device))
    bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
    lt = ops_bigtrace.make_line_table(bm)
    for case, (o, d) in RAY_CASES.items():
        ot, dt = (t.to(cuda_device) for t in _rays(case, o, d))
        before = rrtrace.rays_launches
        got = ops_bigtrace.trace_brickmap_hbm_rr(bm, lt, ot, dt, MAX_STEPS, use_macro)
        assert rrtrace.rays_launches == before + 1
        _equal([t.cpu() for t in got], [t.cpu() for t in ops_bigtrace.trace_brickmap_lt(bm, lt, ot, dt, MAX_STEPS,
                                                                                          use_macro)], case)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,cb", DEST_CASES)
def test_composite_dest_on_card_equals_pair_select(cuda_device, monkeypatch, layout, cb):
    """The destination form on the card (4 ranks' bands or blocks, both
    parities, shadows, AO and reflections) against the same frames'
    CPU-route composite (``checkerboard_pair_select``) on the card's own
    shading, word for word."""
    from voxelengine_tpu_torch.parallel import sharded
    from voxelengine_tpu_torch.parallel.mesh import Mesh

    grid = BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device))
    bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
    lt = ops_bigtrace.make_line_table(bm)
    cfg = RenderConfig(**dict(BASE, width=128, height=96, checkerboard=cb, shadow_rays=True, ao_samples=2,
                              reflections=True))
    env, origin, euler = Environment.default(cuda_device), _t(ORIGIN).to(cuda_device), _t(EULER).to(cuda_device)
    render = sharded.render_frame_sharded if layout == "rows" else sharded.render_frame_cyclic
    make = sharded.make_framebuffer_rows if layout == "rows" else sharded.make_framebuffer_cyclic
    for rank in range(4):
        mesh = Mesh(None, rank, 4, "rows", cuda_device)
        stale = torch.rand(tuple(make(cfg, mesh).shape), generator=torch.Generator().manual_seed(rank)).to(cuda_device)
        for fn in (1, 2):
            before = shade_kernel.launches
            got = render(bm, stale.clone(), origin, euler, env, fn, cfg, mesh, lt)
            assert shade_kernel.launches == before + 1
            for mod in (sharded, frame):
                monkeypatch.setattr(mod, "_is_cuda", lambda t: False)
            want = render(bm, stale.clone(), origin, euler, env, fn, cfg, mesh, lt)
            monkeypatch.undo()
            _equal((got.cpu(),), (want.cpu(),), (layout, cb, rank, fn))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
