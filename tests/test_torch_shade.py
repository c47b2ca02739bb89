"""The port's frame path beyond the primary SHADED view, against the JAX
package: shadow, AO and reflection rays, the DEBUG, NORMALS, DEPTH and
STEPS views, block permutations, the odd-height checkerboard and a tensor
``ortho_size``, each as chained ``render_frame`` frames on the 64^3 world
at factor 8 of ``tests/test_torch_render.py``, bit for bit.

Both sides trace without a line table (JAX with ``staged_trace=False``, the
port through the plain ``trace_brickmap``), which keeps Pallas' interpret
mode out of this file; the JAX side runs once, in a subprocess whose XLA:CPU
neither contracts FMAs nor runs the algebraic simplifier
(``tests/test_torch_render.py`` module doc).  The port's route through a
line table with the macro levels off runs the same chunk walk on the CPU
and is held to the same frames; so is the compact form of the world
without a line table, against JAX's frames of that form.  The card lane
holds K1 on each secondary batch type, and a frame through K4, against the
plain versions.
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
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops import trace2
from voxelengine_tpu_torch.ops.bigtrace import make_line_table
from voxelengine_tpu_torch.ops.trace import TraceOut
from voxelengine_tpu_torch.render import frame

ROOT = Path(__file__).resolve().parent.parent
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
ORIGIN = np.array([32.0, 48.0, 32.0], np.float32)
EULER = np.array([-0.5, 0.8, 0.0], np.float32)
ORTHO = np.array([6.0, 4.5], np.float32)
MAX_STEPS = 128
BASE = dict(width=64, height=32, checkerboard=True, tile_order=True, max_steps=MAX_STEPS)
# name: (RenderConfig fields over BASE, frame numbers); enum fields by name
FRAMES = {
    "shadow_rays": (dict(shadow_rays=True), (1, 2)),
    "ao_samples": (dict(ao_samples=2), (1, 2)),
    "reflections": (dict(reflections=True), (1, 2)),
    "all_three": (dict(shadow_rays=True, ao_samples=2, reflections=True), (1, 2)),
    "DEBUG": (dict(debug_view="DEBUG", checkerboard=False, tile_order=False), (0,)),
    "NORMALS": (dict(debug_view="NORMALS"), (1, 2)),
    "DEPTH": (dict(debug_view="DEPTH"), (1, 2)),
    "STEPS": (dict(debug_view="STEPS", shadow_rays=True), (1, 2)),
    "block_perm": (dict(), (1, 2)),
    "odd_height": (dict(width=48, height=31), (1, 2)),
    "ortho": (dict(projection="ORTHOGRAPHIC"), (1, 2)),
}


def _world():
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


def _block_perm(cfg_kw):
    """A fixed permutation of the frame's pixel blocks."""
    bw, bh, nb = frame.block_geometry(RenderConfig(**cfg_kw))
    return np.random.default_rng(11).permutation(nb)


def _steps_for_perm():
    """Per-ray steps of a tile-order frame, with ties between blocks."""
    bw, bh, nb = frame.block_geometry(RenderConfig(**BASE))
    return np.random.default_rng(12).integers(0, 6, (nb * bw * bh,)).astype(np.int32)


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import jax
    import jax.numpy as jnp

    from voxelengine_tpu.config import DebugView as JView
    from voxelengine_tpu.config import Environment as JEnv
    from voxelengine_tpu.config import Projection as JProj
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.core.bitgrid import BitGrid
    from voxelengine_tpu.core.brickmap import build_brickmap, compact_brickmap
    from voxelengine_tpu.core.layout import Layout
    from voxelengine_tpu.render import frame as jframe

    out = {}
    bm = build_brickmap(BitGrid.from_dense(_world()), 8, coarse_layout=Layout.LINEAR)
    for k in BM_KEYS:
        v = getattr(bm, k)
        out[f"bm/{k}"] = np.asarray(getattr(v, "value", v))
    env = JEnv.default()
    # the same world in compact form, without a line table: JAX's XLA walk
    cbm = compact_brickmap(bm)
    cfg = JCfg(staged_trace=False, **_fields(FRAMES["all_three"][0], (JView, JProj)))
    fb = jframe.make_framebuffer(cfg)
    for fn in FRAMES["all_three"][1]:
        fb = jframe.render_frame(cbm, fb, jnp.asarray(ORIGIN), jnp.asarray(EULER), env, jnp.int32(fn), cfg)
        out[f"compact/all_three/{fn}"] = np.asarray(fb)
    for name, (change, frames) in FRAMES.items():
        kw = _fields(change, (JView, JProj))
        cfg = JCfg(staged_trace=False, **kw)
        extra = {}
        if name == "block_perm":
            extra["block_perm"] = jnp.asarray(_block_perm(kw))
        if name == "ortho":
            extra["ortho_size"] = jnp.asarray(ORTHO)
        fb = jframe.make_framebuffer(cfg)
        for fn in frames:
            fb = jframe.render_frame(bm, fb, jnp.asarray(ORIGIN), jnp.asarray(EULER), env, jnp.int32(fn), cfg,
                                     **extra)
            out[f"{name}/{fn}"] = np.asarray(fb)

    steps = _steps_for_perm()
    jcfg = JCfg(**BASE)
    perm = jframe.block_permutation_from_steps(jnp.asarray(steps), jcfg)
    out["perm/order"] = np.asarray(perm)
    out["perm/chained"] = np.asarray(jframe.block_permutation_from_steps(jnp.asarray(steps[::-1].copy()), jcfg, perm))
    x = np.random.default_rng(13).normal(scale=300.0, size=4096).astype(np.float32)
    x[:8] = [0.0, -0.0, 1.000001, -1.000001, 2.000002, -2.000002, 128.0, -128.0]
    out["mod/x"] = x
    m = np.float32(1.0) + np.float32(1e-6)
    out["mod/y"] = np.asarray(jax.jit(lambda a: jnp.mod(a / jnp.float32(128.0), m))(jnp.asarray(x)))
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
    path = tmp_path_factory.mktemp("jax_ref") / "shade_ref.npz"
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


def _bm(ref, device="cpu"):
    return brickmap_from_numpy({k: ref[f"bm/{k}"] for k in BM_KEYS}, device=device)


def _render(ref, name, lt=None, **cfg_change):
    """The port's chained frames of case ``name``; yields ``(frame number,
    framebuffer)``."""
    change, frames = FRAMES[name]
    kw = _fields(change, (DebugView, Projection))
    cfg = dataclasses.replace(RenderConfig(**kw), **cfg_change)
    extra = {}
    if name == "block_perm":
        extra["block_perm"] = _t(_block_perm(kw))
    if name == "ortho":
        extra["ortho_size"] = _t(ORTHO)
    bm = _bm(ref)
    env = Environment.default(device="cpu")
    fb = frame.make_framebuffer(cfg, device="cpu")
    for fn in frames:
        out = frame.render_frame(bm, fb, _t(ORIGIN), _t(EULER), env, fn, cfg, lt=lt, **extra)
        assert out is fb  # in place
        yield fn, fb


def _check(ref, name, **kw):
    for fn, fb in _render(ref, name, **kw):
        np.testing.assert_array_equal(fb.numpy(), ref[f"{name}/{fn}"], err_msg=f"{name} frame {fn}")


@pytest.mark.parametrize("change", ["NORMALS", "DEBUG", "shadow_rays", "ao_samples", "reflections"])
def test_render_option_bit_equal(ref, change):
    """Each option the port once refused renders JAX's frames exactly."""
    _check(ref, change)


def test_odd_height_checkerboard_bit_equal(ref):
    """48x31 checkerboard: the half row pair is written where its target
    row exists, as JAX's dropping scatter writes it."""
    _check(ref, "odd_height")


@pytest.mark.parametrize("name", ["all_three", "DEPTH", "STEPS", "block_perm", "ortho"])
def test_render_frame_bit_equal(ref, name):
    """All three secondary ray types at once, the DEPTH view, the STEPS view
    (shadow steps charged), a block permutation and a tensor
    ``ortho_size``."""
    _check(ref, name)


def test_block_permutation_changes_no_pixel(ref):
    plain = list(_render(ref, "block_perm"))[-1][1].clone()
    np.testing.assert_array_equal(plain.numpy(), ref["block_perm/2"])
    base = RenderConfig(**BASE)
    fb = frame.make_framebuffer(base, device="cpu")
    env = Environment.default(device="cpu")
    for fn in FRAMES["block_perm"][1]:
        frame.render_frame(_bm(ref), fb, _t(ORIGIN), _t(EULER), env, fn, base)
    assert torch.equal(fb, plain)


def test_block_permutation_from_steps_bit_equal(ref):
    """Stable on tied block costs, and mapped through a previous permutation."""
    cfg = RenderConfig(**BASE)
    steps = _t(_steps_for_perm())
    perm = frame.block_permutation_from_steps(steps, cfg)
    np.testing.assert_array_equal(perm.numpy(), ref["perm/order"])
    chained = frame.block_permutation_from_steps(steps.flip(0), cfg, perm)
    np.testing.assert_array_equal(chained.numpy(), ref["perm/chained"])


def test_debug_mod_bit_equal(ref):
    """``jnp.mod`` as XLA computes it (fmod, then the sign fix)."""
    got = frame._mod(frame.fdiv(_t(ref["mod/x"]), 128.0), float(np.float32(1.0) + np.float32(1e-6)))
    np.testing.assert_array_equal(got.numpy(), ref["mod/y"])


def test_secondary_route_through_line_table(ref):
    """With a line table and the macro levels off, every trace of the frame
    (primary, shadow, reflection, AO) runs ``trace_brickmap_hbm``'s plain
    version on the CPU, the chunk walk: the frames are JAX's."""
    bm = _bm(ref)
    _check(ref, "all_three", lt=make_line_table(bm), trace_use_macro=False)


def test_compact_world_without_line_table_refused_on_card_route(ref, monkeypatch):
    """A compact world whose brick words stay on the host
    (``load_world_host_bricks``) has nothing to trace without a line table:
    a card call is refused with a message naming ``make_line_table`` (CPU
    tensors routed as card tensors; nothing is built or launched)."""
    from voxelengine_tpu_torch.core.brickmap import compact_brickmap

    monkeypatch.setattr(trace2, "_is_cuda", lambda t: True)
    bm = dataclasses.replace(compact_brickmap(_bm(ref)), bricks=None)
    cfg = RenderConfig(**BASE)
    with pytest.raises(ValueError, match="make_line_table"):
        frame.render_frame(bm, frame.make_framebuffer(cfg, device="cpu"), _t(ORIGIN), _t(EULER),
                           Environment.default(device="cpu"), 1, cfg)
    o = torch.zeros(4, 3)
    out = TraceOut(torch.ones(4, dtype=torch.bool), o + 1.0, o, torch.zeros(4, dtype=torch.int32))
    px = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="make_line_table"):
        trace2.trace_secondary_no_table(bm, "shadow", out, o + 1.0, px, px, Environment.default(device="cpu"), 1,
                                        cfg)


def test_compact_world_without_line_table_routes_to_k4_compact(ref, monkeypatch):
    """A compact world without a line table goes to K4's compact entries on
    a card call, every trace of the frame (the rays and secondary entries
    are replaced by spies that run their g++ builds,
    ``vx_trace_brickmap_compact_rays_host`` and ``_secondary_host``), and
    the frames are JAX's on the same compact world, bit for bit."""
    from voxelengine_tpu_torch.core.brickmap import compact_brickmap
    from voxelengine_tpu_torch.kernels import bmtrace, build

    host = build.load_dda_host()
    bm = compact_brickmap(_bm(ref))
    seen = []

    def spy(origins, rays, meta, brick_idx, bricks, *, grid_dims, factor, max_steps, coarse_layout,
            brick_layout):
        seen.append(max_steps)
        n = origins.shape[0]
        (o, os), (d, ds) = (build.ray_rows("spy", "", t, n, t.device) for t in (origins, rays))
        outs = (torch.empty(n, dtype=torch.bool), torch.empty(n, 3), torch.empty(n, 3),
                torch.empty(n, dtype=torch.int32))
        host.vx_trace_brickmap_compact_rays_host(
            o.data_ptr(), os, d.data_ptr(), ds, *(t.data_ptr() for t in (meta, brick_idx, bricks)), n, *grid_dims,
            factor, bricks.shape[1], max_steps, coarse_layout.value, brick_layout.value, 3 * max_steps + 64,
            *(t.data_ptr() for t in outs))
        return outs

    def dense(*a, **k):
        raise AssertionError("a compact world reached the dense-slot entry")

    monkeypatch.setattr(trace2, "_is_cuda", lambda t: True)
    monkeypatch.setattr(bmtrace, "bmtrace_compact_rays", spy)
    monkeypatch.setattr(bmtrace, "bmtrace_compact_secondary",
                        _secondary_spy(monkeypatch, host.vx_trace_brickmap_compact_secondary_host, seen))
    monkeypatch.setattr(bmtrace, "bmtrace_rays", dense)
    monkeypatch.setattr(bmtrace, "bmtrace_secondary", dense)
    change, frames = FRAMES["all_three"]
    cfg = RenderConfig(**_fields(change, (DebugView, Projection)))
    fb = frame.make_framebuffer(cfg, device="cpu")
    env = Environment.default(device="cpu")
    for fn in frames:
        frame.render_frame(bm, fb, _t(ORIGIN), _t(EULER), env, fn, cfg)
        np.testing.assert_array_equal(fb.numpy(), ref[f"compact/all_three/{fn}"], err_msg=f"compact frame {fn}")
    # a frame: the primary trace, then one secondary launch a kind (shadow,
    # reflection, AO's 2 samples at 8 steps)
    assert seen == [MAX_STEPS, MAX_STEPS, MAX_STEPS, 8] * 2


def _secondary_spy(monkeypatch, host_entry, seen):
    """A stand-in for K4's secondary wrappers that runs the entry's g++
    build (``host_entry``) on CPU tensors, recording each launch's step
    budget."""
    from voxelengine_tpu_torch.kernels import build

    monkeypatch.setattr(build, "require_cuda", lambda kernel, dev: None)

    def spy(kind, position, normal, *tables, grid_dims, factor, max_steps, coarse_layout, brick_layout, **inputs):
        seen.append(max_steps)
        _, n, head, outs, res = build.secondary_args("spy", kind, position, normal, **inputs)
        assert host_entry(*build.pointers(head), *(t.data_ptr() for t in tables), n, *grid_dims, factor,
                          tables[-1].shape[1], max_steps, coarse_layout.value, brick_layout.value,
                          3 * max_steps + 64, *build.pointers(outs)) == 0
        return res

    return spy


def test_dense_slot_world_without_line_table_routes_to_k4(ref, monkeypatch):
    """A dense-slot world without a line table goes to K4's entries on a
    card call (the rays entry is replaced by a spy that runs the plain
    trace, the secondary entry by one that runs its g++ build)."""
    seen = []

    def spy(bm, o, d, max_steps):
        seen.append(max_steps)
        return trace2.trace_brickmap(bm, o, d, max_steps)

    from voxelengine_tpu_torch.kernels import bmtrace, build

    monkeypatch.setattr(trace2, "_is_cuda", lambda t: True)
    monkeypatch.setattr(trace2, "_trace_brickmap_kernel", spy)
    monkeypatch.setattr(bmtrace, "bmtrace_secondary",
                        _secondary_spy(monkeypatch, build.load_dda_host().vx_trace_brickmap_dense_secondary_host,
                                       seen))
    for fn, fb in _render(ref, "all_three"):
        np.testing.assert_array_equal(fb.numpy(), ref[f"all_three/{fn}"])
    # a frame: the primary trace, then one secondary launch a kind
    assert seen == [MAX_STEPS, MAX_STEPS, MAX_STEPS, 8] * 2


# ---------------------------------------------------------------------------
# card lane
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


def _card_world(dev):
    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.brickmap import build_brickmap
    from voxelengine_tpu_torch.core.layout import Layout

    return build_brickmap(BitGrid.from_dense(torch.from_numpy(_world()).to(dev)), 8, coarse_layout=Layout.LINEAR)


@pytest.mark.cuda
@pytest.mark.parametrize("use_macro", [False, True])
def test_k1_secondary_batches_match_plain_on_card(cuda_device, use_macro):
    """Each secondary batch a frame traces (shadow, reflection, AO at 8
    steps, from surface starts and from the miss pixels' positions) through
    K1 against its plain version on the same rays, bit for bit; and the
    frame through K1 against the frame through plain traces."""
    from voxelengine_tpu_torch.kernels import bigtrace
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm, trace_brickmap_lt
    from voxelengine_tpu_torch.ops.trace import trace_brickmap

    bm = _card_world(cuda_device)
    lt = make_line_table(bm)
    cfg = RenderConfig(**dict(BASE, shadow_rays=True, ao_samples=2, reflections=True, trace_use_macro=use_macro))
    env = Environment.default(cuda_device)
    origin, euler = _t(ORIGIN).to(cuda_device), _t(EULER).to(cuda_device)
    batches = []

    def kernel(o, d, max_steps):
        batches.append((o.clone(), d.clone(), max_steps))
        return trace_brickmap_hbm(bm, lt, o, d, max_steps, use_macro=use_macro)

    def plain(o, d, max_steps):
        if use_macro:
            return trace_brickmap_lt(bm, lt, o, d, max_steps)
        return trace_brickmap(bm, o, d, max_steps)

    o, d, px, py, py_r = frame.primary_rays(cfg, origin, euler, 1)
    primary = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=use_macro)
    before = bigtrace.launches
    got = frame.shade_traced(bm, primary, o, d, px, py, py_r, origin, env, 1, cfg, secondary=kernel)
    assert bigtrace.launches - before == 4
    want = frame.shade_traced_plain(bm, primary, o, d, px, py, py_r, origin, env, 1, cfg, secondary=plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert [ms for _, _, ms in batches] == [MAX_STEPS, MAX_STEPS, 8, 8]
    for bo, bd, ms in batches:
        k = trace_brickmap_hbm(bm, lt, bo, bd, ms, use_macro=use_macro)
        for a, b in zip(k, plain(bo, bd, ms)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_graphics_frame_over_tiled_world_launches_k4_on_card(cuda_device):
    """A TILED_LINEAR dense-slot world has no line table: its frame goes
    through K4, never the plain walk, and equals the plain frame."""
    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.engine.raytracer import VoxelRaytracer3D
    from voxelengine_tpu_torch.kernels import bmtrace
    from voxelengine_tpu_torch.render.graphics import Graphics

    rt = VoxelRaytracer3D()
    rt.upload_voxel_buffer(BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device)), 8)
    assert rt.line_table is None
    g = Graphics(64, 32, device=cuda_device, shadow_rays=True, max_steps=MAX_STEPS)
    before = bmtrace.launches
    fb = g.render_screen(rt, ORIGIN, EULER).clone()
    assert bmtrace.launches - before == 2  # the primary and the shadow trace
    assert torch.equal(fb, render_plain(rt.world, g.config, 0, cuda_device))


def render_plain(bm, cfg, fn, dev):
    """The frame of ``render_frame`` with every trace the plain walk, on ``dev``."""
    from voxelengine_tpu_torch.ops.trace import trace_brickmap

    origin, euler = _t(ORIGIN).to(dev), _t(EULER).to(dev)
    o, d, px, py, py_r = frame.primary_rays(cfg, origin, euler, fn)
    out = trace_brickmap(bm, o, d, cfg.max_steps)
    color, write = frame.shade_traced_plain(bm, out, o, d, px, py, py_r, origin, Environment.default(dev), fn, cfg,
                                            secondary=lambda a, b, ms: trace_brickmap(bm, a, b, ms))
    return frame.composite_frame(frame.make_framebuffer(cfg, dev), color, write, cfg, fn)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
