"""The port's pixel-sharded frames and ray batches (``voxelengine_tpu_torch/
parallel/sharded.py``) on 4 gloo ranks against the JAX package on a
4-device CPU mesh, with the JAX package's test shapes
(``tests/test_parallel.py``: the 32^3 world of ``tests/conftest.py``, 64x32
frames, 200 rays): row-band frames at both checkerboard parities with and
without a line table, with shadow and AO rays; block-cyclic frames, with
and without checkerboarding and with a line table; ``raytrace_sharded``'s
outputs and its mean, with and without a line table, bit for bit; and each
against the port's own single-device ``render_frame`` and traces.  Also the
mesh's collectives (``parallel/mesh.py``), ``run_ranks``' failure path and
``entry()`` (``voxelengine_tpu_torch/entry.py``).

The JAX side runs once, in a subprocess with 4 virtual CPU devices whose
XLA:CPU neither contracts FMAs nor runs the algebraic simplifier
(``tests/test_torch_render.py`` module doc), Pallas in interpret mode; the
port's side runs once, in 4 ranks of ``parallel/cases.py::run_cases``,
while the JAX side runs.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.config import Environment
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops.bigtrace import make_line_table, trace_brickmap_hbm
from voxelengine_tpu_torch.ops.trace import trace_brickmap
from voxelengine_tpu_torch.parallel import cases
from voxelengine_tpu_torch.parallel import mesh as M
from voxelengine_tpu_torch.parallel.cases import render_config, run_cases
from voxelengine_tpu_torch.render.frame import make_framebuffer, render_frame

ROOT = Path(__file__).resolve().parent.parent
N = 4
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
FIELDS = ("hit", "position", "normal", "steps")
# tests/test_parallel.py's origin; its camera (0.9, 0.3, 0) is rendered as
# the rows frame's own case, against JAX's mesh and the single device; the
# other frames use the render tests' camera
EULER_JAX = [0.9, 0.3, 0.0]
ORIGIN, EULER = [16.0, 20.0, 16.0], [-0.5, 0.8, 0.0]
# tests/test_parallel.py's frames: (kind, world, RenderConfig fields, line table, frame numbers)
FRAMES = {
    "rows": ("frame_rows", "tiled", dict(width=64, height=32, checkerboard=True), False, (0, 1)),
    "rows_lt": ("frame_rows", "linear", dict(width=64, height=32, checkerboard=True, tile_order=True), True, (0, 1)),
    "rows_secondary": ("frame_rows", "tiled", dict(width=32, height=16, checkerboard=False, shadow_rays=True,
                                                   ao_samples=2), False, (0,)),
    "cyclic": ("frame_cyclic", "tiled", dict(width=256, height=128, checkerboard=True), False, (0, 1)),
    "cyclic_plain": ("frame_cyclic", "tiled", dict(width=256, height=64, checkerboard=False), False, (0,)),
    "cyclic_lt": ("frame_cyclic", "linear", dict(width=128, height=64, checkerboard=True), True, (0, 1)),
}
RAYTRACE = {"raytrace": ("tiled", False, 2048), "raytrace_lt": ("linear", True, 512)}


def _inputs():
    """``tests/conftest.py``'s world and ray batch, from their seeds."""
    r = np.random.default_rng(1234)
    dense = r.random((32, 32, 32)) < 0.02
    dense[:, 0:4, :] = r.random((32, 4, 32)) < 0.5
    r = np.random.default_rng(5678)
    origins = (r.random((200, 3)) * 64 - 16).astype(np.float32)
    targets = (r.random((200, 3)) * 32).astype(np.float32)
    rays = targets - origins
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    return dense, origins, rays.astype(np.float32)


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from voxelengine_tpu.config import Environment as JEnv
    from voxelengine_tpu.config import RenderConfig
    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.brickmap import build_brickmap as jbuild
    from voxelengine_tpu.core.layout import Layout as JLayout
    from voxelengine_tpu.ops.pallas_bigtrace import make_line_table as jlt
    from voxelengine_tpu.parallel import sharded as js
    from voxelengine_tpu.render.frame import make_framebuffer as jfb

    mesh = js.make_mesh(jax.devices()[:N])
    dense, origins, rays = _inputs()
    grid = JGrid.from_dense(dense)
    out = {}
    bms = {"tiled": jbuild(grid, 8), "linear": jbuild(grid, 8, coarse_layout=JLayout.LINEAR)}
    lts = {}
    for w, bm in bms.items():
        for k in BM_KEYS:
            v = getattr(bm, k)
            out[f"{w}/bm/{k}"] = np.asarray(getattr(v, "value", v))
        lts[w] = jax.device_put(jlt(bm), NamedSharding(mesh, P()))
        bms[w] = js.replicate_world(mesh, bm)
    env = JEnv.default()
    origin, euler = jnp.asarray(ORIGIN), jnp.asarray(EULER)
    for name, (kind, w, fields, use_lt, frames) in FRAMES.items():
        extra = dict(trace_tile=128, trace_slots=4) if use_lt else {}
        cfg = RenderConfig(**fields, **extra)
        if kind == "frame_rows":
            fb = jax.device_put(jfb(cfg), NamedSharding(mesh, P("rows")))
        else:
            fb = js.make_framebuffer_cyclic(cfg, mesh)
        render = js.render_frame_sharded if kind == "frame_rows" else js.render_frame_cyclic
        for fn in frames:
            fb = render(bms[w], fb, origin, euler, env, jnp.int32(fn), cfg, mesh, lts[w] if use_lt else None)
            img = np.asarray(fb) if kind == "frame_rows" else js.cyclic_to_image(fb, cfg)
            out[f"{name}/{fn}"] = img
    cfg = RenderConfig(**FRAMES["rows"][2])
    fb = jax.device_put(jfb(cfg), NamedSharding(mesh, P("rows")))
    for fn in (0, 1):
        fb = js.render_frame_sharded(bms["tiled"], fb, origin, jnp.asarray(EULER_JAX), env, jnp.int32(fn), cfg, mesh)
        out[f"rows_jax_camera/{fn}"] = np.asarray(fb)
    for name, (w, use_lt, max_steps) in RAYTRACE.items():
        kw = dict(lt=lts[w], tile=256, num_slots=4) if use_lt else {}
        res, mean = js.raytrace_sharded(bms[w], jnp.asarray(origins), jnp.asarray(rays), mesh, max_steps, **kw)
        for f in FIELDS:
            out[f"{name}/{f}"] = np.asarray(getattr(res, f))
        out[f"{name}/mean"] = np.asarray(mean)
    return out


def _cases(worlds):
    _, origins, rays = _inputs()
    cases = [(name, kind, dict(world=w, cfg=fields, origin=ORIGIN, euler=EULER, frames=frames, lt=use_lt))
             for name, (kind, w, fields, use_lt, frames) in FRAMES.items()]
    cases += [(name, "raytrace", dict(world=w, origins=origins, rays=rays, max_steps=max_steps, lt=use_lt))
              for name, (w, use_lt, max_steps) in RAYTRACE.items()]
    # JAX's own camera, against the port's single-device frames only
    cases.append(("rows_jax_camera", "frame_rows", dict(world="tiled", cfg=FRAMES["rows"][2], origin=ORIGIN,
                                                         euler=EULER_JAX, frames=(0, 1), lt=False)))
    return cases + [("collectives", "collectives", {})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_worlds():
    dense, _, _ = _inputs()
    grid = BitGrid.from_dense(torch.from_numpy(dense))
    return {"tiled": build_brickmap(grid, 8), "linear": build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)}


def _np_world(bm):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(getattr(v, "value", v))
            for k, v in ((k, getattr(bm, k)) for k in BM_KEYS)}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """``(jax, ranks, worlds)``: the JAX side's arrays, each rank's results
    of the port's side, run at the same time (module doc), and the worlds."""
    path = tmp_path_factory.mktemp("jax_ref") / "parallel_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={N} --xla_cpu_max_isa=AVX "
                  "--xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.Popen([sys.executable, __file__, str(path)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    worlds = {w: _np_world(bm) for w, bm in _port_worlds().items()}
    try:
        ranks = M.run_ranks(run_cases, N, "gloo", "cpu", worlds, _cases(worlds), timeout=600)
    finally:
        log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log
    with np.load(path) as z:
        jax_ref = {k: z[k] for k in z.files}
    for r in ranks[1:]:  # every rank ends with the same results
        for k, v in ranks[0].items():
            if not k.startswith("collectives/"):
                np.testing.assert_array_equal(r[k], v, err_msg=k)
    return jax_ref, ranks, worlds


def test_worlds_are_the_jax_packages(both):
    jax_ref, _, worlds = both
    for w, d in worlds.items():
        for k in BM_KEYS:
            want = jax_ref[f"{w}/bm/{k}"]
            np.testing.assert_array_equal(d[k], want.view(np.int32) if want.dtype == np.uint32 else want,
                                          err_msg=f"{w}/{k}")


@pytest.mark.parametrize("name", list(FRAMES))
def test_sharded_frames_bit_equal_to_jax_and_single_device(both, name):
    """Each frame, both parities where chained: the port's 4 ranks equal
    JAX's 4-device mesh and the port's single-device ``render_frame``."""
    jax_ref, ranks, worlds = both
    port = ranks[0]
    kind, w, fields, use_lt, frames = FRAMES[name]
    cfg = render_config(fields)
    bm = brickmap_from_numpy(worlds[w], device="cpu")
    env = Environment.default(device="cpu")
    fb = make_framebuffer(cfg, device="cpu")
    for fn in frames:
        render_frame(bm, fb, torch.tensor(ORIGIN), torch.tensor(EULER), env, fn, cfg,
                     lt=make_line_table(bm) if use_lt else None)
        np.testing.assert_array_equal(port[f"{name}/{fn}"], jax_ref[f"{name}/{fn}"], err_msg=f"{name} frame {fn}")
        np.testing.assert_array_equal(port[f"{name}/{fn}"], fb.numpy(), err_msg=f"{name} frame {fn}")


def test_sharded_frame_at_jax_camera_bit_equal_to_single_device(both):
    _, ranks, worlds = both
    cfg = render_config(FRAMES["rows"][2])
    bm = brickmap_from_numpy(worlds["tiled"], device="cpu")
    fb = make_framebuffer(cfg, device="cpu")
    for fn in (0, 1):
        render_frame(bm, fb, torch.tensor(ORIGIN), torch.tensor(EULER_JAX), Environment.default(device="cpu"), fn, cfg)
        np.testing.assert_array_equal(ranks[0][f"rows_jax_camera/{fn}"], fb.numpy())


def test_sharded_frame_at_jax_camera_bit_equal_to_jax(both):
    """tests/test_parallel.py's camera (0.9, 0.3, 0): the port's 4 ranks
    equal JAX's 4-device mesh, 0 pixel diffs on both parities."""
    jax_ref, ranks, _ = both
    for fn in (0, 1):
        got, want = ranks[0][f"rows_jax_camera/{fn}"], jax_ref[f"rows_jax_camera/{fn}"]
        assert int((got != want).any(-1).sum()) == 0, f"frame {fn}"


@pytest.mark.parametrize("name", list(RAYTRACE))
def test_raytrace_sharded_bit_equal_to_jax_and_single_device(both, name):
    """The shards' outputs, gathered, and the mesh-wide mean (exact at this
    size: every float32 sum is an integer below 2^24)."""
    jax_ref, ranks, worlds = both
    port = ranks[0]
    w, use_lt, max_steps = RAYTRACE[name]
    for f in FIELDS:
        np.testing.assert_array_equal(port[f"{name}/{f}"], jax_ref[f"{name}/{f}"], err_msg=f)
    assert port[f"{name}/mean"] == jax_ref[f"{name}/mean"] and port[f"{name}/mean"].dtype == np.float32
    _, origins, rays = _inputs()
    bm = brickmap_from_numpy(worlds[w], device="cpu")
    o, d = torch.from_numpy(origins), torch.from_numpy(rays)
    single = trace_brickmap_hbm(bm, make_line_table(bm), o, d, max_steps) if use_lt else trace_brickmap(bm, o, d)
    for f, v in zip(FIELDS, single):
        np.testing.assert_array_equal(port[f"{name}/{f}"], v.numpy(), err_msg=f)
    assert port[f"{name}/mean"] == np.float32(single.steps.sum().item() / 200)


def test_replicate_world_moves_every_table_to_the_ranks_device():
    from voxelengine_tpu_torch.parallel import sharded

    bm = _port_worlds()["tiled"]
    mesh = M.Mesh(None, 0, 1, "rows", torch.device("meta"))
    out = sharded.replicate_world(mesh, bm)
    assert all(getattr(out, k).device.type == "meta" for k in ("meta", "brick_idx", "bricks"))
    assert (out.grid_dims, out.factor, out.coarse_layout) == (bm.grid_dims, bm.factor, bm.coarse_layout)


def test_uneven_rows_are_refused():
    """Heights the mesh does not divide are refused, as JAX asserts."""
    from voxelengine_tpu_torch.parallel import sharded

    mesh = M.Mesh(None, 0, 8, "rows", torch.device("cpu"))
    cfg = render_config(dict(width=16, height=12, checkerboard=True))
    bm = _port_worlds()["tiled"]
    with pytest.raises(ValueError, match="divide"):
        sharded.render_frame_sharded(bm, torch.zeros(12, 16, 3), torch.zeros(3), torch.zeros(3),
                                     Environment.default(device="cpu"), 0, cfg, mesh)


def test_mesh_collectives(both):
    """psum, pmin, pmax (bools as any), all_gather in rank order, and the
    neighbour permute: zeros where a rank has no neighbour."""
    _, ranks, _ = both
    zero = np.zeros(2, np.int64)
    for r, o in enumerate(ranks):
        def got(f):
            return o[f"collectives/{f}"]
        np.testing.assert_array_equal(got("psum"), [10.0, -6.0, 12.0])
        np.testing.assert_array_equal(got("pmin"), [1.0, -3.0, 0.0])
        np.testing.assert_array_equal(got("pmax"), [4.0, 0.0, 6.0])
        np.testing.assert_array_equal(got("any"), [True, False])
        np.testing.assert_array_equal(got("gather"), [[0, 0], [1, 1], [2, 2], [3, 3]])
        np.testing.assert_array_equal(got("below"), np.full(2, 10 * (r - 1) + 1) if r > 0 else zero)
        np.testing.assert_array_equal(got("above"), np.full(2, 10 * (r + 1) + 2) if r < N - 1 else zero)


def test_run_ranks_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2"):
        M.run_ranks(cases.fail_on_rank, 2, "gloo", "cpu", 1, timeout=120)


def test_entry_frame_on_the_cpu():
    """``entry()``'s frame: one shaded checkerboard frame of the 64^3
    world through its line table (the plain macro walk on the CPU)."""
    from voxelengine_tpu_torch import entry

    fn, args = entry.entry("cpu")
    fb = fn(*args)
    assert fb.shape == (64, 128, 3) and bool(torch.isfinite(fb).all()) and float(fb.max()) > 0


@pytest.mark.cuda
def test_sharded_frames_on_two_ranks_sharing_the_card():
    """Two gloo ranks on the one card: the row-band and cyclic frames
    through K1 and ``raytrace_sharded`` equal the single-device frames and
    trace on the card (the card's shading rounds some ops apart from the
    CPU's, so the reference is rendered there too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    worlds = {w: _np_world(bm) for w, bm in _port_worlds().items()}
    _, origins, rays = _inputs()
    names = ("rows_lt", "cyclic_lt")
    cases = [(name, FRAMES[name][0], dict(world="linear", cfg=FRAMES[name][2], origin=ORIGIN, euler=EULER,
                                          frames=FRAMES[name][4], lt=True)) for name in names]
    cases.append(("raytrace_lt", "raytrace", dict(world="linear", origins=origins, rays=rays, max_steps=512, lt=True)))
    got = M.run_ranks(run_cases, 2, "gloo", "cuda", worlds, cases, timeout=300)[0]
    dev = torch.device("cuda")
    bm = brickmap_from_numpy(worlds["linear"], device=dev)
    lt = make_line_table(bm)
    for name in names:
        cfg = render_config(FRAMES[name][2])
        fb = make_framebuffer(cfg, device=dev)
        for fn in FRAMES[name][4]:
            render_frame(bm, fb, torch.tensor(ORIGIN, device=dev), torch.tensor(EULER, device=dev),
                         Environment.default(device=dev), fn, cfg, lt=lt)
            np.testing.assert_array_equal(got[f"{name}/{fn}"], fb.cpu().numpy(), err_msg=f"{name} frame {fn}")
    single = trace_brickmap_hbm(bm, lt, torch.from_numpy(origins).to(dev), torch.from_numpy(rays).to(dev), 512)
    for f, v in zip(FIELDS, single):
        np.testing.assert_array_equal(got[f"raytrace_lt/{f}"], v.cpu().numpy(), err_msg=f)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
