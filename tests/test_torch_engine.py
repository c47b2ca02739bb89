"""The port's engine facade (``VoxelRaytracer3D``, ``RayTraceResults``) and
render facade (``Graphics``) against the JAX package's, bit for bit: batch
ray queries (all six result fields, ``voxel_index`` included) on a LINEAR
world through the line-table route and without it, and on a TILED_LINEAR
world built by ``upload_voxel_buffer``; an edit round trip through
``edit_voxels``; two ``Graphics`` frames, the second orthographic with a
zoom set by ``set_ortho_window_size``; ``set_environment``; and
``get_directions_np``.

The JAX facade runs without a line table (its line-table route would run
Pallas in interpret mode; its ``raytrace`` traces the plain walk either
way), once, in a subprocess as in ``tests/test_torch_render.py``.  The card
lane holds ``raytrace`` through K1 and K4 against the plain walk, and a
call through K1 as one kernel on the card.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch import RayTraceResults, VoxelRaytracer3D
from voxelengine_tpu_torch.config import Projection
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops.bigtrace import brick_lines_view, make_line_table
from voxelengine_tpu_torch.render.camera import get_directions_np
from voxelengine_tpu_torch.render.graphics import Graphics

ROOT = Path(__file__).resolve().parent.parent
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
FIELDS = ("valid", "hit_point", "normal", "distance", "voxel_index", "steps")
ORIGIN = np.array([32.0, 48.0, 32.0], np.float32)
EULER = np.array([-0.5, 0.8, 0.0], np.float32)
EULERS = np.array([[-0.25, 0.75, 0.0], [-0.5, 0.8, 0.0], [0.3, -1.2, 0.0], [1.5, 3.0, 0.2]], np.float32)
GFX = dict(tile_order=True, shadow_rays=True, max_steps=128)
ENV = ((1.0, 2.0, 0.5), (1.5, 1.25, 1.0), (0.4, 0.45, 0.5))


def _world():
    rng = np.random.default_rng(0xC0FFEE)
    dense = rng.random((64, 64, 64)) < 0.01
    dense[:, 0:4, :] = rng.random((64, 4, 64)) < 0.5
    return dense


def _rays():
    """Rays from around the world to random targets in it: hits on every
    face orientation, at fractional y and z."""
    rng = np.random.default_rng(50)
    o = (rng.random((3000, 3)) * 96 - 16).astype(np.float32)
    t = (rng.random((3000, 3)) * 64).astype(np.float32)
    return o, (t - o).astype(np.float32)


def _edits():
    rng = np.random.default_rng(51)
    pts = rng.integers(0, 64, (48, 3)).astype(np.int32)
    pts[24:] = pts[:24] + [1, 0, 0]  # neighbours in one word
    return pts, rng.random(48) < 0.5


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import jax.numpy as jnp

    from voxelengine_tpu import VoxelRaytracer3D as JRT
    from voxelengine_tpu.config import Projection as JProj
    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.brickmap import build_brickmap
    from voxelengine_tpu.core.layout import Layout
    from voxelengine_tpu.render.camera import get_directions_np as jdirs
    from voxelengine_tpu.render.graphics import Graphics as JGraphics

    out = {}
    bm = build_brickmap(JGrid.from_dense(_world()), 8, coarse_layout=Layout.LINEAR)
    for k in BM_KEYS:
        v = getattr(bm, k)
        out[f"bm/{k}"] = np.asarray(getattr(v, "value", v))

    def save(prefix, res):
        for k in FIELDS:
            out[f"{prefix}/{k}"] = np.asarray(getattr(res, k))

    o, d = _rays()
    rt = JRT(line_table=False)
    rt.upload_world(bm)
    save("raytrace", rt.raytrace(o, d, 256))

    g = JGraphics(64, 32, staged_trace=False, **GFX)
    out["gfx/0"] = np.asarray(g.render_screen(rt, ORIGIN, EULER))
    g.set_projection(JProj.ORTHOGRAPHIC)
    g.set_ortho_window_size((6.0, 4.5))
    out["gfx/1"] = np.asarray(g.render_screen(rt, ORIGIN, EULER))
    out["gfx/bgra"] = np.asarray(g.framebuffer_bgra8())
    g.set_environment(*ENV)
    for k in ("light_direction", "light_color", "ambient_color"):
        out[f"env/{k}"] = np.asarray(getattr(g.environment, k))

    pts, vals = _edits()
    rt.edit_voxels(*(jnp.asarray(pts[:, i]) for i in range(3)), jnp.asarray(vals))
    out["edited/meta"], out["edited/bricks"] = np.asarray(rt.world.meta), np.asarray(rt.world.bricks)
    save("edited", rt.raytrace(o, d, 256))

    rt2 = JRT()
    rt2.upload_voxel_buffer(JGrid.from_dense(_world()), 8)
    out["tiled/layout"] = np.asarray(rt2.world.coarse_layout.value)
    save("tiled", rt2.raytrace(o, d, 256))

    for i, e in enumerate(EULERS):
        for k, v in zip(("fwd", "up", "right"), jdirs(e)):
            out[f"dirs{i}/{k}"] = v
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
    path = tmp_path_factory.mktemp("jax_ref") / "engine_ref.npz"
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


def _bm(ref, device="cpu"):
    return brickmap_from_numpy({k: ref[f"bm/{k}"] for k in BM_KEYS}, device=device)


def _check(res, ref, prefix):
    assert isinstance(res, RayTraceResults)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(res, k).cpu().numpy(), ref[f"{prefix}/{k}"], err_msg=f"{prefix} {k}")


@pytest.mark.parametrize("line_table", [True, False])
def test_raytrace_bit_equal(ref, line_table):
    """All six fields, through the line-table route and without it; every
    ``voxel_index`` of a hit names a solid voxel."""
    rt = VoxelRaytracer3D(line_table=line_table)
    rt.upload_world(_bm(ref))
    assert (rt.line_table is not None) == line_table
    res = rt.raytrace(*_rays(), 256)
    _check(res, ref, "raytrace")
    assert rt.last_kernel_ms > 0.0
    v = res.voxel_index[res.valid].long()
    assert bool(res.valid.any()) and bool(rt.world.voxel_bit(v % 64, v // 64 % 64, v // 4096).all())


def test_edit_round_trip(ref):
    """``edit_voxels`` through the line table: the world and the queries
    after it are JAX's, and the table equals a rebuild."""
    rt = VoxelRaytracer3D()
    rt.upload_world(_bm(ref))
    pts, vals = _edits()
    rt.edit_voxels(*(torch.from_numpy(pts[:, i].copy()) for i in range(3)), torch.from_numpy(vals))
    np.testing.assert_array_equal(rt.world.meta.numpy(), ref["edited/meta"])
    np.testing.assert_array_equal(rt.world.bricks.numpy(), ref["edited/bricks"].view(np.int32))
    fresh = make_line_table(rt.world)
    for k in ("region_lines", "macro", "macro2"):
        assert torch.equal(getattr(rt.line_table, k), getattr(fresh, k)), k
    assert torch.equal(rt.line_table.brick_lines, brick_lines_view(rt.world))
    _check(rt.raytrace(*_rays(), 256), ref, "edited")


def test_upload_voxel_buffer_tiled_world(ref):
    """``upload_voxel_buffer`` builds a TILED_LINEAR world, which gets no
    line table (as in JAX); its queries are JAX's."""
    rt = VoxelRaytracer3D()
    rt.upload_voxel_buffer(BitGrid.from_dense(torch.from_numpy(_world())), 8)
    assert rt.world.coarse_layout.value == int(ref["tiled/layout"]) and rt.line_table is None
    _check(rt.raytrace(*_rays(), 256), ref, "tiled")


def test_graphics_frames_bit_equal(ref):
    """Two frames through the raytracer's line table: perspective with
    shadow rays, then orthographic at a zoom set on the facade; the BGRA
    bytes; the environment setter."""
    rt = VoxelRaytracer3D()
    rt.upload_world(_bm(ref))
    g = Graphics(64, 32, device="cpu", **GFX)
    np.testing.assert_array_equal(g.render_screen(rt, ORIGIN, EULER).numpy(), ref["gfx/0"])
    g.set_projection(Projection.ORTHOGRAPHIC)
    g.set_ortho_window_size((6.0, 4.5))
    np.testing.assert_array_equal(g.render_screen(rt, ORIGIN, EULER).numpy(), ref["gfx/1"])
    np.testing.assert_array_equal(g.framebuffer_bgra8().numpy(), ref["gfx/bgra"])
    g.set_environment(*ENV)
    for k in ("light_direction", "light_color", "ambient_color"):
        np.testing.assert_array_equal(getattr(g.environment, k).numpy(), ref[f"env/{k}"], err_msg=k)


@pytest.mark.parametrize("i", range(len(EULERS)))
def test_get_directions_np_bit_equal(ref, i):
    for k, v in zip(("fwd", "up", "right"), get_directions_np(EULERS[i])):
        np.testing.assert_array_equal(v, ref[f"dirs{i}/{k}"], err_msg=k)


def test_world_needs_an_upload():
    with pytest.raises(ValueError, match="no world"):
        VoxelRaytracer3D().world


# ---------------------------------------------------------------------------
# card lane
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_raytrace_through_kernel_on_card(cuda_device, kernel):
    """``raytrace`` on the card through K1 (line table) or K4 (none), each
    launched once, against ``_batch_trace`` through the plain walk."""
    from voxelengine_tpu_torch.engine import raytracer
    from voxelengine_tpu_torch.kernels import bigtrace, bmtrace
    from voxelengine_tpu_torch.ops.trace import trace_brickmap

    from voxelengine_tpu_torch.core.brickmap import build_brickmap
    from voxelengine_tpu_torch.core.layout import Layout

    rt = VoxelRaytracer3D(line_table=kernel == "K1")
    rt.upload_world(build_brickmap(BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device)), 8,
                                   coarse_layout=Layout.LINEAR))
    o, d = (torch.from_numpy(a).to(cuda_device) for a in _rays())
    counter = bigtrace if kernel == "K1" else bmtrace
    before = counter.launches, counter.record_launches
    got = rt.raytrace(o, d, 256)
    assert (counter.launches, counter.record_launches) == (before[0] + 1, before[1] + 1)
    want = raytracer.results_from_trace(rt.world, o, trace_brickmap(rt.world, o, d, 256))  # the plain walk
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.cuda
def test_raytrace_is_one_kernel_on_card(cuda_device):
    """A card ``raytrace`` call through the line table puts one kernel on
    the card, K1's record entry (found by the names the benchmark's
    ``k1_rays`` kind looks for), and its record is the plain walk's."""
    from voxelengine_tpu_torch.core.brickmap import build_brickmap
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.engine import raytracer
    from voxelengine_tpu_torch.ops.trace import trace_brickmap
    from voxelengine_tpu_torch.utils.profiling import kernel_profile

    rt = VoxelRaytracer3D(line_table=True)
    rt.upload_world(build_brickmap(BitGrid.from_dense(torch.from_numpy(_world()).to(cuda_device)), 8,
                                   coarse_layout=Layout.LINEAR))
    o, d = (torch.from_numpy(a).to(cuda_device) for a in _rays())
    got = rt.raytrace(o, d, 256)  # loads K1's library
    kernels, _ = kernel_profile(lambda: rt.raytrace(o, d, 256))
    assert kernels is not None and len(kernels) == 1, kernels
    assert "bigtrace_kernel" in kernels[0] and "OriginRays" in kernels[0] and "SecondaryRays" not in kernels[0]
    want = raytracer.results_from_trace(rt.world, o, trace_brickmap(rt.world, o, d, 256))
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
