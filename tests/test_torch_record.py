"""The record entries (``vx_bigtrace_record``, ``vx_trace_brickmap_{dense,
compact}_record``): ``VoxelRaytracer3D.raytrace``'s card path, one launch
that traces the rays and stores the result record as each ray's walk ends
(``csrc/ray_setup.cuh::OriginRaysRecord``).

CPU rays take the card's path here through the entries' host twins
(``csrc/dda_host.cpp``, the kernels' per-ray code built by g++), routed as
``tests/test_torch_frame_kernels.py`` routes a frame: ``raytrace``'s
``_is_cuda`` true, ``build.load_kernel`` and ``build.launch`` pointed at
the twins.  Each case holds the record, every field bit for bit, against
``results_from_trace`` over the plain walk, and counts one launch a call:
K1 through the line table, K4 over dense slots (a TILED_LINEAR world) and
over a compact world; hits and misses from outside the world, misses only,
starts inside a solid voxel (hits at the start), rays stopped by the step
budget, and one origin broadcast to every ray (row stride 0).
"""

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch import RayTraceResults, VoxelRaytracer3D
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap, compact_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.engine import raytracer
from voxelengine_tpu_torch.kernels import bigtrace, bmtrace, build
from voxelengine_tpu_torch.ops.trace import trace_brickmap

FIELDS = ("valid", "hit_point", "normal", "distance", "voxel_index", "steps")
X = 64


def _world():
    """``[z, y, x]``: sparse voxels over a half-full floor, and a solid
    16^3 block (whole bricks at factor 8: the compact form's shared full
    brick)."""
    rng = np.random.default_rng(0xC0FFEE)
    dense = rng.random((X, X, X)) < 0.01
    dense[:, 0:4, :] = rng.random((X, 4, X)) < 0.5
    dense[40:56, 8:24, 40:56] = True
    return dense


def _cases(dense):
    """name -> (origins f32[N, 3] or f32[3] (broadcast), directions, max_steps)."""
    rng = np.random.default_rng(91)
    f32 = np.float32
    o = (rng.random((600, 3)) * 96 - 16).astype(f32)
    t = (rng.random((600, 3)) * X).astype(f32)
    solid = np.argwhere(dense)[rng.choice(int(dense.sum()), 128, replace=False), ::-1]  # (x, y, z)
    inside = (solid + rng.random((128, 3)) * 0.98 + 0.01).astype(f32)
    centre = np.full(3, X / 2, f32)
    far = (rng.normal(size=(256, 3)) * 200).astype(f32) + centre
    return {
        "hits_and_misses": (o, t - o, 256),
        "misses": (far, far - centre, 256),  # heading away from the world
        "start_in_solid": (inside, rng.normal(size=(128, 3)).astype(f32), 256),
        "step_budget": (o, t - o, 3),
        "broadcast_origin": (np.array([20.5, 40.25, -9.0], f32), (t - [20.5, 40.25, -9.0]).astype(f32), 256),
    }


def _raytracer(kind, dense):
    grid = BitGrid.from_dense(torch.from_numpy(dense))
    rt = VoxelRaytracer3D(line_table=kind == "K1")
    if kind == "K4":
        rt.upload_voxel_buffer(grid, 8)  # TILED_LINEAR, dense slots
    else:
        bm = build_brickmap(grid, 8, coarse_layout=Layout.LINEAR)
        rt.upload_world(bm if kind == "K1" else compact_brickmap(bm))
    assert (rt.line_table is not None) == (kind == "K1")
    assert rt.world.dense_slots == (kind != "K4-compact")
    return rt


class _HostKernels:
    """The record entries' launchers as their host twins (K1's without its
    work counter and grid, K4's without its instantiation flag and work
    counter)."""

    def __init__(self):
        dda = build.load_dda_host()
        k1 = dda.vx_bigtrace_record_host
        self.vx_bigtrace_record = lambda *a: k1(*a[:-2])
        dense, compact = dda.vx_trace_brickmap_dense_record_host, dda.vx_trace_brickmap_compact_record_host
        self.vx_trace_brickmap_dense_record = lambda *a: dense(*a[:16], *a[18:])
        self.vx_trace_brickmap_compact_record = lambda *a: compact(*a[:17], *a[19:])


@pytest.fixture
def card_route(monkeypatch):
    """``raytrace`` on CPU tensors takes the card's path through the host
    twins; returns the launches made, by entry."""
    seen = []
    kernels = _HostKernels()

    def launch(kernel, fn, *args, dev):
        seen.append(kernel)
        assert fn(*args) == 0

    monkeypatch.setattr(raytracer, "_is_cuda", lambda t: True)
    monkeypatch.setattr(build, "require_cuda", lambda kernel, dev: None)
    monkeypatch.setattr(build, "load_kernel", lambda name: kernels)
    monkeypatch.setattr(build, "launch", launch)
    return seen


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("case", ["hits_and_misses", "misses", "start_in_solid", "step_budget", "broadcast_origin"])
@pytest.mark.parametrize("kind", ["K1", "K4", "K4-compact"])
def test_record_entry_equals_results_from_trace(card_route, kind, case):
    dense = _world()
    o, d, max_steps = _cases(dense)[case]
    rt = _raytracer(kind, dense)
    d = torch.from_numpy(d)
    o = torch.from_numpy(o).expand(d.shape[0], 3) if o.ndim == 1 else torch.from_numpy(o)
    assert (o.stride(0) == 0) == (case == "broadcast_origin")
    counters = (bigtrace, "record_launches") if kind == "K1" else (
        (bmtrace, "record_launches") if kind == "K4" else (bmtrace, "compact_record_launches"))
    before = getattr(*counters)

    got = rt.raytrace(o, d, max_steps)

    assert card_route == ["bigtrace_record" if kind == "K1" else "bmtrace"]
    assert getattr(*counters) == before + 1
    want = raytracer.results_from_trace(rt.world, o, trace_brickmap(rt.world, o, d, max_steps))
    assert isinstance(got, RayTraceResults)
    for k in FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert torch.equal(_bits(g), _bits(w)), k
    valid = got.valid
    if case == "hits_and_misses":
        assert bool(valid.any()) and not bool(valid.all())
    elif case == "misses":
        assert not bool(valid.any()) and bool(torch.isinf(got.hit_point).all())
    elif case == "start_in_solid":
        assert bool(valid.all()) and bool((got.steps == 0).all()) and bool((got.distance == 0).all())
    elif case == "step_budget":
        assert bool(((got.steps == max_steps) & ~valid).any())
    hits = got.voxel_index[valid].long()
    assert bool(torch.from_numpy(dense)[hits // (X * X), hits // X % X, hits % X].all())  # dense is [z, y, x]
