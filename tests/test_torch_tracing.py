"""The port's spans (``voxelengine_tpu_torch/utils/profiling.py::span``):
off without a profiler (the shared do-nothing context, no range, nothing in
the ring), live under ``torch.profiler`` (``vx.*`` ranges in the profile,
records with parents, steps (the root's index) and details in a bounded
ring), and placed
at the layers' boundaries: a frame and its stages, the app's screen and its
BGRA conversion, a ray-API call and its parts, each kernel launch.  And
``raytrace``'s timing: ``last_kernel_ms`` without synchronising the card.

On the card: a shaded frame's 6 and a primary frame's 3 ``launch`` spans,
a query's 1, no ``vx.*`` range drawn on the device's timeline, and
``raytrace`` free of device synchronisations.
"""

import contextlib
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voxelengine_tpu_torch import VoxelRaytracer3D
from voxelengine_tpu_torch.config import Environment, RenderConfig
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build
from voxelengine_tpu_torch.render import frame
from voxelengine_tpu_torch.render.graphics import Graphics
from voxelengine_tpu_torch.utils import profiling

ORIGIN = (32.0, 48.0, 32.0)
EULER = (-0.5, 0.8, 0.0)
SHADED = dict(shadow_rays=True, ao_samples=2, reflections=True)


def _dense():
    rng = np.random.default_rng(0xC0FFEE)
    dense = rng.random((64, 64, 64)) < 0.01
    dense[:, 0:4, :] = rng.random((64, 4, 64)) < 0.5
    return dense


def _raytracer(dev):
    rt = VoxelRaytracer3D(line_table=True)
    rt.upload_world(build_brickmap(BitGrid.from_dense(torch.from_numpy(_dense()).to(dev)), 8,
                                   coarse_layout=Layout.LINEAR))
    return rt


def _rays(dev, n=2000):
    rng = np.random.default_rng(50)
    o = (rng.random((n, 3)) * 96 - 16).astype(np.float32)
    t = (rng.random((n, 3)) * 64).astype(np.float32)
    return torch.from_numpy(o).to(dev), torch.from_numpy(t - o).to(dev)


@pytest.fixture(scope="module")
def cpu_rt():
    return _raytracer(torch.device("cpu"))


@pytest.fixture(autouse=True)
def _empty_ring():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(recs, parent):
    return [r.name for r in sorted(recs, key=lambda r: r.start_ns) if r.parent == parent.index]


def _root(recs, name):
    roots = [r for r in recs if r.name == name and r.parent == -1]
    assert len(roots) == 1, [(r.name, r.parent) for r in recs]
    return roots[0]


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    """Off: the same do-nothing object every time, no range opened, nothing
    recorded, the frame's and the call's spans included."""
    def no_range(*a, **k):
        raise AssertionError("a range was opened without a profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("frame"), profiling.span("launch", detail="vx_k")
    assert a is b is profiling._OFF
    with a, b:
        pass
    assert profiling.span_records() == []


def test_without_a_profiler_frames_and_calls_leave_the_ring_empty(cpu_rt):
    g = Graphics(width=32, height=24, device="cpu", max_steps=64, **SHADED)
    g.render_screen(cpu_rt, torch.tensor(ORIGIN), torch.tensor(EULER))
    g.framebuffer_bgra8()
    cpu_rt.raytrace(*_rays("cpu", 200), 64)
    assert profiling.span_records() == []


def test_spans_nest_with_parents_steps_and_details():
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                with profiling.span("launch", detail="vx_k"):
                    pass
            with profiling.span("other"):
                pass
        with profiling.span("loose"):
            pass
    recs = profiling.span_records()
    assert [r.name for r in recs] == ["launch", "inner", "other", "outer", "loose"]  # in the order they closed
    by = {r.name: r for r in recs}
    step = by["outer"].index  # a root's step is its own index, shared by every span under it
    assert by["outer"].parent == -1 and by["outer"].step == step
    assert by["inner"].parent == by["outer"].index and by["inner"].step == step
    assert by["launch"].parent == by["inner"].index and by["launch"].step == step and by["launch"].detail == "vx_k"
    assert by["other"].parent == by["outer"].index and by["other"].step == step
    assert by["loose"].parent == -1 and by["loose"].step == by["loose"].index != step
    assert len({r.index for r in recs}) == 5
    for r in recs:
        assert r.start_ns <= r.end_ns
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["launch"].start_ns
    assert by["launch"].end_ns <= by["inner"].end_ns <= by["outer"].end_ns
    names = [e.name for e in prof.events()]
    for n in ("outer", "inner", "launch", "other", "loose"):
        assert names.count(f"vx.{n}") == 1, n


def test_the_ring_is_bounded_and_clears(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", deque(maxlen=4))
    with _cpu_profile():
        for k in range(10):
            with profiling.span("s", detail=str(k)):
                pass
    recs = profiling.span_records()
    assert [r.detail for r in recs] == ["6", "7", "8", "9"]  # the newest
    assert all(r.step == r.index for r in recs)
    profiling.clear_spans()
    assert profiling.span_records() == []
    assert profiling.SPAN_RING == 1 << 17


def test_a_cpu_frame_yields_its_stages(cpu_rt):
    cfg = RenderConfig(width=32, height=24, max_steps=64, tile_order=True)
    fb = frame.make_framebuffer(cfg, device="cpu")
    with _cpu_profile():
        frame.render_frame(cpu_rt.world, fb, torch.tensor(ORIGIN), torch.tensor(EULER), Environment.default("cpu"), 5,
                           cfg, cpu_rt.line_table)
    recs = profiling.span_records()
    root = _root(recs, "frame")
    assert root.step == root.index
    assert _children(recs, root) == ["frame.rays", "frame.trace", "frame.shade"]
    assert all(r.step == root.index for r in recs)


def test_the_app_frame_yields_screen_then_frame_and_bgra8(cpu_rt):
    g = Graphics(width=32, height=24, device="cpu", max_steps=64)
    with _cpu_profile():
        for _ in range(2):
            g.render_screen(cpu_rt, torch.tensor(ORIGIN), torch.tensor(EULER))
            g.framebuffer_bgra8()
    recs = profiling.span_records()
    screens = sorted((r for r in recs if r.name == "screen"), key=lambda r: r.start_ns)
    assert len(screens) == 2 and all(r.parent == -1 and r.step == r.index for r in screens)
    for s in screens:
        assert _children(recs, s) == ["frame"]
    frames = [r for r in recs if r.name == "frame"]
    assert sorted(r.step for r in frames) == sorted(r.index for r in screens)
    bgra = [r for r in recs if r.name == "bgra8"]
    assert len(bgra) == 2 and all(r.parent == -1 for r in bgra)


def test_a_cpu_raytrace_yields_its_parts_and_times_itself(cpu_rt, capsys):
    o, d = _rays("cpu", 500)
    with _cpu_profile():
        cpu_rt.raytrace(o, d, 64)
        cpu_rt.raytrace(o, d, 64)
    recs = profiling.span_records()
    roots = sorted((r for r in recs if r.name == "raytrace"), key=lambda r: r.start_ns)
    assert len(roots) == 2 and all(r.parent == -1 and r.step == r.index for r in roots)
    for r in roots:
        assert _children(recs, r) == ["raytrace.trace", "raytrace.record"]
    assert cpu_rt.last_kernel_ms > 0.0
    assert capsys.readouterr().out == ""

    profiling.clear_spans()
    loud = VoxelRaytracer3D(verbose_timing=True)
    loud.upload_world(cpu_rt.world)
    with _cpu_profile():
        loud.raytrace(o, d, 64)
    assert "Raytracing time:" in capsys.readouterr().out
    root = _root(profiling.span_records(), "raytrace")
    assert root.step == root.index
    assert _children(profiling.span_records(), root) == ["raytrace.trace", "raytrace.record", "raytrace.sync"]
    assert loud.last_kernel_ms > 0.0


def test_before_any_call_last_kernel_ms_is_zero():
    assert VoxelRaytracer3D().last_kernel_ms == 0.0


def test_a_launch_is_a_span_naming_its_entry(monkeypatch):
    """``kernels/build.py::launch``, the one way to a kernel's launcher,
    records a ``launch`` span with the launcher's entry name."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    calls = []

    def vx_entry(*args):
        calls.append(args)
        return 0

    with _cpu_profile():
        with profiling.span("frame"):
            build.launch("entry", vx_entry, 1, 2, dev=torch.device("cpu"))
    assert calls == [(1, 2, 0)]
    recs = profiling.span_records()
    launch = [r for r in recs if r.name == "launch"]
    root = _root(recs, "frame")
    assert len(launch) == 1 and launch[0].detail == "vx_entry" and launch[0].step == root.index
    assert launch[0].parent == root.index


# ---------------------------------------------------------------------------
# card lane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_rt():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return _raytracer(torch.device("cuda"))


def _launches_under(recs, root):
    return [r.detail for r in recs if r.name == "launch" and r.step == root.index]


@pytest.mark.cuda
def test_card_frames_and_calls_count_their_launches(card_rt):
    """A shaded app frame is 6 launches, a primary frame 3, a query 1; no
    ``vx.*`` range is drawn on the device's timeline."""
    dev = torch.device("cuda")
    g = Graphics(width=64, height=48, device=dev, max_steps=128, tile_order=True, **SHADED)
    cfg = RenderConfig(width=64, height=48, max_steps=128, tile_order=True)
    fb = frame.make_framebuffer(cfg, device=dev)
    o, d = _rays(dev)
    pos, eul = torch.tensor(ORIGIN, device=dev), torch.tensor(EULER, device=dev)
    g.render_screen(card_rt, pos, eul)  # loads each kernel library
    frame.render_frame(card_rt.world, fb, pos, eul, g.environment, 0, cfg, card_rt.line_table)
    card_rt.raytrace(o, d, 128)
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.render_screen(card_rt, pos, eul)
        frame.render_frame(card_rt.world, fb, pos, eul, g.environment, 1, cfg, card_rt.line_table)
        card_rt.raytrace(o, d, 128)
        torch.cuda.synchronize()
    recs = profiling.span_records()
    screen = _root(recs, "screen")
    primary = [r for r in recs if r.name == "frame" and r.parent == -1]
    assert len(primary) == 1
    shaded = _launches_under(recs, screen)
    assert len(shaded) == 6, shaded
    assert sorted(shaded).count("vx_bigtrace_secondary") == 3
    assert _launches_under(recs, primary[0]) == ["vx_rays_frame", "vx_bigtrace_rays", "vx_shade_composite"]
    assert _launches_under(recs, _root(recs, "raytrace")) == ["vx_bigtrace_record"]
    on_device = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.name.startswith("vx.")]
    assert on_device == []


@pytest.mark.cuda
def test_card_raytrace_does_not_synchronise(card_rt):
    o, d = _rays(torch.device("cuda"))
    card_rt.raytrace(o, d, 128)  # loads K1's library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = card_rt.raytrace(o, d, 128)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert card_rt.last_kernel_ms > 0.0
    assert bool(res.valid.any())
