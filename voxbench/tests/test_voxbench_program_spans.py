"""The readers of the program's spans (``voxbench/program_spans.py`` and
``launch_host_ms.*``, ``program_host_ms.*``, ``kernel_launches.*``,
``idle_in_program_pct.*``) on synthetic rings and runs: a retaken profile
leaves two tries in the ring and only the last counts, the clock anchor
recovers a known offset, and a program without spans reads nothing."""

from collections import namedtuple
from types import SimpleNamespace

import pytest

from voxbench import manifest, program_spans
from voxbench.work import Run
from voxelengine_tpu_torch.utils import profiling

US = 1000  # ns
# the fields of the program's ``utils/profiling.py::SpanRecord``
SpanRecord = namedtuple("SpanRecord", "index name start_ns end_ns parent step detail")


class Ring:
    """Builds records as the program's ring holds them (times in us)."""

    def __init__(self):
        self.recs = []
        self.step = {}  # index -> step: a root's own index, a child's its parent's

    def add(self, name, start, end, parent=-1, detail=None):
        n = len(self.recs)
        self.step[n] = n if parent == -1 else self.step[parent]
        self.recs.append(SpanRecord(n, name, int(start * US), int(end * US), parent, self.step[n], detail))
        return n


def shaded_frames(ring, t0, steps):
    """``steps`` shaded frames from ``t0`` us: a 700 us ``frame`` with 6
    launches of 20 us; returns each frame's (start, end)."""
    out = []
    for k in range(steps):
        s = t0 + k * 1000
        f = ring.add("frame", s, s + 700)
        ring.add("frame.rays", s + 10, s + 60, f)
        ring.add("launch", s + 30, s + 50, f, detail="vx_rays_frame")
        ring.add("frame.trace", s + 70, s + 120, f)
        ring.add("launch", s + 90, s + 110, f, detail="vx_bigtrace_rays")
        for j, kind in enumerate(("shadow", "reflection", "ao")):
            sec = ring.add("frame.secondary", s + 200 + 100 * j, s + 280 + 100 * j, f, detail=kind)
            ring.add("launch", s + 230 + 100 * j, s + 250 + 100 * j, sec, detail="vx_bigtrace_secondary")
        sh = ring.add("frame.shade", s + 600, s + 690, f)
        ring.add("launch", s + 640, s + 660, sh, detail="vx_shade_composite")
        out.append((s, s + 700))
    return out


def profile(spans, gaps, window_s):
    return SimpleNamespace(spans=spans, window_s=window_s, busy=lambda: (window_s - sum(b - a for a, b in gaps), gaps))


def read(metric, run, recs, monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    return manifest.reader(metric).read(run)


def test_a_retaken_profile_counts_only_the_last_try(monkeypatch):
    ring = Ring()
    shaded_frames(ring, 0, 5)  # the lost try: 5 frames
    ring.add("launch", 20_000, 20_030, detail="vx_other")  # outside any frame: not the program's step
    kept = shaded_frames(ring, 100_000, 4)  # the kept try
    run = Run(entry="render_frame", steps=4, window_s=0.004)
    assert read("kernel_launches.frame", run, ring.recs, monkeypatch) == 6.0
    assert read("launch_host_ms.frame", run, ring.recs, monkeypatch) == pytest.approx(0.120)
    assert read("program_host_ms.frame", run, ring.recs, monkeypatch) == pytest.approx(0.700 - 0.120)
    w = program_spans.window(run, "render_frame", ring.recs)
    assert w.steps == 4 and sorted((r.start_ns // US, r.end_ns // US) for r in w.roots) == kept
    assert len(w.inside) == 4 * 13 and {r.step for r in w.inside} == {r.index for r in w.roots}


def test_the_app_frame_reads_screen_and_bgra8(monkeypatch):
    ring = Ring()
    for k in range(3):
        s = k * 3000
        sc = ring.add("screen", s, s + 900)
        f = ring.add("frame", s + 50, s + 850, sc)
        for j in range(6):
            ring.add("launch", s + 100 + 100 * j, s + 130 + 100 * j, f, detail="vx")
        ring.add("bgra8", s + 1000, s + 1040)
    run = Run(entry="render_screen_present", steps=3, window_s=0.009)
    assert read("kernel_launches.present", run, ring.recs, monkeypatch) == 6.0
    assert read("launch_host_ms.present", run, ring.recs, monkeypatch) == pytest.approx(0.180)
    assert read("program_host_ms.present", run, ring.recs, monkeypatch) == pytest.approx(0.900 + 0.040 - 0.180)


def test_the_query_leaves_out_its_wait(monkeypatch):
    ring = Ring()
    for k in range(2):
        s = k * 2000
        rt = ring.add("raytrace", s, s + 1500)
        tr = ring.add("raytrace.trace", s + 20, s + 100, rt)
        ring.add("launch", s + 40, s + 80, tr, detail="vx_bigtrace_rays")
        ring.add("raytrace.record", s + 100, s + 400, rt)
        ring.add("raytrace.sync", s + 400, s + 1400, rt)
    run = Run(entry="raytrace", steps=2, window_s=0.004)
    assert read("kernel_launches.query", run, ring.recs, monkeypatch) == 1.0
    assert read("launch_host_ms.query", run, ring.recs, monkeypatch) == pytest.approx(0.040)
    assert read("program_host_ms.query", run, ring.recs, monkeypatch) == pytest.approx(1.500 - 0.040 - 1.000)


def test_the_anchor_recovers_a_known_offset_and_the_idle_share(monkeypatch, capsys):
    ring = Ring()
    frames = shaded_frames(ring, 5_000_000, 10)  # perf_counter 5 s on
    offset = -4.99  # the window's clock is the program's less 4.99 s
    jitter = [3e-6, 5e-6, 4e-6, 6e-6, 4e-6, 5e-6, 3e-6, 5e-6, 4e-6, 40e-6]  # the return; one late
    bench = [("enqueue", s / 1e6 + offset, e / 1e6 + offset + j) for (s, e), j in zip(frames, jitter)]
    bench += [("wait", e / 1e6 + offset + 0.0001, e / 1e6 + offset + 0.0002) for _, e in frames]
    # idle: 200 us inside each of the first 5 frames, and 100 us between frames 6 and 7
    gaps = [((s + 100) / 1e6 + offset, (s + 300) / 1e6 + offset) for s, _ in frames[:5]]
    gaps.append((frames[6][1] / 1e6 + offset + 0.0002, frames[6][1] / 1e6 + offset + 0.0003))
    run = Run(entry="render_frame", steps=10, window_s=0.010, profile=profile(bench, gaps, 0.010))
    w = program_spans.window(run, "render_frame", ring.recs)
    off, spread, k = program_spans.anchor(run, w, "render_frame")
    assert k == 10 and off == pytest.approx(offset + 4.5e-6, abs=1e-9) and spread < 3e-6
    pct = read("idle_in_program_pct.frame", run, ring.recs, monkeypatch)
    # 5 x 200 us idle inside frames, shifted 4.5 us by the median return, of 10 ms
    assert pct == pytest.approx(100.0 * 5 * 200e-6 / 0.010, rel=1e-6)
    assert "anchored over 10 steps" in capsys.readouterr().err


def test_overlap_of_interval_unions():
    assert program_spans.overlap_s([(0, 2), (1, 3), (5, 6)], [(2.5, 5.5)]) == pytest.approx(1.0)
    assert program_spans.overlap_s([], [(0, 1)]) == 0.0


def test_without_the_programs_spans_every_reader_reads_nothing(monkeypatch):
    run = Run(entry="raytrace", steps=3, window_s=1.0, profile=profile([("call", 0.1, 0.2)], [(0.0, 1.0)], 1.0))
    names = [m["name"] for m in manifest.load()["per_layer"] if m["name"].split(".")[0] in
             ("launch_host_ms", "program_host_ms", "kernel_launches", "idle_in_program_pct")]
    assert len(names) == 12
    for name in names:
        assert read(name, run, [], monkeypatch) is None, name
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "span_records", raising=False)  # a program that keeps no ring
    assert program_spans.records() == []


def test_a_run_of_another_entry_reads_nothing(monkeypatch):
    ring = Ring()
    shaded_frames(ring, 0, 3)
    run = Run(entry="raytrace", steps=3, window_s=0.003)
    for suffix in ("frame", "present"):
        assert read(f"kernel_launches.{suffix}", run, ring.recs, monkeypatch) is None
