"""The traced window: host spans, a ``torch.profiler`` profile of the card,
and what the per-layer readers and the breakdown take from them.

The profile's retake and its marker kernels are a frozen copy of
``voxelengine_tpu_torch/utils/profiling.py:63-111`` (``kernel_profile``,
commit eb10204): the profiler can lose the first kernels of a recorded
window once other processes used the card, so marker kernels
(``torch.cuda._sleep(0)``) run before and after the window and are left
out, and a profile that lost any kernel the window launched is taken again.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

MARKER_KERNELS = 32
TRIES = 3
# a step's kernels, by parts of their names: K1's rays entry (and its record
# entry, OriginRaysRecord), its secondary entry; K4's alike, in either
# instantiation (DenseSlotFetch, CompactFetch); the ray-setup and shading
# kernels
KERNEL_KINDS = {"k1_rays": ("bigtrace_kernel", "OriginRays"), "k1_secondary": ("bigtrace_kernel", "SecondaryRays"),
                "k4_rays": ("bmtrace_kernel", "OriginRays"), "k4_secondary": ("bmtrace_kernel", "SecondaryRays"),
                "rays": ("rays_kernel",), "shade": ("shade_kernel",)}


def kernel_kind(name: str):
    for kind, parts in KERNEL_KINDS.items():
        if all(p in name for p in parts):
            return kind
    return None


class Spans:
    """Host spans of the window, by name: each span's seconds; while
    profiling each is also a ``record_function`` range, so that the
    profile can say what the host did while the card sat idle."""

    def __init__(self, profiling: bool = False):
        self.seconds = defaultdict(list)
        self.profiling = profiling

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(f"voxbench.{name}") if self.profiling else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


class NoSpans:
    """The untraced window's spans: nothing recorded."""

    seconds: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        yield


def _markers() -> None:
    for _ in range(MARKER_KERNELS):
        torch.cuda._sleep(0)


class Profile:
    """Device activity and host spans of one traced window, in seconds from
    the window's start: ``device`` ``[(name, start, end)]`` of every kernel,
    copy and set; ``spans`` ``[(name, start, end)]``; ``window_s``."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        win = [e for e in events if e.name == "voxbench.window"]
        if not win:
            raise RuntimeError("the profile holds no window span")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        self.window_s = (w1 - w0) / 1e6
        self.device, self.spans = [], []
        for e in events:
            s, t = (e.time_range.start - w0) / 1e6, (e.time_range.end - w0) / 1e6
            if e.device_type == cuda:
                # annotations (the spans' ranges on the device's timeline) are no device work
                if ("spin_kernel" in e.name or e.name.startswith(("ProfilerStep", "voxbench.")) or t <= 0
                        or s >= self.window_s):
                    continue
                self.device.append((e.name, max(s, 0.0), min(t, self.window_s)))
            elif e.name.startswith("voxbench.") and e.name != "voxbench.window":
                self.spans.append((e.name[len("voxbench."):], s, t))

    def kernels(self):
        """``[(name, seconds)]`` of the kernels (copies and sets left out)."""
        return [(n, t - s) for n, s, t in self.device if not n.startswith(("Memcpy", "Memset"))]

    def launches(self) -> dict:
        """Launches of each kind of :data:`KERNEL_KINDS`."""
        out = defaultdict(int)
        for n, _ in self.kernels():
            k = kernel_kind(n)
            if k:
                out[k] += 1
        return out

    def kind_seconds(self, kind: str) -> list:
        return [s for n, s in self.kernels() if kernel_kind(n) == kind]

    def busy(self):
        """The union of device activity: ``(busy seconds, idle gaps
        [(start, end)])`` within the window."""
        iv = sorted((s, t) for _, s, t in self.device)
        busy, gaps, cur = 0.0, [], 0.0
        for s, t in iv:
            if s > cur:
                gaps.append((cur, s))
            if t > cur:
                busy += t - max(s, cur)
                cur = t
        if cur < self.window_s:
            gaps.append((cur, self.window_s))
        return busy, gaps

    def breakdown(self, top: int = 10) -> dict:
        """``device_ops``: device seconds by operation name, the largest
        ``top``; ``idle_gaps``: idle seconds by the host span open when
        each gap began (``loop`` where none was), the largest ``top``."""
        by_op = defaultdict(float)
        for n, s, t in self.device:
            by_op[n] += t - s
        _, gaps = self.busy()
        spans = sorted(self.spans, key=lambda x: x[1])
        by_span = defaultdict(float)
        for g0, g1 in gaps:
            open_ = [n for n, s, t in spans if s <= g0 < t]
            by_span[open_[-1] if open_ else "loop"] += g1 - g0
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_span)}


def profiled(run_window, expected: dict):
    """Run ``run_window(spans)`` under ``torch.profiler``, with the marker
    kernels around it, up to :data:`TRIES` times, until the profile holds
    every launch the window made: ``expected(steps)`` gives the launches of
    each kind for the steps the window ran.  Returns ``(steps, Profile,
    spans, tries)``; raises where every profile lost launches."""
    from torch.profiler import ProfilerActivity, profile

    lost = None
    for attempt in range(1, TRIES + 1):
        spans = Spans(profiling=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _markers()
            with torch.profiler.record_function("voxbench.window"):
                steps = run_window(spans)
            _markers()
            torch.cuda.synchronize()
        p = Profile(prof.events())
        got, want = p.launches(), expected(steps)
        lost = {k: (got.get(k, 0), v) for k, v in want.items() if got.get(k, 0) < v}
        if not lost:
            return steps, p, spans, attempt
    raise RuntimeError(f"every profile lost launches (kind: recorded, launched): {lost}")
