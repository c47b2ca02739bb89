"""Profiling / metrics utilities: counterpart of ``voxelengine_tpu/utils/profiling.py``.

The reference's instrumentation (``main.cu:22-32`` timing brackets, the
kernel timing printout ``VolumeRaytracer.cu:587-595``, the EMA frame-time
"Avg FPS" title ``main.cu:170-194``, the average-DDA-steps metric
``DDATestCpp.cpp:618-625``).  Where the JAX module waits on
``jax.effects_barrier``/``block_until_ready``, :func:`timed` synchronises
the CUDA device it is given; with no device, or a CPU one, it reads the
host clock at once.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict

import torch


@contextlib.contextmanager
def timed(label: str, sink: Dict[str, float] | None = None, verbose: bool = True, device=None):
    """Wall-clock bracket, the ``cudaDeviceSynchronize``-then-read-clock
    analog: work queued on ``device`` (a CUDA device) inside the bracket is
    finished before the clock is read.  Records ``label -> ms`` in ``sink``
    and prints it when ``verbose``."""
    dev = torch.device(device) if device is not None else None
    t0 = time.perf_counter()
    yield
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1000.0
    if sink is not None:
        sink[label] = ms
    if verbose:
        print(f"{label}: {ms:.2f}ms")


def device_ms(fn, reps: int = 1, device=None):
    """``(fn(reps - 1), ms)``: the mean time of ``fn(k)`` for ``k`` in
    ``range(reps)``, after one untimed ``fn(reps)`` (a first launch also
    loads its kernel).  On a CUDA ``device`` by CUDA events; otherwise by
    the host clock."""
    dev = torch.device(device) if device is not None else None
    cuda = dev is not None and dev.type == "cuda"
    fn(reps)
    out = None
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for k in range(reps):
        out = fn(k)
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(end) / reps
    return out, (time.perf_counter() - t0) * 1000.0 / reps


MARKER_KERNELS = 32  # torch.cuda._sleep(0) launches around kernel_profile's recorded calls


def _markers() -> None:
    for _ in range(MARKER_KERNELS):
        torch.cuda._sleep(0)


def kernel_profile(fn, calls: int = 1, tries: int = 3):
    """``(names, ms)``: the CUDA kernels ``calls`` runs of ``fn()`` launch
    (memory copies and sets excluded) and the device time of each, by
    ``torch.profiler``; ``(None, None)`` where the profiler records no
    device activity in ``tries`` profiles.  A short kernel's own time:
    CUDA events around a host-bound call also time the card's idle gaps.
    ``fn`` runs ``2 * calls`` times a profile: the first ``calls`` in the
    profiler's warm-up step, whose events are dropped, the rest recorded.
    The profiler can lose the first kernels of the recorded step (3-5 of
    them once other processes have used the card), so
    :data:`MARKER_KERNELS` marker kernels (``spin_kernel``) are launched
    before the recorded calls and after them, and left out of the result.
    It can also record no device activity at all in a profile between two
    that record it, so a profile with none is taken again."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
            _markers()
            for _ in range(calls):
                fn()
            _markers()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    else:
        return None, None
    # not copies, sets, the warm-up schedule's step annotation or the markers
    kernels = [e for e in device
               if not e.name.startswith(("Memcpy", "Memset", "ProfilerStep")) and "spin_kernel" not in e.name]
    return [e.name for e in kernels], [e.time_range.elapsed_us() / 1e3 for e in kernels]


@dataclass
class FrameTimer:
    """EMA frame-time tracker (``main.cu:177-194``, alpha = 1/100)."""

    alpha: float = 1.0 / 100.0
    ema_ms: float = 0.0
    _last: float = field(default=0.0, repr=False)
    frames: int = 0

    def tick(self) -> float:
        now = time.perf_counter()
        if self.frames > 0:
            dt_ms = (now - self._last) * 1000.0
            if self.frames == 1:
                self.ema_ms = dt_ms
            else:
                self.ema_ms = self.ema_ms * (1 - self.alpha) + dt_ms * self.alpha
        self._last = now
        self.frames += 1
        return self.ema_ms

    @property
    def fps(self) -> float:
        return 1000.0 / self.ema_ms if self.ema_ms > 0 else 0.0


@dataclass
class TraceStats:
    """Aggregate ray metrics: Mrays/s + average DDA steps per ray."""

    rays: int = 0
    total_ms: float = 0.0
    total_steps: int = 0

    def record(self, num_rays: int, ms: float, steps_sum: int) -> None:
        self.rays += num_rays
        self.total_ms += ms
        self.total_steps += steps_sum

    @property
    def mrays_per_s(self) -> float:
        return (self.rays / 1e6) / (self.total_ms / 1e3) if self.total_ms else 0.0

    @property
    def avg_steps(self) -> float:
        return self.total_steps / self.rays if self.rays else 0.0
