"""Profiling / metrics utilities: counterpart of :mod:`voxelengine_tpu.utils.profiling`.

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
