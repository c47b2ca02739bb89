"""The bench scene the experiments measure: a bench world from the
harness's cache (built through W1 on a first run), its line table, the
bench camera and the memoized macro decision, as
``voxelengine_tpu_torch/bench.py`` sets them up."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from voxelengine_tpu_torch import bench
from voxelengine_tpu_torch.config import Environment, RenderConfig
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.ops.bigtrace import LineTable
from voxelengine_tpu_torch.render.frame import primary_rays

OUT_DIR = "experiments_out"  # the experiments' files (ignored by git)


class Scene(NamedTuple):
    bm: BrickMap
    lt: LineTable
    cfg: RenderConfig
    origin: torch.Tensor
    euler: torch.Tensor
    env: Environment
    device: torch.device


def bench_scene(world: str = "full", device=None, cache_dir: str = ".world_cache", width: int = 1920,
                height: int = 1080, dims=None, octaves: int = 32, camera_y: float = 380.0) -> Scene:
    """The scene of ``bench.run(world=...)``: the world through
    ``bench``'s cache (``huge`` keeps the raw bricks on the host and
    uploads their brick lines), the line table, the frame configuration
    with the probe's macro decision and the bench camera.  ``device``
    defaults to the card (exit 3 without one)."""
    dev = bench._resolve_device(device)
    dims = tuple(dims or bench.WORLDS[world])
    host = world == "huge"
    bm, bricks_host, key = bench._world(world, dims, octaves, "pallas", host, True, cache_dir, dev)
    lt = bench._line_table(bm, bricks_host, key, cache_dir, dev)
    cfg = RenderConfig(width=width, height=height, checkerboard=True, tile_order=True)
    origin_host = (dims[0] / 2, camera_y, dims[2] / 2)
    origin = torch.tensor(origin_host, dtype=torch.float32, device=dev)
    e = torch.tensor(bench.EULER, dtype=torch.float32, device=dev)
    o, d = primary_rays(cfg, origin, e, 1)[:2]
    use_macro = bench.macro_decision(bm, lt, cfg, o, d, key, cache_dir, origin_host, bench.EULER)
    cfg = dataclasses.replace(cfg, trace_use_macro=use_macro)
    return Scene(bm, lt, cfg, origin, e, Environment.default(dev), dev)


def ms_timer(device: torch.device, enqueue: bool = False):
    """``time(fn) -> ms``: CUDA events on the card, the host clock
    elsewhere; with ``enqueue``, ``(ms, host ms)``, the host clock from the
    start until ``fn`` returned, before the device is waited for (the two
    agree where the host, not the card, sets the pace)."""
    import time

    def timed(fn):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            host = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn()
            ms = host = (time.perf_counter() - t0) * 1e3
        return (ms, host) if enqueue else ms

    return timed


def spread(xs) -> dict:
    """Median, least and largest of the samples ``xs``, unrounded."""
    a = np.asarray(xs, np.float64)
    return {"median": float(np.median(a)), "min": float(a.min()), "max": float(a.max()), "n": int(a.size)}
