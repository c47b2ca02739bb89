"""Benchmark harness of the PyTorch port: counterpart of the repo's ``bench.py``.

Measures primary-ray throughput (Mrays/s) and frame time rendering the
BASELINE config-4 scene on one CUDA card: the procedurally generated
8192 x 512 x 8192 brickmap world (factor 32, the reference's terrain rule
bit for bit), 1080p shaded frames with checkerboarding.  The world is built
through W1 straight to compact indirection (or loaded from its disk
cache), its line table and brick lines are made (or loaded), and every
frame traces in K1 with 32x32-pixel-block ray ordering.  Each run checks
that the frame's trace gives the plain ``trace_brickmap``'s hits on a full
frame of rays before it prints a number.

    python -m voxelengine_tpu_torch.bench

Prints exactly ONE JSON line on stdout::

    {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N,
     "n_batches": N, "batch_ms": [...], "device": "<card>, <power limit>"}

``vs_baseline`` is relative to the 1 Gray/s north-star target
(``BASELINE.json``); ``batch_ms`` holds each timed batch's ms a frame
(CUDA events) and ``value`` uses the least of them.  Diagnostics go to
stderr.  Exit codes: 3 without a card (no CPU fallback unless asked for),
4 when the trace's hits differ from the plain walk's on more than 0.01% of
the rays (no JSON line then), 2 for a knob the port does not take.

Environment knobs (:func:`main`; :func:`run` takes each as an argument):

  BENCH_WORLD=small|full|huge  1024^3, 8192x512x8192 (default) or
                       16384x512x16384; ``huge`` keeps the raw bricks on the
                       host and uploads only their brick lines
  BENCH_FRAMES=N       chained frames a timed batch (default 8)
  BENCH_BATCHES=N      timed batches (default 3)
  BENCH_BACKEND=xla    no line table: frames trace through K4's compact
                       instantiation (the JAX package's XLA walk there)
  BENCH_STAGE=N        staged line-table trace, first pass at N steps;
  BENCH_TAILFRAC=N     its tail buffer's divisor (default 8)
  BENCH_W/BENCH_H      resolution (default 1920x1080)
  BENCH_SHADOWS=1, BENCH_AO=N, BENCH_REFLECT=1   secondary rays (through
                       the frame's tracer); each changes the metric name
  BENCH_AUTOMACRO=0    skip the memoized macro probe (macro levels on)
  BENCH_ITERS=1        log the warps' loop iterations on the frame's rays
  BENCH_BLOCKSORT=1    order the pixel blocks by the probe trace's steps
  BENCH_PROFILE=dir    write a torch.profiler trace of the timed batch
  BENCH_WORLD_CACHE=0  build the world without the disk cache
  BENCH_ALLOW_CPU=1    run on the CPU (tiny sanity runs only)

``BENCH_TILE``, ``BENCH_SLOTS``, ``BENCH_SL`` (the TPU kernel's ray tile,
VMEM line-cache slots and line shortlist) and ``BENCH_TPU_TIMEOUT`` (its
backend probe) have no counterpart here: setting one is an error.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

WORLDS = {"small": (1024, 1024, 1024), "full": (8192, 512, 8192), "huge": (16384, 512, 16384)}
WORLD_TAGS = {"small": "1k", "full": "8k", "huge": "16k"}
BACKENDS = ("pallas", "xla")
# the JAX harness's knobs that tune only the TPU kernel or its backend probe
TPU_ONLY_KNOBS = {
    "BENCH_TILE": "the TPU kernel's ray tile",
    "BENCH_SLOTS": "its VMEM line-cache slots",
    "BENCH_SL": "its line shortlist",
    "BENCH_TPU_TIMEOUT": "the TPU backend probe's timeout",
}
EULER = (-0.25, 0.75, 0.0)  # camera on a terrain hill looking across the valley


class BenchRun(NamedTuple):
    """What :func:`run` returns: the JSON record, the final framebuffer and
    the exactness gate's hit diffs."""

    record: dict
    framebuffer: torch.Tensor
    hit_diffs: int


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def world_key(dims, octaves: int = 32) -> str:
    """The world cache's key, the JAX harness's (``_lt1`` is appended for
    the line table)."""
    return f"terrain_{dims[0]}x{dims[1]}x{dims[2]}_f32_o{octaves}_v1"


def metric_name(world: str, height: int, shadows: bool, ao: int, reflect: bool) -> str:
    """The result's metric name: the headline primary-ray metric, suffixed
    by each shading option so a row with secondary rays is never read as
    the headline."""
    shading = ("_shadows" if shadows else "") + (f"_ao{ao}" if ao else "") + ("_refl" if reflect else "")
    return f"primary_mrays_per_s_{height}p_checkerboard_{WORLD_TAGS[world]}_world{shading}"


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit`` gives them (the device's name alone where
    ``nvidia-smi`` cannot be read), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _upload(host: np.ndarray, device) -> torch.Tensor:
    """A read-only host array (a memory map of the world cache) as an int32
    tensor on ``device``; the tensor is only read."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # torch warns on non-writable arrays
        return torch.from_numpy(host.view(np.int32)).to(device)


def _world(world, dims, octaves, backend, host_bricks, world_cache, cache_dir, device):
    """The world as ``bench.py:132-171`` gets it: ``(bm, bricks_host,
    key)``, ``bricks_host`` the host memory map of the raw bricks when they
    stay off the card (``bm.bricks`` is None then), else None."""
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.io.checkpoint import generate_or_load, load_world_host_bricks, save_world

    key = world_key(dims, octaves)

    def build():
        return build_brickmap_terrain_compact(dims, 32, octaves=octaves, device=device)

    t0 = time.perf_counter()
    bricks_host = None
    if host_bricks:
        # the 16k flow: the kernel reads only the brick LINES, so the raw
        # table stays on the host (a memory map of the disk cache) and only
        # the host-relaid lines are uploaded
        path = os.path.join(cache_dir, key + ".npz")
        if not os.path.exists(path):
            os.makedirs(cache_dir, exist_ok=True)
            built = build()
            _sync(device)
            log(f"one-time build of the {world} world: {time.perf_counter() - t0:.1f}s")
            save_world(path, built)
            del built
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        bm, bricks_host = load_world_host_bricks(path, device)
    elif world_cache:
        bm = generate_or_load(cache_dir, key, build, device)
    else:
        bm = build()
    _sync(device)
    where = (f"bricks {tuple(bm.bricks.shape)} ({bm.bricks.numel() * 4 / 1e9:.2f} GB on {device.type})"
             if bricks_host is None else
             f"bricks {bricks_host.shape} ({bricks_host.nbytes / 1e9:.2f} GB host-resident)")
    log(f"world {dims} compact build/load: {time.perf_counter() - t0:.1f}s; {where}")
    return bm, bricks_host, key


def _line_table(bm, bricks_host, key, cache_dir, device):
    """The line table (``line_table_or_build``) with its brick lines: a view
    of the bricks on the card, or host-relaid lines uploaded once."""
    from voxelengine_tpu_torch.io.checkpoint import line_table_or_build
    from voxelengine_tpu_torch.ops.bigtrace import host_brick_lines, materialize_brick_lines

    t0 = time.perf_counter()
    lt = line_table_or_build(cache_dir, key + "_lt1", bm)
    _sync(device)
    log(f"line table: {time.perf_counter() - t0:.1f}s; {lt.region_lines.numel() * 4 / 1e6:.1f} MB side tables, "
        f"{lt.num_regions} regions")
    t0 = time.perf_counter()
    if bricks_host is not None:
        lt = dataclasses.replace(lt, brick_lines=_upload(host_brick_lines(bricks_host), device))
    else:
        lt = materialize_brick_lines(bm, lt)
    _sync(device)
    log(f"brick lines: {time.perf_counter() - t0:.1f}s ({lt.brick_lines.numel() * 4 / 1e9:.2f} GB)")
    return lt


def macro_decision(bm, lt, cfg, o, d, key, cache_dir, origin_host, euler_host) -> bool:
    """``probe_use_macro`` on the frame's rays ``o``, ``d``, memoized on
    disk (``memo_json``) under every input of the probe: the world's
    ``key``, the resolution, the step budget and the camera."""
    from voxelengine_tpu_torch.io.checkpoint import memo_json
    from voxelengine_tpu_torch.render.frame import probe_use_macro

    pk = (f"{key}_macroprobe_v1_{cfg.width}x{cfg.height}_ms{cfg.max_steps}"
          f"_cam{'_'.join(str(float(v)) for v in origin_host)}_e{'_'.join(str(float(e)) for e in euler_host)}")
    return bool(memo_json(cache_dir, pk, lambda: probe_use_macro(bm, lt, o, d, cfg)))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resolve_device(device) -> torch.device:
    """The run's device: the card unless the caller names another; exit 3
    where there is none (no retry, no CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        log("FATAL: no CUDA device (torch.cuda.is_available() is false); the harness times the card and does not "
            "fall back to the CPU (pass device='cpu', or BENCH_ALLOW_CPU=1, for a sanity run there)")
        raise SystemExit(3)
    return dev


def run(
    world: str = "full",
    backend: str = "pallas",
    frames: int = 8,
    batches: int = 3,
    width: int = 1920,
    height: int = 1080,
    shadows: bool = False,
    ao: int = 0,
    reflect: bool = False,
    stage: int = 0,
    tail_frac: int = 8,
    automacro: bool = True,
    iters: bool = False,
    blocksort: bool = False,
    profile: str = "",
    world_cache: bool = True,
    cache_dir: str = ".world_cache",
    device=None,
    dims: Optional[Tuple[int, int, int]] = None,
    octaves: int = 32,
    camera_y: float = 380.0,
    euler: Tuple[float, float, float] = EULER,
    host_bricks: Optional[bool] = None,
) -> BenchRun:
    """One harness run (``bench.py:103-422``'s flow); each argument is the
    knob of the module doc that :func:`main` reads.  Beyond those: ``device``
    (default the card; exit 3 without one), ``cache_dir``, ``dims`` and
    ``octaves`` (another world under ``world``'s metric name: small test
    worlds), ``camera_y`` and ``euler`` (the camera's height, 380 on the
    bench worlds, and its Euler angles before the drift) and
    ``host_bricks`` (keep the raw bricks on the host; default: ``huge``
    with the ``pallas`` backend, as the JAX flow).  Raises ``SystemExit(4)``
    when the exactness gate fails."""
    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm, trace_brickmap_hbm_staged
    from voxelengine_tpu_torch.ops.trace import trace_brickmap
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table
    from voxelengine_tpu_torch.render.frame import (
        block_permutation_from_steps, make_framebuffer, primary_rays, render_frame,
    )

    if world not in WORLDS or backend not in BACKENDS:
        log(f"FATAL: unknown world {world!r} or backend {backend!r} (worlds {sorted(WORLDS)}, backends {BACKENDS})")
        raise SystemExit(2)
    if host_bricks is None:
        host_bricks = world == "huge" and backend == "pallas"
    if host_bricks and backend != "pallas":
        raise ValueError("host-resident bricks need the line table (backend 'pallas'): K4 reads the raw bricks")
    dev = _resolve_device(device)
    cuda = dev.type == "cuda"
    card = device_line(dev)
    log(f"device: {card}; torch {torch.__version__}")
    dims = tuple(dims or WORLDS[world])

    bm, bricks_host, key = _world(world, dims, octaves, backend, host_bricks, world_cache, cache_dir, dev)
    cfg = RenderConfig(width=width, height=height, checkerboard=True, tile_order=True, trace_stage_steps=stage,
                       trace_tail_frac=tail_frac, shadow_rays=shadows, ao_samples=ao, reflections=reflect)
    env = Environment.default(dev)
    origin_host = (dims[0] / 2, camera_y, dims[2] / 2)
    origin = torch.tensor(origin_host, dtype=torch.float32, device=dev)
    euler_host, euler = euler, torch.tensor(euler, dtype=torch.float32, device=dev)
    rays_per_frame = cfg.width * cfg.height // 2  # the checkerboard's half field

    lt = _line_table(bm, bricks_host, key, cache_dir, dev) if backend == "pallas" else None
    o, d, _, _, _ = primary_rays(cfg, origin, euler, 1)
    if lt is not None and automacro:
        # probe-informed macro selection: where the frame's rays never fire
        # a macro skip, the skip levels only cost, and results are the same
        # either way (the gate below checks every run); the decision is a
        # scene property, memoized on disk under every input of the probe
        t0 = time.perf_counter()
        use_macro = macro_decision(bm, lt, cfg, o, d, key, cache_dir, origin_host, euler_host)
        cfg = dataclasses.replace(cfg, trace_use_macro=use_macro)
        log(f"macro probe: use_macro={use_macro} ({time.perf_counter() - t0:.1f}s)")

    def frame_trace(origins, dirs):
        """The trace the frames take for primary rays (``shade_pixels``)."""
        if lt is None:
            return trace_brickmap_no_table(bm, origins, dirs, cfg.max_steps)
        if cfg.trace_stage_steps:
            return trace_brickmap_hbm_staged(bm, lt, origins, dirs, cfg.max_steps, stage_steps=cfg.trace_stage_steps,
                                             tail_frac=cfg.trace_tail_frac, use_macro=cfg.trace_use_macro)
        return trace_brickmap_hbm(bm, lt, origins, dirs, cfg.max_steps, use_macro=cfg.trace_use_macro)

    fb = make_framebuffer(cfg, dev)
    t0 = time.perf_counter()
    render_frame(bm, fb, origin, euler, env, 0, cfg, lt)
    _sync(dev)
    log(f"first frame (kernel loads + run): {time.perf_counter() - t0:.2f}s")

    # the probe trace: the gate's kernel result, and the block permutation
    got = frame_trace(o, d)
    if iters and lt is not None:
        _, it = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=cfg.trace_use_macro, return_iters=True)
        # on the card a ray reports its warp's loop count: one value a warp
        it = (it[::32] if cuda else it).double().cpu().numpy()
        st = got.steps.long()
        log(f"{'warp' if cuda else 'ray'} iters: mean {it.mean():.0f} p50 {np.percentile(it, 50):.0f} "
            f"p90 {np.percentile(it, 90):.0f} p99 {np.percentile(it, 99):.0f} max {it.max():.0f} sum {it.sum():.0f}  "
            f"steps-sum {int(st.sum())} perfect {int(st.sum()) // (32 if cuda else 1)}")
    perm = None
    if blocksort:
        perm = block_permutation_from_steps(got.steps, cfg)
        t0 = time.perf_counter()
        render_frame(bm, fb, origin, euler, env, 0, cfg, lt, perm)
        _sync(dev)
        log(f"block-sorted frame: {time.perf_counter() - t0:.2f}s")

    # chained frames: frame k+1 renders into frame k's framebuffer; every
    # frame is distinct (frame number, and a 1e-5 rad a frame camera drift)
    drift = torch.tensor(1e-5, dtype=torch.float32, device=dev)

    def batch(first, count):
        """``(ms a frame on the device, ms a frame on the host clock)`` of
        ``count`` chained frames from frame ``first``: CUDA events on the
        card (the host clock on the CPU)."""
        start = end = None
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(first, first + count):
            render_frame(bm, fb, origin, euler + drift * i, env, i, cfg, lt, perm)
        if cuda:
            end.record()
            end.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / count
        return (start.elapsed_time(end) / count if cuda else wall), wall

    warm = min(3, frames)
    log(f"warm-up ({warm} frames): {batch(1, warm)[0]:.3f} ms/frame")
    first = warm + 1
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with torch_profile(activities=activities) as prof:
            ms, wall = batch(first, frames)
        os.makedirs(profile, exist_ok=True)
        trace_path = os.path.join(profile, f"bench_{world}_{backend}.json")
        prof.export_chrome_trace(trace_path)
        times, walls = [ms], [wall]
        log(f"profiler trace of the timed batch written to {trace_path}")
    else:
        times, walls = [], []
        for _ in range(batches):
            ms, wall = batch(first, frames)
            times.append(ms)
            walls.append(wall)
            first += frames
    frame_ms = min(times)
    log("batches: " + " ".join(f"{t:.4f}" for t in times) + f" ms/frame ({'CUDA events' if cuda else 'host clock'});"
        " host wall " + " ".join(f"{w:.4f}" for w in walls) + " ms/frame")
    log(f"frame checksum {float(fb.double().sum()):.6f}")
    mrays = rays_per_frame / frame_ms / 1000.0

    # exactness gate: the frame's trace must give the plain full-budget
    # walk's hits on a full frame of rays
    if bricks_host is not None:
        # phase swap: drop the brick lines, upload the raw bricks for the
        # plain walk (the two never sit on the card together)
        lt = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        bm = dataclasses.replace(bm, bricks=_upload(bricks_host, dev))
        _sync(dev)
        log(f"bricks uploaded for the gate: {time.perf_counter() - t0:.1f}s")
    ref = trace_brickmap(bm, o, d, cfg.max_steps)
    diffs = int((ref.hit != got.hit).sum())
    steps = got.steps.double()
    log(f"frame: {frame_ms:.4f} ms ({1000 / frame_ms:.2f} FPS)  hit-rate {float(ref.hit.float().mean()):.3f}  "
        f"{backend}-vs-plain hit diffs {diffs}/{steps.numel()}  steps mean {float(steps.mean()):.1f} "
        f"p99 {float(torch.quantile(steps.cpu(), 0.99)):.0f}")
    if diffs > steps.numel() // 10000:
        # a fast wrong traversal is no result: fail before the JSON line
        log(f"FATAL: hit diffs above 0.01% tolerance ({diffs}/{steps.numel()})")
        raise SystemExit(4)
    record = {
        "metric": metric_name(world, cfg.height, shadows, ao, reflect),
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / 1000.0, 6),
        "n_batches": len(times),
        "batch_ms": [round(t, 4) for t in times],
        "device": card,
    }
    return BenchRun(record, fb, diffs)


def _flag(env, name: str) -> bool:
    return env.get(name, "0") == "1"


def main(environ=None) -> int:
    """Read the knobs from ``environ`` (default ``os.environ``), run, print
    the JSON line; returns the exit code (:func:`run` raises ``SystemExit``
    with 3 or 4)."""
    env = os.environ if environ is None else environ
    tpu_only = [k for k in TPU_ONLY_KNOBS if k in env]
    if tpu_only:
        log("FATAL: " + "; ".join(f"{k} ({TPU_ONLY_KNOBS[k]})" for k in tpu_only)
            + " tune only the JAX harness's TPU path and have no counterpart in the port; unset them")
        return 2
    res = run(
        world=env.get("BENCH_WORLD", "full"),
        backend=env.get("BENCH_BACKEND", "pallas"),
        frames=int(env.get("BENCH_FRAMES", "8")),
        batches=int(env.get("BENCH_BATCHES", "3")),
        width=int(env.get("BENCH_W", "1920")),
        height=int(env.get("BENCH_H", "1080")),
        shadows=_flag(env, "BENCH_SHADOWS"),
        ao=int(env.get("BENCH_AO", "0")),
        reflect=_flag(env, "BENCH_REFLECT"),
        stage=int(env.get("BENCH_STAGE", "0")),
        tail_frac=int(env.get("BENCH_TAILFRAC", "8")),
        automacro=env.get("BENCH_AUTOMACRO", "1") == "1",
        iters=_flag(env, "BENCH_ITERS"),
        blocksort=_flag(env, "BENCH_BLOCKSORT"),
        profile=env.get("BENCH_PROFILE", ""),
        world_cache=env.get("BENCH_WORLD_CACHE", "1") == "1",
        device="cpu" if _flag(env, "BENCH_ALLOW_CPU") else None,
    )
    print(json.dumps(res.record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
