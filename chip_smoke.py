#!/usr/bin/env python3
"""Drive the PyTorch port's render paths once on an NVIDIA GPU.

    python3 chip_smoke.py   # all phases, the 8192x512x8192 bench world included

Phases, one stdout line each (plus the kernels' build logs):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every CUDA kernel (K1-K5, W1) from
   ``voxelengine_tpu_torch/csrc``, one nvcc per source, all started
   together; ptxas registers and spills of each instantiation;
3. noise: worldgen noise on the card against ``native/golden_noise.json``,
   and W1's noise (``csrc/noise.cuh`` through its noise probe) against the
   golden values and the plain torch noise on random points, bit for bit;
4. kernel vs plain: K1 (macro levels on and off) against its plain versions
   on a 128x64x128 terrain built on the card and on a random world whose
   chunk grid is not a multiple of 8 (hits, steps, normals bit-equal;
   positions equal on hits), and a small frame rendered through K1 against
   the plain path; then W1 against its plain version (the plain
   ``solid_at`` slab reduced by ``_slab_to_chunks``) on the first, a middle
   and the last slab of the bench world and of a 256x128x256 world at
   factors 8, 16 and 32 in each brick layout, the compact build of a 256^3
   world through both, and W1 and its plain version timed on the bench
   world's middle slab;
5. main path, as ``bench.py:103-422`` runs it, on the 1024^3 demo world
   (1280x720) and on the 8192x512x8192 bench world (1920x1080): the world
   built through W1 (on the bench world through ``generate_or_load`` into
   a temporary cache, then loaded back from it, which must give the same
   tables, and the line table through ``line_table_or_build``), its line
   table and brick lines; ``probe_use_macro`` on the frame's rays (through
   ``memo_json`` on the bench world), ``cfg.trace_use_macro`` set from it;
   a warm-up plus 8 chained checkerboard frames through ``render_frame(...,
   lt=lt)``; then the exactness gate (K1 against its plain version on the
   full frame of rays, 0 diffs allowed; the count against the
   chunk-by-chunk walk printed too), the phase counters and the
   ``return_iters`` warp-iteration statistics;
6. times on each world: K1 (macro off and on), K5 at each refill and the
   plain trace on that frame's rays, with CUDA events; K5's lanes-active
   share at each refill (its counting instantiation) beside K1's;
7. dense kernels vs plain: K2 and K3 against the plain ``trace_grid`` on a
   random 32^3 grid in each layout, and a 96x64 ``render_frame_dense``
   frame through K2 against the plain path;
8. dense path at the JAX package's config-2 size (``apps/bench_configs.py``):
   a 64^3 terrain from ``generate_world``, its 1024x1024 ray batch through
   K2 (``trace_grid_vpu``), K3 (``trace_grid_mxu``, its shared-memory
   instantiation) and the plain trace, then a warm-up plus 8 chained
   1280x720 checkerboard ``render_frame_dense`` frames and the exactness
   gate on the last frame; the CUDA kernels one dense frame, one
   ``trace_grid_vpu`` call (K2 alone) and one ``trace_grid_mxu`` call (the
   planes' copy and K3) launch (``torch.profiler``); K3's global
   instantiation on a random 128^3 grid (256 KB of words) against the plain
   trace; K2 timed on the batch and on the last frame's 460,800 rays, K3 in
   both instantiations on the batch;
9. on-chip brickmap: K4 (``trace_brickmap_mxu``) against the plain trace on
   1,048,576 rays over a 128^3 terrain at factor 8 and on a small
   TILED_MORTON world (meta in shared memory), and on 65,536 rays over a
   random 512x256x512 world at factor 8 whose 512 KB of meta exceed
   shared memory (K4's global-meta instantiation); times, K4 also on the
   128^3 rays sorted by direction octant, then start chunk;
10. sparse world: the 16384x512x16384 world at factor 32 of
   ``tests/test_pallas_bigtrace.py:500-531`` (512x16x512 chunks, 8192
   regions, L2 and L3 real), 262,144 near, horizon and sky rays: K1 macro
   off, K1 macro on and K5 (``trace_brickmap_hbm_rr``) each against its
   plain version and K1 against K5 (0 diffs), the phase counters (``mskip``
   must be > 0) against the plain walk's; times, K5 at each refill, and
   K5's lanes-active share beside K1's;
11. the app's frame (``apps/voxel_app.py`` at its default size): the 1024^3
   world at factor 32 with dense slots built through W1
   (``build_brickmap_terrain``), its ``compact_brickmap`` against
   ``build_brickmap_terrain_compact``; ``VoxelRaytracer3D(line_table=True)``
   and ``Graphics(1280, 720, tile_order, shadows, AO 4, reflections)``: a
   warm-up plus 8 ``render_screen`` frames (K1 7 times a frame); on the next
   frame each trace batch (primary, shadow, reflection, 4 AO) through K1
   against its plain version on all rays and on the primary hits, the frame
   against the same frame through plain traces, each debug view, a block
   permutation, a 1280x719 frame and an orthographic zoom; 64 edits through
   ``edit_voxels`` (a crosshair break and place, 62 random) against
   ``apply_edits`` on a copy and a rebuilt line table, a frame after them,
   and the edit latency at K=1 and K=64; 1,048,576 random rays through
   ``raytrace`` (K1) and through a 128^3 TILED_LINEAR world's (K4), every
   ``RayTraceResults`` field against the plain walk, and a frame through K4;
12. the single-device remainder: every noise of ``ops/noise.py`` beyond
   the worldgen subset on the card against the CPU on 65,536 points; K1
   (``trace_brickmap_2d``) and K2 (``trace_grid_2d``) on
   ``tests/test_dda2d.py``'s 64^2 world (and its two-level against
   single-level property) and on the 2D demo's 512^2 world at factor 8
   with 1,000,000 radial rays, against the plain walk; the record
   instantiation of K1's loop (``csrc/crossings.cu``) against its plain
   version on 32 rays of the demo world and of the sparse 16k world, macro
   on and off, its results against K1's; the ported app
   (``voxelengine_tpu_torch/apps/voxel_app.py``) headless under a scripted
   input ('f', 'g', 'b', a drag, a scroll; 24 frames) with its default
   flags plus ``--shadows --ao 4 --reflections``, then ``--dense`` (128^3),
   ``--xla-trace`` and ``--macro auto``, its edits against ``apply_edits``
   on a copy of the cached world; the 2D demo and ``bench_configs``
   (configs 1, 2, 3, 5).  Frames and caches go to a temporary directory
   under ``_checkout/``, removed at the end.

Each kernel's path (the bench world's frames for K1, and the demo world's
for its second record; the bench world's build for W1; the frames of
phase 8 for K2, the phase-8 batch for K3 and the 128^3 grid for its global
instantiation, the phase-9 128^3 batch for K4 with shared meta and its
512x256x512 batch for K4 with global meta, the phase-10 batch for K5; the
phase-11 frames for K1 with secondary rays, its ``raytrace`` for K1 on a
batch, its TILED_LINEAR world's ``raytrace`` and frame for K4; the 2D demo for
K1 on a 2D world, one ``trace_grid_2d`` call for K2 on it, one
``trace_ray_crossings`` for the record kernel) runs
with the launch counts set to 0 just before it and read just after;
launches made to compare or time a kernel are not counted.  Then the run's
wall time, one JSON line describing each kernel (its time, its plain
version's, and its bound: the larger of its bytes (rays in and out plus
the table words its hits need; W1's output) over the card's memory rate
and its operations over its float32 rate; with the macro levels on, the
operations of the DDA events the diag build counts, since a macro skip
charges steps it never walks; for K2 and K3 the bytes of their wrappers'
whole function, origins and raw directions in, the hit byte, position,
normal and steps out; for W1 the operations a voxel counted from its
source, :func:`w1_ops_per_voxel`), the card line again, and last
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0)
before the last line.  Needs one CUDA device; there is no CPU fallback.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAMES = 8  # timed chained frames after the warm-up
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1, K4 and K5 read start, dir, pad (12 B each) and active (4 B) and write
# flags, steps (4 B each), position and normal (12 B each) per ray
RAY_BYTES = 72
# K2 and K3 read origins and raw directions (f32[N, 3] each, fewer bytes
# where the origin is one row broadcast) and write hit (1 B), position,
# normal (12 B each) and steps (4 B) per ray
GRID_OUT_BYTES = 29
# float ops of one DDA step: the axis pick (3 compares), the two entry
# coordinates off the stepped axis (2 mul + 2 add), the tMax add; ray setup
# and the coarse level's box test are not counted
OPS_PER_STEP = 8
# the DDA events a run executes (diag counters): each one iteration of work
EVENTS = ("mskip", "cadv", "desc", "fstep", "step2", "asc")
SPARSE_RAYS = 1 << 18
# threads a block of each library's kernels (csrc/*.cu)
BLOCK_THREADS = {"bigtrace": 128, "rrtrace": 128, "gridtrace": 128, "bmtrace": 1024, "terrain": 256, "crossings": 32}
# the app's frame (apps/voxel_app.py:64-68,178-188): the 1024^3 world at
# factor 32, 1280x720, shadows, AO 4, reflections; the facade's batch size
APP_WORLD = (1024, 1024, 1024)
APP_SIZE = (1280, 720)
APP_AO = 4
APP_CAMERA_Y = 380.0  # the main path's camera height (bench.py:191-192)
APP_ORTHO = (200.0, 120.0)  # set_ortho_window_size of the phase's orthographic frame
FACADE_RAYS = 1 << 20
K5_REFILLS = (32, 16, 8, 4, 1)  # K5's idle lanes at which a warp refills (its default is rrtrace.REFILL)
OCTAVES = 32  # the reference's terrain (VoxelWorldBuilder.cu:6)
# W1 against its plain version: a world small enough for every factor and
# brick layout (beside the bench world's slabs), and the compact build
W1_WORLD = (256, 128, 256)
W1_BUILD_WORLD = (256, 256, 256)
WORLDS = {
    # (world dims, width, height): the reference demo (main.cu:15-23) and
    # the bench world (bench.py:127-129) at 1080p
    "demo": ((1024, 1024, 1024), 1280, 720),
    "full": ((8192, 512, 8192), 1920, 1080),
}


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int = 1) -> float:
    """Mean device time of ``fn()`` over ``repeats`` runs, by CUDA events,
    after one untimed run (a kernel's first launch also loads it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def bound(rays: int, table_bytes: int, work: int, ray_bytes: float = RAY_BYTES):
    """``(bound_ms, bound_by)``: the larger of the bytes the trace must move
    (``ray_bytes`` a ray in and out, and the ``table_bytes`` its hits need,
    see :func:`hit_table_bytes`) over the memory rate and the float
    operations of its ``work`` DDA steps (or executed events) over the
    float32 rate."""
    bytes_ms = (rays * ray_bytes + table_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = work * OPS_PER_STEP / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def hit_voxels(out, world_dims):
    """``int64[H, 3]``: the voxel each hit ray of ``out`` ended in, the cell
    its last step entered (``floor(position + normal / 2)``, normals in the
    step-sign convention), clamped into the world."""
    import torch

    h = out.hit
    v = torch.floor(out.position[h] + 0.5 * out.normal[h]).long()
    return torch.minimum(v.clamp_min(0), torch.tensor(world_dims, device=v.device) - 1)


def hit_table_bytes(out, world_dims, layout, factor=None, wpb=None):
    """Table bytes a correct trace must read to produce ``out``'s hits: the
    4-byte word that holds each distinct hit voxel and, for a brickmap
    (``factor`` given), each distinct hit chunk's 4-byte coarse entry.  The
    empty cells and chunks a ray passes on its way are not counted, so this
    is a lower bound on what the rays touch."""
    import torch

    from voxelengine_tpu_torch.core.layout import sample_index

    v = hit_voxels(out, world_dims)
    X, Y, _ = world_dims
    if factor is None:  # dense grid: the word of the voxel's bit
        return 4 * int(torch.unique(sample_index(v[:, 0], v[:, 1], v[:, 2], X, Y, layout) >> 5).numel())
    c, fine = v // factor, v % factor
    gx, gy = X // factor, Y // factor
    chunk = c[:, 0] + c[:, 1] * gx + c[:, 2] * gx * gy
    word = sample_index(fine[:, 0], fine[:, 1], fine[:, 2], factor, factor, layout) >> 5
    return 4 * (int(torch.unique(chunk * wpb + word).numel()) + int(torch.unique(chunk).numel()))


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, rays, table_bytes, steps_sum,
                 events_sum=None, ray_bytes=RAY_BYTES, **extra):
    """One kernel's record for the ``kernels`` JSON line.  The bound's
    operations count ``events_sum`` (the executed DDA events) where given,
    else ``steps_sum``; ``extra`` keys are added as they are."""
    bound_ms, bound_by = bound(rays, table_bytes, steps_sum if events_sum is None else events_sum, ray_bytes)
    return {
        "name": name, "route": "cuda", "source": f"voxelengine_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no PyTorch call computes a DDA traversal
        "rays": rays, "ray_bytes": ray_bytes, "steps_sum": steps_sum, "events_sum": events_sum,
        "table_bytes": table_bytes, **extra,
    }


def grid_ray_bytes(origins, rays) -> float:
    """Bytes a ray that K2 or K3 must move: the distinct float32 data of
    ``origins`` and ``rays`` (a broadcast origin counts once) over the rays,
    plus :data:`GRID_OUT_BYTES`."""
    def data_bytes(t):
        return 4 * math.prod(size for size, stride in zip(t.shape, t.stride()) if stride != 0)
    return GRID_OUT_BYTES + (data_bytes(origins) + data_bytes(rays)) / rays.shape[0]


def kernel_profile(fn, calls: int = 1):
    """``(names, ms)``: the CUDA kernels ``calls`` runs of ``fn()`` launch
    (memory copies and sets excluded) and the device time of each, by
    ``torch.profiler``; ``(None, None)`` where the profiler records no
    device activity.  A short kernel's own time: CUDA events around a
    host-bound call also time the card's idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return None, None
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    return [e.name for e in kernels], [e.time_range.elapsed_us() / 1e3 for e in kernels]


def phase_build():
    from voxelengine_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.KERNEL_SOURCES)) as pool:  # one nvcc per source, all started together
        list(pool.map(build.load_kernel, build.KERNEL_SOURCES))
    libs = {name: build.kernel_library(name) for name in build.KERNEL_SOURCES}  # built: only hashes
    say(f"build: {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc per source, in parallel)")
    for name, lib in libs.items():
        entry = ""
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say(f"build:   {name}: {line.strip()}")
            entry = line if "Compiling entry" in line else entry
            m = re.search(r"Used (\d+) registers", line)
            if m:
                # K3's staged instantiation picks 256 or 1024 threads at launch; 256 shown
                threads = 256 if "staged" in entry else BLOCK_THREADS[name]
                warps = resident_warps(int(m.group(1)), threads)
                say(f"build:   {name}: {m.group(1)} registers at {threads} threads a block: "
                    f"at most {warps} resident warps an SM (of 64)")


def resident_warps(regs: int, threads: int) -> int:
    """Warps an H100 SM holds of a kernel with ``regs`` registers a thread
    and ``threads`` a block, as its 65,536 registers allow (allocated per
    warp in units of 8 registers a thread; at most 32 blocks, 64 warps)."""
    per_block = -(-regs // 8) * 8 * threads
    return min(64, min(32, 65536 // per_block) * threads // 32)


def phase_noise(dev):
    import numpy as np
    import torch

    from voxelengine_tpu_torch.ops import noise as N
    from voxelengine_tpu_torch.worldgen.terrain import terrain_density

    g = json.loads((ROOT / "native" / "golden_noise.json").read_text())
    seeds = torch.tensor([0, 1, 42, 0x71889283, 0xFFFFFFFF, 123456789], dtype=torch.int64, device=dev)
    coords = torch.tensor(
        [[0.1, 0.2, 0.3], [1.5, 2.5, 3.5], [10, 20, 30], [0.005, 0, 0], [100.7, 3.3, 77.77]],
        dtype=torch.float32, device=dev,
    )
    exact = {
        "hash": (N.hash_u32(seeds).cpu().numpy().astype(np.uint32), np.array(g["hash"], np.uint32)),
        "random_float": (N.random_float(seeds).cpu().numpy(), np.array(g["random_float"], np.float32)),
        "perlin": (N.perlin_noise(coords, 1.0, 1040580316).cpu().numpy(), np.array(g["perlin"], np.float32)),
    }
    ar = torch.arange(4, device=dev) * 37
    z, y, x = torch.meshgrid(ar, ar, ar, indexing="ij")
    tol = {  # tests/test_noise.py:58,75
        "repeater_perlin": (
            N.repeater_perlin(coords, 1.0, 0x71889283, 32, 2.0, 0.5).cpu().numpy(),
            np.array(g["repeater_perlin"], np.float32), 3e-6, 3e-7,
        ),
        "terrain_t": (
            terrain_density(x, y, z).reshape(-1).cpu().numpy(),
            np.array(g["terrain_t"], np.float32), 3e-6, 1e-4,
        ),
    }
    bad = [k for k, (a, b) in exact.items() if not np.array_equal(a, b)]
    bad += [k for k, (a, b, rt, at) in tol.items() if not np.allclose(a, b, rtol=rt, atol=at)]
    n_exact = sum(np.array_equal(a, b) for a, b, _, _ in tol.values())
    say(f"noise: against native/golden_noise.json (hash/random_float/perlin bit-exact, "
        f"repeater_perlin/terrain_t at tests/test_noise.py's tolerance): mismatches {bad or 'none'}; "
        f"repeater_perlin/terrain_t {n_exact}/2 bit-exact")
    if bad:
        raise SystemExit(f"noise mismatch against native/golden_noise.json: {bad}")
    phase_w1_noise(dev, g, coords)


def phase_w1_noise(dev, g, coords):
    """W1's noise (``csrc/noise.cuh`` through the noise probe of
    ``csrc/terrain.cu``) against the golden values and, on random points,
    the plain torch noise on the card: bit for bit (float bit patterns)."""
    import numpy as np
    import torch

    from voxelengine_tpu_torch.kernels import terrain as W
    from voxelengine_tpu_torch.ops import noise as N
    from voxelengine_tpu_torch.worldgen.terrain import solid_at, terrain_density

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    seeds = np.array([0, 1, 42, 0x71889283, 0xFFFFFFFF, 123456789], np.uint32)
    s32 = torch.from_numpy(seeds.view(np.int32)).to(dev)
    a = np.arange(4) * 37
    z, y, x = np.meshgrid(a, a, a, indexing="ij")
    lattice = torch.from_numpy(np.stack([x.ravel(), y.ravel(), z.ravel()], -1).astype(np.int32)).to(dev)
    golden = {
        "hash": (W.noise_points("hash", s32), np.array(g["hash"], np.uint32).astype(np.int64)),
        "random_float": (W.noise_points("random_float", s32), np.array(g["random_float"], np.float32)),
        "perlin": (W.noise_points("perlin", coords, seed=1040580316), np.array(g["perlin"], np.float32)),
        "repeater_perlin": (W.noise_points("repeater_perlin", coords, octaves=32),
                            np.array(g["repeater_perlin"], np.float32)),
        "terrain_t": (W.noise_points("terrain_t", lattice, octaves=32), np.array(g["terrain_t"], np.float32)),
    }
    bad = [k for k, (got, want) in golden.items() if not np.array_equal(got.cpu().numpy(), want)]
    rng = np.random.default_rng(3)
    n = 1 << 16
    pos = torch.from_numpy((rng.random((n, 3)) * 200 - 100).astype(np.float32)).to(dev)
    vox = np.stack([rng.integers(0, 8192, n), rng.integers(0, 512, n), rng.integers(0, 8192, n)], -1)
    vox = torch.from_numpy(vox.astype(np.int32)).to(dev)
    vx, vy, vz = vox.long().unbind(-1)
    u = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32)).to(dev)
    plain = {
        "hash": (W.noise_points("hash", u), N.hash_u32(u)),
        "random_float": (W.noise_points("random_float", u), N.random_float(u)),
        "perlin seed -5": (W.noise_points("perlin", pos, seed=-5), N.perlin_noise(pos, 1.0, -5)),
    }
    for oc in (8, 32):
        plain[f"repeater_perlin {oc} octaves"] = (W.noise_points("repeater_perlin", pos, octaves=oc),
                                                  N.repeater_perlin(pos, 1.0, 0, oc, 2.0, 0.5))
        plain[f"terrain_t {oc} octaves"] = (W.noise_points("terrain_t", vox, octaves=oc),
                                            terrain_density(vx, vy, vz, octaves=oc))
        plain[f"solid {oc} octaves"] = (W.noise_points("solid", vox, octaves=oc), solid_at(vx, vy, vz, octaves=oc))
    diffs = {k: int((bits(got) != bits(want)).sum()) for k, (got, want) in plain.items()}
    say(f"noise: W1's noise (csrc/noise.cuh) against native/golden_noise.json, bit-exact on all five: mismatches "
        f"{bad or 'none'}; against the plain torch noise on the card on {n} random points each (bit patterns): "
        f"diffs {json.dumps(diffs)}")
    if bad or any(diffs.values()):
        raise SystemExit(f"W1's noise disagrees: golden {bad}, plain {diffs}")


def events_ms(fn):
    """``(fn(), ms)``: one run of ``fn`` timed by CUDA events (for runs too
    long to repeat)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def chunk_diffs(got, want):
    """``{field: elements that differ}`` of two ``_slab_to_chunks`` results."""
    return {k: int((a != b).sum()) for k, a, b in zip(("occ", "bmin", "bmax", "words"), got, want)}


def phase_terrain(dev):
    """W1 against its plain version (the plain ``solid_at`` slab reduced by
    ``_slab_to_chunks``) on the first, a middle and the last z-slab of the
    bench world and of a 256x128x256 world at factors 8, 16 and 32 in each
    brick layout, and the compact build of a 256^3 world through W1 and
    through the plain path; W1 and its plain version timed on the bench
    world's middle slab.  Returns the parts of W1's record measured here."""
    import torch

    from voxelengine_tpu_torch.core.brickmap import (
        build_brickmap_terrain_compact,
        terrain_slab_chunks_plain,
    )
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.kernels import terrain as W

    cases = [(WORLDS["full"][0], 32, Layout.TILED_LINEAR)]
    cases += [(W1_WORLD, f, lay) for f in (8, 16, 32) for lay in Layout]
    total = {}
    for dims, f, lay in cases:
        gz = dims[2] // f
        for z0 in (0, gz // 2 * f, (gz - 1) * f):
            got = W.terrain_slab(z0, dims, f, lay, OCTAVES, dev)
            want, ms = events_ms(lambda: terrain_slab_chunks_plain(z0, dims, f, lay, OCTAVES, device=dev))
            d = chunk_diffs(got, want)
            total = {k: total.get(k, 0) + v for k, v in d.items()}
            if any(d.values()):
                raise SystemExit(f"W1 vs plain, {dims} f{f} {lay.name} slab z0={z0}: diffs {d}")
            if dims == WORLDS["full"][0] and z0 == gz // 2 * f:
                mid, plain_ms, occupied = (z0, dims, f, lay), ms, int(want[0].sum())
    say(f"terrain: W1 vs plain solid_at + _slab_to_chunks (tolerance: equal) on the first, a middle and the last "
        f"z-slab of {WORLDS['full'][0]} f32 and of {W1_WORLD} at factors 8/16/32 in each brick layout "
        f"({3 * len(cases)} slabs): diffs {json.dumps(total)}")

    t0 = time.perf_counter()
    a = build_brickmap_terrain_compact(W1_BUILD_WORLD, 32, octaves=OCTAVES, device=dev)
    torch.cuda.synchronize()
    t_w1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = build_brickmap_terrain_compact(W1_BUILD_WORLD, 32, octaves=OCTAVES, device=dev,
                                       chunks_fn=terrain_slab_chunks_plain)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    d = {k: int((getattr(a, k) != getattr(b, k)).sum()) if getattr(a, k).shape == getattr(b, k).shape else "shape"
         for k in ("meta", "brick_idx", "bricks")}
    say(f"terrain: compact build of {W1_BUILD_WORLD} f32 through W1 ({t_w1:.2f} s) vs through the plain path ({t_plain:.2f} s), "
        f"{a.bricks.shape[0]} bricks: diffs {json.dumps(d)}")
    if any(d.values()):
        raise SystemExit(f"the compact build through W1 differs from the plain path: {d}")

    z0, dims, f, lay = mid
    ms = cuda_ms(lambda: W.terrain_slab(z0, dims, f, lay, OCTAVES, dev), repeats=3)
    gx, gy, wpb = W.slab_shape(dims, f, lay)
    voxels = dims[0] * dims[1] * f
    out_bytes = gx * gy * (1 + 24 + 4 * wpb)
    bytes_ms = out_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = voxels * w1_ops_per_voxel(OCTAVES) / F32_OPS_PER_S * 1e3
    say(f"times: W1 {ms:.3f} ms, plain solid_at + _slab_to_chunks {plain_ms:.1f} ms on the slab z0={z0} of "
        f"{dims} f{f} ({voxels} voxels, {gx * gy} chunks, {occupied} occupied); bound {max(bytes_ms, ops_ms):.3f} ms "
        f"({w1_ops_per_voxel(OCTAVES)} ops a voxel over {F32_OPS_PER_S:.3g} op/s), on {card_line()}")
    return {
        "name": "terrain_slab", "route": "cuda", "source": "voxelengine_tpu_torch/csrc/terrain.cu",
        "replaces": "voxelengine_tpu/core/brickmap.py:284 build_brickmap_terrain_compact (XLA under jax.jit, "
                    "not a pallas_call: a port kernel with no TPU counterpart)",
        "launches": None, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no PyTorch call computes Perlin terrain
        "voxels": voxels, "ops_per_voxel": w1_ops_per_voxel(OCTAVES), "out_bytes": out_bytes,
    }


def w1_ops_per_voxel(octaves: int) -> int:
    """W1's operations a voxel, counted from ``csrc/noise.cuh`` and
    ``csrc/terrain.cuh`` (integer and float alike): an octave is the seed
    (2), the octave's position (3), perlin's scale, floor and fraction (9),
    three fades (21), eight corners of 60 (3 adds, the grid seed's 3 mul and
    4 adds, the saturating conversion 3, the hash 18, grad 26, the corner
    offset 3), seven lerps (28), the accumulate and the scale and amplitude
    updates (4) and the loop (2): 549; outside the octaves the coordinates,
    the threshold and the compare, the brick layout's inverse and the ballot
    and bounds, ~40."""
    return 549 * octaves + 40


def random_brickmap(dims, factor, fill, seed, dev):
    """A dense-slot brickmap of random voxels over a floor, built on ``dev``."""
    import torch

    from voxelengine_tpu_torch.core.brickmap import BrickMap, _slab_to_chunks, pack_meta
    from voxelengine_tpu_torch.core.layout import Layout

    X, Y, Z = dims
    f = factor
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = torch.rand((Z, Y, X), generator=gen, device=dev) < fill
    dense[:, :4, :] = torch.rand((Z, 4, X), generator=gen, device=dev) < 0.5
    parts = [_slab_to_chunks(dense[z0:z0 + f], f, Y // f, X // f, Layout.TILED_LINEAR) for z0 in range(0, Z, f)]
    occ, bmn, bmx, words = (torch.cat(p) for p in zip(*parts))
    n = occ.shape[0]
    return BrickMap(
        meta=pack_meta(occ, bmn.clamp_min(0), bmx.clamp_min(0)),
        brick_idx=torch.arange(n, dtype=torch.int32, device=dev),
        bricks=words, grid_dims=(X // f, Y // f, Z // f), factor=f,
        coarse_layout=Layout.LINEAR, brick_layout=Layout.TILED_LINEAR, dense_slots=True,
    )


def random_rays(dims, n, spread, seed, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.tensor(dims, dtype=torch.float32, device=dev)
    o = torch.rand((n, 3), generator=gen, device=dev) * w * spread - w * (spread - 1) / 2
    t = torch.rand((n, 3), generator=gen, device=dev) * w
    return o, t - o


def compare(got, want):
    """(hit diffs, steps diffs, normal diffs on hits, position diffs on hits,
    max abs position/normal error on hits) of two TraceOuts."""
    h = got.hit & want.hit
    perr = (got.position[h] - want.position[h]).abs()
    nerr = (got.normal[h] - want.normal[h]).abs()
    err = torch_max(perr, nerr)
    return (
        int((got.hit != want.hit).sum()),
        int((got.steps != want.steps).sum()),
        int((nerr != 0).any(dim=1).sum()),
        int((perr != 0).any(dim=1).sum()),
        err,
    )


def torch_max(*ts):
    """Largest element over tensors that may be empty (0.0 if all are)."""
    return max([float(t.max()) for t in ts if t.numel()] + [0.0])


def phase_kernel_vs_plain(dev):
    import torch

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.ops.bigtrace import (
        make_line_table,
        materialize_brick_lines,
        trace_brickmap_hbm,
        trace_brickmap_lt,
    )
    from voxelengine_tpu_torch.ops.trace import trace_brickmap
    from voxelengine_tpu_torch.render.frame import make_framebuffer, render_frame

    worlds = {
        "terrain 128x64x128 f32": (build_brickmap_terrain_compact((128, 64, 128), 32, device=dev), 1.5, 512),
        "random 72x40x88 f8 (grid 9x5x11)": (random_brickmap((72, 40, 88), 8, 0.02, 5, dev), 3.0, 256),
    }
    for i, (name, (bm, spread, max_steps)) in enumerate(worlds.items()):
        o, d = random_rays(bm.world_dims, 65536, spread, 100 + i, dev)
        lt = materialize_brick_lines(bm, make_line_table(bm))
        for use_macro, plain in ((False, trace_brickmap(bm, o, d, max_steps)),
                                 (True, trace_brickmap_lt(bm, lt, o, d, max_steps))):
            got = trace_brickmap_hbm(bm, lt, o, d, max_steps, use_macro=use_macro)
            check_diffs(f"kernel vs plain: K1 macro {'on' if use_macro else 'off'}, {name}", compare(got, plain),
                        o.shape[0], int(plain.hit.sum()))

    bm, _, _ = worlds["terrain 128x64x128 f32"]
    lt = materialize_brick_lines(bm, make_line_table(bm))
    cfg = RenderConfig(width=160, height=96, checkerboard=True, tile_order=True, max_steps=512)
    env = Environment.default(dev)
    origin = torch.tensor([64.0, 60.0, 64.0], device=dev)
    euler = torch.tensor([-0.3, 0.75, 0.0], device=dev)
    a = render_frame(bm, make_framebuffer(cfg, dev), origin, euler, env, 1, cfg, lt=lt)
    b = render_plain(bm, make_framebuffer(cfg, dev), origin, euler, env, 1, cfg, trace_brickmap)
    n = int((a != b).any(dim=-1).sum())
    say(f"kernel vs plain: 160x96 frame through K1 vs plain trace: {n} pixel diffs")
    if n:
        raise SystemExit("a frame rendered through K1 differs from the plain path")


def phase_counts(phases, what):
    """Print the diag build's phase-counter totals; return the executed DDA
    events (:data:`EVENTS`)."""
    tot = {k: int(v.sum()) for k, v in phases.items() if k != "iters"}
    say(f"{what}: phase counters (sum over rays): {json.dumps(tot)}")
    return sum(tot[k] for k in EVENTS)


def check_diag(what, phases, iters, plain_diag):
    """Hold the diag build's counters against the plain walk's (equal), and
    its warp iterations against the warp maximum of the plain walk's own."""
    import torch

    from voxelengine_tpu_torch.ops.bigtrace import PHASES

    bad = [k for i, k in enumerate(PHASES) if not torch.equal(phases[k], plain_diag[i])]
    if not torch.equal(iters, warp_max(plain_diag[len(PHASES)])):
        bad.append("iters (warp max of the plain walk's)")
    say(f"{what}: diag counters vs the plain walk's (tolerance: equal): mismatches {bad or 'none'}")
    if bad:
        raise SystemExit(f"{what}: K1's diag counters disagree with the plain walk: {bad}")


def warp_iters_line(iters, own, steps, what):
    """The ``return_iters`` statistics (``bench.py:291-297``), one value per
    warp of 32 rays (the loop count of its longest lane), and the share of
    the warps' lane-iterations that rays spend active (``own``: each ray's
    own loop count)."""
    import numpy as np

    it = iters[::32].cpu().numpy().astype(np.int64)
    busy = int(own.sum()) / (32 * int(it.sum()))
    say(f"{what}: warp iterations (return_iters, {it.size} warps): mean {it.mean():.1f} "
        f"p50 {np.percentile(it, 50):.0f} p90 {np.percentile(it, 90):.0f} p99 {np.percentile(it, 99):.0f} "
        f"max {it.max()} sum {it.sum()}; rays' own iterations {int(own.sum())}, so lanes are active "
        f"{busy:.4f} of the warp-iterations; steps sum {int(steps.sum())}")
    return busy


def k5_times(t):
    """``{refill: ms}`` as one phrase of a times line."""
    return ", ".join(f"{ms:.4f} ms at refill {r}" for r, ms in t.items())


def k5_sweep(args, kw, use_macro):
    """K5 at each of :data:`K5_REFILLS`: ``({refill: ms}, {refill: lanes-
    active share})``, the share from the counting instantiation (one extra
    launch each, off any path)."""
    import torch

    from voxelengine_tpu_torch.kernels import rrtrace

    times, share = {}, {}
    for r in sorted(set(K5_REFILLS) | {rrtrace.REFILL}, reverse=True):
        times[r] = cuda_ms(lambda: rrtrace.rrtrace(*args, use_macro=use_macro, refill=r, **kw), repeats=10)
        stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
        rrtrace.rrtrace(*args, use_macro=use_macro, refill=r, stats=stats, **kw)
        lanes, iters = stats.tolist()
        share[r] = lanes / (32 * iters)
    return times, share


def share_line(what, k1_share, share):
    say(f"{what}: lanes active on the warp-iterations: K1 (diag build) {k1_share:.4f}; K5 (counting build) "
        + ", ".join(f"{v:.4f} at refill {r}" for r, v in share.items()))


def line_kernel_args(bm, lt, o, d, max_steps):
    """K1's and K5's arguments for rays ``o``, ``d`` (ray setup done here,
    so a timing covers the kernel alone)."""
    import torch

    from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup

    dd, start_c, _, active = _ray_setup(bm.grid_dims, bm.factor, o, d)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, o.device), dd)
    args = (start_c.contiguous(), dd.contiguous(), active.to(torch.int32), pad.contiguous(),
            lt.region_lines, lt.brick_lines, lt.macro, lt.macro2)
    kw = dict(grid_dims=bm.grid_dims, region_dims=lt.region_dims, factor=bm.factor,
              wpb=bm.words_per_brick, max_steps=max_steps, brick_layout=bm.brick_layout)
    return args, kw


def bench_world(dev, dims, cache: str, ms: dict):
    """The bench flow's world (``bench.py:132-178,216-233``) through the
    port's checkpoint layer: ``generate_or_load`` builds the world through W1
    into ``cache`` (timed; W1's launches counted), a second
    ``generate_or_load`` loads it back, which must give the same tables bit
    for bit, then ``line_table_or_build`` and ``materialize_brick_lines``.
    Returns ``(bm, lt, W1 launches of the build, cache key)``."""
    import torch

    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.io.checkpoint import generate_or_load, line_table_or_build
    from voxelengine_tpu_torch.kernels import terrain
    from voxelengine_tpu_torch.ops.bigtrace import materialize_brick_lines
    from voxelengine_tpu_torch.utils.profiling import timed

    key = f"terrain_{dims[0]}x{dims[1]}x{dims[2]}_f32_o32_v1"  # bench.py:139
    def build():
        with timed("world", ms, verbose=False, device=dev):
            return build_brickmap_terrain_compact(dims, 32, device=dev)

    def not_cached():
        raise SystemExit("the bench world was not loaded from its cache")

    terrain.launches = 0  # W1's path: the slabs of one build
    with timed("build and save", ms, verbose=False, device=dev):
        built = generate_or_load(cache, key, build, device=dev)
    launches = terrain.launches
    if launches != dims[2] // 32:
        raise SystemExit(f"the bench world's build launched W1 {launches} times, not once a slab")
    ms["save"] = ms["build and save"] - ms["world"]
    with timed("load", ms, verbose=False, device=dev):
        loaded = generate_or_load(cache, key, not_cached, device=dev)
    same = {k: torch.equal(getattr(built, k), getattr(loaded, k)) for k in ("meta", "brick_idx", "bricks")}
    same["fields"] = all(getattr(built, k) == getattr(loaded, k)
                         for k in ("grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots"))
    say(f"bench world: cache save {ms['save'] / 1e3:.2f} s, load {ms['load'] / 1e3:.2f} s; the loaded tables "
        f"equal the built ones (bit for bit): {json.dumps(same)}")
    if not all(same.values()):
        raise SystemExit("the bench world loaded from its cache differs from the built one")
    del built
    with timed("line table", ms, verbose=False, device=dev):
        lt = materialize_brick_lines(loaded, line_table_or_build(cache, key + "_lt1", loaded))
    return loaded, lt, launches, key


def phase_main_path(dev, world: str):
    """The main path on ``world``: ``demo`` (the 1024^3 world, built through
    W1) or ``full`` (the bench world through :func:`bench_world`, its macro
    decision through ``memo_json``).  Returns K1's record and W1's launches
    on the world's build."""
    import shutil
    import tempfile

    import torch

    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.kernels import terrain
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines
    from voxelengine_tpu_torch.utils.profiling import timed

    dims, W, H = WORLDS[world]
    name = f"{dims[0]}x{dims[1]}x{dims[2]}"
    ms = {}
    cache = None
    if world == "full":
        (ROOT / "_checkout").mkdir(exist_ok=True)
        cache = tempfile.mkdtemp(prefix="world_cache_", dir=ROOT / "_checkout")
        bm, lt, w1_launches, key = bench_world(dev, dims, cache, ms)
    else:
        terrain.launches = 0
        with timed("world", ms, verbose=False, device=dev):
            bm = build_brickmap_terrain_compact(dims, 32, device=dev)
            torch.cuda.synchronize()
        w1_launches = terrain.launches
        with timed("line table", ms, verbose=False, device=dev):
            lt = materialize_brick_lines(bm, make_line_table(bm))
    say(f"main path ({world}): world {name} f32 built through W1 in {ms['world'] / 1e3:.2f} s ({w1_launches} W1 "
        f"launches; {bm.bricks.shape[0]} bricks, {bm.bricks.numel() * 4 / 1e9:.3f} GB); line table + brick lines "
        f"{ms['line table'] / 1e3:.2f} s ({lt.num_regions} regions), on {card_line()}")
    try:
        return main_path_frames(dev, world, bm, lt, cache and (cache, key)), w1_launches
    finally:
        if cache:
            shutil.rmtree(cache, ignore_errors=True)


def main_path_frames(dev, world, bm, lt, memo):
    """The frames, the exactness gate, the diag build and the times of the
    main path on ``world``'s ``bm`` and ``lt``; the macro decision through
    ``memo_json`` in ``memo = (cache dir, world key)`` when given."""
    import dataclasses

    import torch

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.io.checkpoint import memo_json
    from voxelengine_tpu_torch.kernels import bigtrace
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm, trace_brickmap_lt
    from voxelengine_tpu_torch.ops.trace import trace_brickmap
    from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, probe_use_macro, render_frame

    dims, W, H = WORLDS[world]
    cfg = RenderConfig(width=W, height=H, checkerboard=True, tile_order=True)
    env = Environment.default(dev)
    origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)  # bench.py:191-192
    euler = torch.tensor([-0.25, 0.75, 0.0], device=dev)
    rays_per_frame = W * H // 2

    # the macro probe on the frame's rays (bench.py:232-266)
    po, pd, _, _, _ = primary_rays(cfg, origin, euler, 1)
    t0 = time.perf_counter()
    if memo:
        pk = (f"{memo[1]}_macroprobe_v1_{W}x{H}_ms{cfg.max_steps}_cam{'_'.join(str(float(v)) for v in origin.tolist())}"
              f"_e{'_'.join(str(float(e)) for e in euler.tolist())}")
        use_macro = bool(memo_json(memo[0], pk, lambda: probe_use_macro(bm, lt, po, pd, cfg)))
        if memo_json(memo[0], pk, lambda: None) != use_macro:
            raise SystemExit("memo_json did not return the stored macro decision")
    else:
        use_macro = probe_use_macro(bm, lt, po, pd, cfg)
    t_probe = time.perf_counter() - t0
    _, ph = trace_brickmap_hbm(bm, lt, po[::4], pd[::4], cfg.max_steps, return_phases=True)
    say(f"main path ({world}): macro probe on every 4th of the frame's {po.shape[0]} rays: mskip total "
        f"{int(ph['mskip'].sum())}, use_macro={use_macro} ({t_probe * 1e3:.1f} ms"
        f"{', through memo_json' if memo else ''})")
    cfg = dataclasses.replace(cfg, trace_use_macro=use_macro)
    fb = make_framebuffer(cfg, dev)

    bigtrace.launches = 0  # count the main path's launches only
    render_frame(bm, fb, origin, euler, env, 0, cfg, lt=lt)  # warm-up
    torch.cuda.synchronize()
    counts = [bigtrace.launches]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, FRAMES + 1):
        # a distinct frame each time: frame parity and a small camera drift
        render_frame(bm, fb, origin, euler + 1e-5 * i, env, i, cfg, lt=lt)
        counts.append(bigtrace.launches)
    end.record()
    torch.cuda.synchronize()
    launches = bigtrace.launches
    frame_ms = start.elapsed_time(end) / FRAMES
    if any(b != a + 1 for a, b in zip([0] + counts, counts)):
        raise SystemExit(f"K1 was not launched once per frame: launch counts {counts}")

    if tuple(fb.shape) != (H, W, 3) or not bool(torch.isfinite(fb).all()):
        raise SystemExit("framebuffer has the wrong shape or non-finite values")
    if float(fb.min()) < 0.0 or float(fb.max()) > 1.0:
        raise SystemExit("framebuffer values outside [0, 1]")

    # exactness gate: K1 against its plain version on the full frame of rays
    o, d, _, _, _ = primary_rays(cfg, origin, euler + 1e-5 * FRAMES, FRAMES)
    got = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=use_macro)
    chunk_walk = trace_brickmap(bm, o, d, cfg.max_steps)
    lt_walk, pdg = trace_brickmap_lt(bm, lt, o, d, cfg.max_steps, use_macro, diag=True)
    want = lt_walk if use_macro else chunk_walk
    diffs = compare(got, want)
    check_diffs(f"main path ({world}): exactness gate, K1 (use_macro={use_macro}) vs its plain version", diffs,
                o.shape[0], int(want.hit.sum()))
    chunk = compare(got, chunk_walk)
    say(f"main path ({world}): K1 (use_macro={use_macro}) vs the chunk-by-chunk trace_brickmap: hit diffs {chunk[0]}, "
        f"steps diffs {chunk[1]}, normal diffs {chunk[2]}, position diffs {chunk[3]}")
    hit_frac = float(want.hit.float().mean())
    if not 0.0 < hit_frac < 1.0:
        raise SystemExit(f"implausible hit fraction {hit_frac}")
    say(f"main path ({world}): {W}x{H} checkerboard tile_order, use_macro={use_macro}, {FRAMES} chained frames: "
        f"{frame_ms:.3f} ms/frame, {rays_per_frame / frame_ms / 1e3:.3f} Mrays/s primary, "
        f"hit fraction {hit_frac:.4f}, K1 launches {launches}, "
        f"framebuffer checksum {float(fb.double().sum()):.6f}")

    # the diag build on the same rays: counters, warp iterations
    res, iters, phases = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=use_macro,
                                            return_iters=True, return_phases=True)
    check_diffs(f"main path ({world}): K1 diag build vs the production build", compare(res, got), o.shape[0],
                int(got.hit.sum()))
    check_diag(f"main path ({world})", phases, iters, pdg)
    events = phase_counts(phases, f"main path ({world})")
    k1_share = warp_iters_line(iters, pdg[-1], got.steps, f"main path ({world})")

    # times: K1 (macro off, on) and K5 alone (ray setup excluded), the plain trace
    args, kw = line_kernel_args(bm, lt, o, d, cfg.max_steps)
    t_off = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=False, **kw), repeats=10)
    t_on = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=True, **kw), repeats=10)
    t_k5, k5_share = k5_sweep(args, kw, use_macro)
    share_line(f"main path ({world})", k1_share, k5_share)
    k_ms = t_on if use_macro else t_off
    plain = trace_brickmap_lt if use_macro else (lambda bm, lt, *a: trace_brickmap(bm, *a))
    _, p_ms = events_ms(lambda: plain(bm, lt, o, d, cfg.max_steps))
    steps_sum = int(got.steps.sum())
    say(f"times ({world}): K1 macro off {t_off:.3f} ms, K1 macro on {t_on:.3f} ms, K5 (use_macro={use_macro}) {k5_times(t_k5)}, "
        f"plain {'macro walk' if use_macro else 'trace'} {p_ms:.3f} ms, {o.shape[0]} frame rays, "
        f"sum(steps) {steps_sum}, executed events {events}, on {card_line()}")
    return kernel_entry(
        "bigtrace" if world == "full" else "bigtrace_demo_world", "bigtrace.cu",
        "voxelengine_tpu/ops/pallas_bigtrace.py:1348", launches, diffs[4], k_ms, p_ms,
        o.shape[0], hit_table_bytes(want, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick), steps_sum,
        events if use_macro else None,
    )


def random_grid(dims, fill, seed, dev):
    """A dense grid of random voxels over a floor (``tests/test_pallas_trace.py:80-81``)."""
    import torch

    X, Y, Z = dims
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = torch.rand((Z, Y, X), generator=gen, device=dev) < fill
    dense[:, :4, :] = torch.rand((Z, 4, X), generator=gen, device=dev) < 0.6
    return dense


def render_dense_plain(grid, fb, origin, euler, env, frame_number, cfg):
    """``render_frame_dense`` with the plain ``trace_grid`` in K2's place."""
    from voxelengine_tpu_torch.ops.trace import trace_grid
    from voxelengine_tpu_torch.render.frame import composite_frame, primary_rays, shade_traced

    origins, dirs, px, py, py_r = primary_rays(cfg, origin, euler, frame_number)
    out = trace_grid(grid, origins, dirs, cfg.max_steps)
    color, write = shade_traced(None, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg)
    return composite_frame(fb, color, write, cfg, frame_number)


def check_diffs(what, diffs, rays, hits):
    say(f"{what} (tolerance: bit-equal), {rays} rays, hits {hits}: hit diffs {diffs[0]}, "
        f"steps diffs {diffs[1]}, normal diffs {diffs[2]}, position diffs {diffs[3]}")
    if any(diffs[:4]):
        raise SystemExit(f"{what}: the kernel disagrees with the plain trace")


def phase_dense_vs_plain(dev):
    """Phase 7: K2 and K3 against the plain trace_grid, and a dense frame."""
    import torch

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.ops.gridtrace import trace_grid_mxu, trace_grid_vpu
    from voxelengine_tpu_torch.ops.trace import trace_grid
    from voxelengine_tpu_torch.render.frame import make_framebuffer, render_frame_dense

    dense = random_grid((32, 32, 32), 0.015, 7, dev)
    o, d = random_rays((32, 32, 32), 65536, 1.9, 107, dev)
    err = {"K2": 0.0, "K3": 0.0}
    for layout in Layout:
        g = BitGrid.from_dense(dense, layout)
        want = trace_grid(g, o, d, 256)
        for k, fn in (("K2", trace_grid_vpu), ("K3", trace_grid_mxu)):
            diffs = compare(fn(g, o, d, 256), want)
            err[k] = max(err[k], diffs[4])
            check_diffs(f"dense vs plain: {k}, random 32^3 {layout.name}", diffs, o.shape[0], int(want.hit.sum()))

    g = BitGrid.from_dense(dense, Layout.TILED_LINEAR)
    cfg = RenderConfig(width=96, height=64, checkerboard=True, max_steps=256)
    env = Environment.default(dev)
    origin = torch.tensor([16.0, 22.0, -10.0], device=dev)
    euler = torch.tensor([-0.35, 3.14159, 0.0], device=dev)
    a = render_frame_dense(g, make_framebuffer(cfg, dev), origin, euler, env, 1, cfg)
    b = render_dense_plain(g, make_framebuffer(cfg, dev), origin, euler, env, 1, cfg)
    n = int((a != b).any(dim=-1).sum())
    say(f"dense vs plain: 96x64 render_frame_dense frame through K2 vs plain trace: {n} pixel diffs")
    if n:
        raise SystemExit("a dense frame rendered through K2 differs from the plain path")
    return err


def config2_rays(dev):
    """The 1024x1024 ray batch of BASELINE config 2 (``apps/bench_configs.py:68-72``)."""
    import numpy as np
    import torch

    W = H = 1024
    u, _ = np.meshgrid((np.arange(W) + 0.5) / W, (np.arange(H) + 0.5) / H)
    o = np.stack([np.full(u.size, 32.0), np.full(u.size, 90.0), np.full(u.size, -40.0)], -1)
    d = np.stack([(u.reshape(-1) - 0.5) * 1.2, -np.ones(u.size) * 0.9, np.ones(u.size)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(dev), torch.from_numpy(d.astype(np.float32)).to(dev))


def phase_dense_path(dev, err):
    """Phase 8: the dense path at config-2 size; returns the K2 and K3 records."""
    import torch

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.kernels import gridtrace
    from voxelengine_tpu_torch.ops.gridtrace import trace_grid_mxu, trace_grid_vpu, words_to_limb_rows
    from voxelengine_tpu_torch.ops.trace import trace_grid
    from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, render_frame_dense
    from voxelengine_tpu_torch.worldgen.terrain import generate_world

    t0 = time.perf_counter()
    g = generate_world((64, 64, 64), octaves=8, device=dev)
    torch.cuda.synchronize()
    say(f"dense path: world 64x64x64 (octaves 8) in {time.perf_counter() - t0:.2f} s, "
        f"{int(g.count())} solid voxels, {g.words.numel() * 4} bytes of words")

    # the config-2 batch: K3's path (trace_grid_mxu; the grid's 32 KB of
    # words in shared memory), K2 and the plain trace
    o, d = config2_rays(dev)
    gridtrace.launches = gridtrace.limb_launches = gridtrace.staged_launches = 0
    k3 = trace_grid_mxu(g, o, d)
    torch.cuda.synchronize()
    k3_launches = gridtrace.staged_launches
    if (gridtrace.limb_launches, k3_launches) != (1, 1):
        raise SystemExit(f"trace_grid_mxu launched K3 {gridtrace.limb_launches} times ({k3_launches} staged), "
                         "not once staged")
    want = trace_grid(g, o, d)
    for k, got in (("K3", k3), ("K2", trace_grid_vpu(g, o, d))):
        diffs = compare(got, want)
        err[k] = max(err[k], diffs[4])
        check_diffs(f"dense path: {k} vs plain on the config-2 batch", diffs, o.shape[0], int(want.hit.sum()))

    # the frames: K2's path
    cfg = RenderConfig(width=1280, height=720, checkerboard=True)  # no tile_order (apps/voxel_app.py:183)
    env = Environment.default(dev)
    origin = torch.tensor([32.0, 40.0, -20.0], device=dev)
    euler = torch.tensor([-0.35, 3.14159, 0.0], device=dev)
    fb = make_framebuffer(cfg, dev)
    gridtrace.launches = gridtrace.limb_launches = 0
    render_frame_dense(g, fb, origin, euler, env, 0, cfg)  # warm-up
    torch.cuda.synchronize()
    counts = [gridtrace.launches]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, FRAMES + 1):
        render_frame_dense(g, fb, origin, euler + 1e-5 * i, env, i, cfg)
        counts.append(gridtrace.launches)
    end.record()
    torch.cuda.synchronize()
    k2_launches = gridtrace.launches
    frame_ms = start.elapsed_time(end) / FRAMES
    if any(b != a + 1 for a, b in zip([0] + counts, counts)) or gridtrace.limb_launches:
        raise SystemExit(f"K2 was not launched once per dense frame: launch counts {counts}")
    if tuple(fb.shape) != (720, 1280, 3) or not bool(torch.isfinite(fb).all()):
        raise SystemExit("dense framebuffer has the wrong shape or non-finite values")
    if float(fb.min()) < 0.0 or float(fb.max()) > 1.0:
        raise SystemExit("dense framebuffer values outside [0, 1]")
    fo, fd, _, _, _ = primary_rays(cfg, origin, euler + 1e-5 * FRAMES, FRAMES)
    fwant = trace_grid(g, fo, fd, cfg.max_steps)
    diffs = compare(trace_grid_vpu(g, fo, fd, cfg.max_steps), fwant)
    err["K2"] = max(err["K2"], diffs[4])
    check_diffs("dense path: exactness gate, K2 vs plain on the last frame's rays", diffs, fo.shape[0],
                int(fwant.hit.sum()))
    hit_frac = float(fwant.hit.float().mean())
    if not 0.0 < hit_frac < 1.0:
        raise SystemExit(f"implausible dense hit fraction {hit_frac}")
    say(f"dense path: 1280x720 checkerboard, {FRAMES} chained render_frame_dense frames: {frame_ms:.3f} ms/frame, "
        f"{fo.shape[0] / frame_ms / 1e3:.3f} Mrays/s primary, hit fraction {hit_frac:.4f}, "
        f"K2 launches {k2_launches}, framebuffer checksum {float(fb.double().sum()):.6f}")

    # the CUDA kernels one dense frame and one trace_grid_vpu call launch
    frame_kernels, frame_dev = kernel_profile(lambda: render_frame_dense(g, fb, origin, euler, env, FRAMES + 1, cfg))
    call_kernels, _ = kernel_profile(lambda: trace_grid_vpu(g, fo, fd, cfg.max_steps))
    if call_kernels is None:
        say("dense path: kernels a frame: not measured (torch.profiler recorded no device activity)")
    else:
        say(f"dense path: CUDA kernels launched by one render_frame_dense frame: {len(frame_kernels)} "
            f"({sum(frame_dev):.4f} ms of device time); by one trace_grid_vpu call on its rays: {len(call_kernels)} "
            f"({', '.join(sorted(set(call_kernels)))})")
        if len(call_kernels) != 1:
            raise SystemExit(f"trace_grid_vpu launched {len(call_kernels)} CUDA kernels, not K2 alone")

    # the CUDA kernels one trace_grid_mxu call launches: the limb planes' copy and K3
    mxu_kernels, mxu_dev = kernel_profile(lambda: trace_grid_mxu(g, o, d))
    if mxu_kernels is not None:
        say(f"dense path: CUDA kernels launched by one trace_grid_mxu call on the config-2 batch: {len(mxu_kernels)} "
            f"({sum(mxu_dev):.4f} ms of device time; {', '.join(mxu_kernels)})")
        if len(mxu_kernels) != 2:
            raise SystemExit(f"trace_grid_mxu launched {len(mxu_kernels)} CUDA kernels, not the planes' copy and K3")

    # K3's global instantiation (LimbFetch) on a grid beyond shared memory:
    # a random 128^3 grid, 65,536 words (256 KB)
    big = BitGrid.from_dense(random_grid((128, 128, 128), 0.01, 17, dev), Layout.TILED_LINEAR)
    bo, bd = random_rays(big.dims, 1 << 18, 1.9, 115, dev)
    gridtrace.limb_launches = gridtrace.staged_launches = 0
    bgot = trace_grid_mxu(big, bo, bd)
    torch.cuda.synchronize()
    k3g_launches = gridtrace.limb_launches - gridtrace.staged_launches
    if (gridtrace.limb_launches, k3g_launches) != (1, 1):
        raise SystemExit(f"trace_grid_mxu launched K3 {gridtrace.limb_launches} times ({k3g_launches} global) on a "
                         f"{big.words.numel() * 4} B grid, not once global")
    bwant, bp_ms = events_ms(lambda: trace_grid(big, bo, bd))
    bdiffs = compare(bgot, bwant)
    check_diffs(f"dense path: K3 (global instantiation) vs plain on a random 128^3 grid ({big.words.numel() * 4} B "
                "of words)", bdiffs, bo.shape[0], int(bwant.hit.sum()))

    # times on the config-2 batch and on the last frame's rays (the shape of
    # K2's launches on its path): the kernels' device time (torch.profiler,
    # CUDA events where it records none), and K2 as the whole trace_grid_vpu
    # call (checks, outputs, launch) by CUDA events
    kw = dict(dims=g.dims, layout=g.layout)
    limbs = words_to_limb_rows(g.words)

    def kernel_ms(fn):  # (device ms, event ms) of a call that launches one kernel
        ev = cuda_ms(fn, repeats=10)
        _, dev = kernel_profile(fn, 10)
        return ev if not dev else sum(dev) / len(dev), ev

    # K3's two instantiations on the config-2 batch (the global one forced by
    # the wrapper's limit), and the global one on its own grid
    limit = gridtrace.SMEM_WORDS_LIMIT
    gridtrace.SMEM_WORDS_LIMIT = 0
    try:
        k3_plain_block_ms, _ = kernel_ms(lambda: gridtrace.gridtrace_limbs(o, d, limbs, max_steps=2048, **kw))
    finally:
        gridtrace.SMEM_WORDS_LIMIT = limit
    blimbs = words_to_limb_rows(big.words)
    k3g_ms, _ = kernel_ms(lambda: gridtrace.gridtrace_limbs(bo, bd, blimbs, max_steps=2048, dims=big.dims,
                                                            layout=big.layout))
    mxu_call_ms = cuda_ms(lambda: trace_grid_mxu(g, o, d), repeats=10)

    k2_ms, k2_ev = kernel_ms(lambda: gridtrace.gridtrace(o, d, g.words, max_steps=2048, **kw))
    k2_frame_ms, k2_frame_ev = kernel_ms(lambda: gridtrace.gridtrace(fo, fd, g.words, max_steps=cfg.max_steps, **kw))
    call_frame_ms = cuda_ms(lambda: trace_grid_vpu(g, fo, fd, cfg.max_steps), repeats=10)
    k3_ms, k3_ev = kernel_ms(lambda: gridtrace.gridtrace_limbs(o, d, limbs, max_steps=2048, **kw))
    p_ms = cuda_ms(lambda: trace_grid(g, o, d), repeats=1)
    p_frame_ms = cuda_ms(lambda: trace_grid(g, fo, fd, cfg.max_steps), repeats=1)
    steps_sum, frame_steps = int(want.steps.sum()), int(fwant.steps.sum())
    say(f"times (device; CUDA events around the launches in brackets): K2 {k2_ms:.4f} ms ({k2_ev:.4f}), K3 "
        f"(shared-memory instantiation) {k3_ms:.4f} ms ({k3_ev:.4f}), K3 in plain 128-thread blocks with the "
        f"four-plane fetch (its global instantiation) {k3_plain_block_ms:.4f} ms, the whole trace_grid_mxu call "
        f"{mxu_call_ms:.4f} ms (events), plain trace_grid {p_ms:.3f} ms, {o.shape[0]} rays, sum(steps) {steps_sum}; "
        f"K3 global {k3g_ms:.4f} ms, plain {bp_ms:.3f} ms on the 128^3 grid's {bo.shape[0]} rays, sum(steps) "
        f"{int(bwant.steps.sum())}; "
        f"K2 {k2_frame_ms:.4f} ms ({k2_frame_ev:.4f}), the whole trace_grid_vpu call {call_frame_ms:.4f} ms (events), "
        f"plain trace_grid {p_frame_ms:.3f} ms on the last frame's {fo.shape[0]} rays, sum(steps) {frame_steps}, "
        f"on {card_line()}")
    return [
        kernel_entry("gridtrace", "gridtrace.cu", "voxelengine_tpu/ops/pallas_trace.py:329", k2_launches,
                     err["K2"], k2_frame_ms, p_frame_ms, fo.shape[0], hit_table_bytes(fwant, g.dims, g.layout),
                     frame_steps, ray_bytes=grid_ray_bytes(fo, fd), call_ms=call_frame_ms,
                     kernels_per_call=None if call_kernels is None else len(call_kernels),
                     kernels_per_frame=None if frame_kernels is None else len(frame_kernels)),
        kernel_entry("gridtrace_limbs", "gridtrace.cu", "voxelengine_tpu/ops/pallas_trace.py:93", k3_launches,
                     err["K3"], k3_ms, p_ms, o.shape[0], hit_table_bytes(want, g.dims, g.layout), steps_sum,
                     ray_bytes=grid_ray_bytes(o, d), plain_block_ms=k3_plain_block_ms, call_ms=mxu_call_ms,
                     kernels_per_call=None if mxu_kernels is None else len(mxu_kernels)),
        kernel_entry("gridtrace_limbs_global", "gridtrace.cu", "voxelengine_tpu/ops/pallas_trace.py:93",
                     k3g_launches, bdiffs[4], k3g_ms, bp_ms, bo.shape[0], hit_table_bytes(bwant, big.dims, big.layout),
                     int(bwant.steps.sum()), ray_bytes=grid_ray_bytes(bo, bd)),
    ]


def direction_sorted(*rays):
    """``rays`` (start, direction, ...) reordered by direction octant, then
    by the chunk of the clipped start."""
    import torch

    start, d = rays[:2]
    octant = ((d[:, 0] < 0).long() << 2) | ((d[:, 1] < 0).long() << 1) | (d[:, 2] < 0).long()
    c = start.floor().long().clamp_min(0)
    g = c.amax(dim=0) + 1
    order = torch.argsort(octant * int(g.prod()) + c[:, 0] + g[0] * (c[:, 1] + g[1] * c[:, 2]))
    return tuple(t[order].contiguous() for t in rays)


def phase_bmtrace(dev):
    """Phase 9: K4 at its documented scope (128^3 at factor 8), on a
    TILED_MORTON world and, in its global-meta instantiation, on a world
    whose meta exceeds shared memory; returns the records of both
    instantiations."""
    import torch

    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.brickmap import build_brickmap
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.kernels import bmtrace
    from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup, trace_brickmap
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_mxu
    from voxelengine_tpu_torch.worldgen.terrain import generate_world

    def kernel_args(bm, o, d):
        dd, start_c, _, active = _ray_setup(bm.grid_dims, bm.factor, o, d)
        pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, dev), dd)
        kw = dict(grid_dims=bm.grid_dims, factor=bm.factor, max_steps=2048,
                  coarse_layout=bm.coarse_layout, brick_layout=bm.brick_layout)
        return (start_c, dd, active.to(torch.int32), pad), kw

    def table_bytes(out, bm):
        return hit_table_bytes(out, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick)

    t0 = time.perf_counter()
    bm = build_brickmap(generate_world((128, 128, 128), octaves=8, device=dev), 8)
    torch.cuda.synchronize()
    say(f"on-chip brickmap: world 128^3 f8 (octaves 8, dense slots, {bm.coarse_layout.name}/"
        f"{bm.brick_layout.name}) built in {time.perf_counter() - t0:.2f} s, "
        f"{int(((bm.meta >> 30) & 1).sum())} of {bm.num_chunks} chunks occupied, "
        f"meta in shared memory: {bmtrace.meta_in_shared(bm.num_chunks)}")
    o, d = random_rays(bm.world_dims, 1 << 20, 2.0, 109, dev)
    bmtrace.launches = bmtrace.shared_launches = 0
    got = trace_brickmap_mxu(bm, o, d)
    torch.cuda.synchronize()
    launches = bmtrace.shared_launches
    if (bmtrace.launches, launches) != (1, 1):
        raise SystemExit(f"trace_brickmap_mxu launched K4 {bmtrace.launches} times ({launches} with shared meta), "
                         "not once with shared meta")
    want = trace_brickmap(bm, o, d)
    diffs = compare(got, want)
    err = diffs[4]
    check_diffs("on-chip brickmap: K4 (shared meta) vs plain, 128^3 f8", diffs, o.shape[0], int(want.hit.sum()))

    dense = random_grid((64, 64, 64), 0.008, 11, dev)
    mbm = build_brickmap(BitGrid.from_dense(dense), 8, coarse_layout=Layout.TILED_MORTON,
                         brick_layout=Layout.TILED_MORTON)
    mo, md = random_rays(mbm.world_dims, 65536, 1.9, 111, dev)
    mwant = trace_brickmap(mbm, mo, md, 256)
    diffs = compare(trace_brickmap_mxu(mbm, mo, md, 256), mwant)
    err = max(err, diffs[4])
    check_diffs("on-chip brickmap: K4 (shared meta) vs plain, random 64^3 f8 TILED_MORTON/TILED_MORTON", diffs,
                mo.shape[0], int(mwant.hit.sum()))

    # the global-meta instantiation: a world whose meta exceeds any shared-memory limit
    t0 = time.perf_counter()
    gbm = random_brickmap((512, 256, 512), 8, 0.004, 13, dev)
    torch.cuda.synchronize()
    gname = "x".join(map(str, gbm.world_dims))
    say(f"on-chip brickmap: random world {gname} f8 ({gbm.num_chunks} chunks, {gbm.meta.numel() * 4} B of meta, "
        f"{gbm.bricks.numel() * 4} B of bricks) built in {time.perf_counter() - t0:.2f} s, meta in shared memory: "
        f"{bmtrace.meta_in_shared(gbm.num_chunks)}")
    go, gd = random_rays(gbm.world_dims, 65536, 2.0, 113, dev)
    bmtrace.launches = bmtrace.shared_launches = 0
    ggot = trace_brickmap_mxu(gbm, go, gd)
    torch.cuda.synchronize()
    g_launches = bmtrace.launches - bmtrace.shared_launches
    if (bmtrace.launches, g_launches) != (1, 1):
        raise SystemExit(f"trace_brickmap_mxu launched K4 {bmtrace.launches} times ({g_launches} with global meta), "
                         "not once with global meta")
    gwant = trace_brickmap(gbm, go, gd)
    gdiffs = compare(ggot, gwant)
    check_diffs(f"on-chip brickmap: K4 (global meta) vs plain, random {gname} f8", gdiffs, go.shape[0],
                int(gwant.hit.sum()))

    args, kw = kernel_args(bm, o, d)
    sargs = direction_sorted(*args[:4])
    gargs, gkw = kernel_args(gbm, go, gd)
    k_ms = cuda_ms(lambda: bmtrace.bmtrace(*args, bm.meta, bm.bricks, **kw), repeats=10)
    sorted_ms = cuda_ms(lambda: bmtrace.bmtrace(*sargs, bm.meta, bm.bricks, **kw), repeats=10)
    g_ms = cuda_ms(lambda: bmtrace.bmtrace(*gargs, gbm.meta, gbm.bricks, **gkw), repeats=10)
    p_ms = cuda_ms(lambda: trace_brickmap(bm, o, d), repeats=1)
    gp_ms = cuda_ms(lambda: trace_brickmap(gbm, go, gd), repeats=1)
    steps_sum, g_steps = int(want.steps.sum()), int(gwant.steps.sum())
    say(f"times: K4 (shared meta) {k_ms:.3f} ms, on the same rays sorted by direction octant then start chunk "
        f"{sorted_ms:.3f} ms (sorted/unsorted {sorted_ms / k_ms:.3f}), plain trace_brickmap {p_ms:.3f} ms, "
        f"{o.shape[0]} rays, sum(steps) {steps_sum}; K4 (global meta) {g_ms:.3f} ms, plain {gp_ms:.3f} ms on the "
        f"{gname} world's {go.shape[0]} rays, sum(steps) {g_steps}, on {card_line()}")
    replaces = "voxelengine_tpu/ops/pallas_trace2.py:39"
    return [
        kernel_entry("bmtrace", "bmtrace.cu", replaces, launches, err, k_ms, p_ms, o.shape[0],
                     table_bytes(want, bm), steps_sum),
        kernel_entry("bmtrace_global_meta", "bmtrace.cu", replaces, g_launches, gdiffs[4], g_ms, gp_ms,
                     go.shape[0], table_bytes(gwant, gbm), g_steps),
    ]


def sparse_world(dev):
    """``tests/test_pallas_bigtrace.py:500-531``'s 16384x512x16384 world at
    factor 32, built from numpy: 512x16x512 chunks (8192 regions, 16 L2
    words, L3 real), a floor pad with a small tower at the centre and one
    far lone chunk, all on one shared full brick."""
    import numpy as np
    import torch

    from voxelengine_tpu_torch.core.brickmap import BrickMap, pack_meta
    from voxelengine_tpu_torch.core.layout import Layout

    gx, gy, gz = 512, 16, 512
    occ = np.zeros((gz, gy, gx), bool)  # [cz, cy, cx]
    occ[248:265, 0, 248:265] = True
    occ[254:257, 1:6, 254:257] = True
    occ[40, 0, 40] = True
    flat = torch.from_numpy(occ.reshape(-1)).to(dev)
    full = pack_meta(torch.tensor(True), torch.zeros(3, dtype=torch.int32), torch.full((3,), 31, dtype=torch.int32))
    return BrickMap(
        meta=torch.where(flat, full.to(dev), 0).to(torch.int32),
        brick_idx=torch.where(flat, 0, -1).to(torch.int32),
        bricks=torch.full((1, 32**3 // 32), -1, dtype=torch.int32, device=dev),
        grid_dims=(gx, gy, gz), factor=32, coarse_layout=Layout.LINEAR, brick_layout=Layout.TILED_LINEAR,
        dense_slots=False,
    )


def sparse_rays(n, dev):
    """Near rays down at the floor pad, horizon rays from a far corner at
    the tower (they cross ~300 empty chunks), sky rays
    (``tests/test_pallas_bigtrace.py:550-577``), from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(12)
    kinds = rng.integers(0, 3, n)
    o_near = np.stack([rng.uniform(7940, 8480, n), rng.uniform(80, 400, n), rng.uniform(7940, 8480, n)], -1)
    d_near = np.stack([rng.normal(0, 0.3, n), -np.ones(n), rng.normal(0, 0.3, n)], -1)
    o_far = np.stack([rng.uniform(800, 2000, n), rng.uniform(100, 480, n), rng.uniform(800, 2000, n)], -1)
    d_far = np.asarray([8192.0, 120.0, 8192.0]) - o_far
    d_sky = np.stack([rng.normal(0, 0.2, n), np.ones(n), rng.normal(0, 0.2, n)], -1)
    o = np.where((kinds == 0)[:, None], o_near, o_far)
    d = np.where((kinds == 0)[:, None], d_near, np.where((kinds == 1)[:, None], d_far, d_sky))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(dev), torch.from_numpy(d.astype(np.float32)).to(dev))


def warp_max(x):
    """Each ray's warp (32 consecutive rays) maximum."""
    import torch

    n = x.shape[0]
    padded = torch.cat([x, x.new_zeros((-n) % 32)])
    return padded.reshape(-1, 32).amax(dim=1).repeat_interleave(32)[:n]


def phase_sparse(dev):
    """Phase 10: K1 (macro off and on) and K5 on the sparse 16k world;
    returns K5's record."""
    import torch

    from voxelengine_tpu_torch.config import MAX_STEPS
    from voxelengine_tpu_torch.kernels import bigtrace, rrtrace
    from voxelengine_tpu_torch.ops.bigtrace import (
        make_line_table,
        materialize_brick_lines,
        trace_brickmap_hbm,
        trace_brickmap_hbm_rr,
        trace_brickmap_lt,
    )
    from voxelengine_tpu_torch.ops.trace import trace_brickmap

    t0 = time.perf_counter()
    bm = sparse_world(dev)
    lt = materialize_brick_lines(bm, make_line_table(bm))
    torch.cuda.synchronize()
    tables = sum(t.numel() * 4 for t in (bm.meta, bm.brick_idx, bm.bricks, lt.region_lines, lt.macro, lt.macro2,
                                         lt.brick_lines))
    say(f"sparse world: 16384x512x16384 f32 (512x16x512 chunks, {lt.num_regions} regions, 512 L2 super-regions "
        f"in 16 words, 32 L3 blocks in 1 word), {tables / 1e6:.1f} MB of tables, "
        f"built in {time.perf_counter() - t0:.2f} s")
    if not (lt.macro2 != -1).all():
        raise SystemExit("sparse world: L2/L3 should be real (no all-occupied words)")
    o, d = sparse_rays(SPARSE_RAYS, dev)
    ms = MAX_STEPS
    n = o.shape[0]

    plain_off = trace_brickmap(bm, o, d, ms)
    plain_on, pdg = trace_brickmap_lt(bm, lt, o, d, ms, diag=True)
    hits = int(plain_on.hit.sum())
    k1_off = trace_brickmap_hbm(bm, lt, o, d, ms, use_macro=False)
    check_diffs("sparse world: K1 macro off vs plain trace_brickmap", compare(k1_off, plain_off), n, hits)
    k1_on = trace_brickmap_hbm(bm, lt, o, d, ms)
    check_diffs("sparse world: K1 macro on vs plain macro walk", compare(k1_on, plain_on), n, hits)
    rrtrace.launches = 0  # K5's path: trace_brickmap_hbm_rr on this batch
    k5 = trace_brickmap_hbm_rr(bm, lt, o, d, ms)
    torch.cuda.synchronize()
    k5_launches = rrtrace.launches
    if k5_launches != 1:
        raise SystemExit(f"trace_brickmap_hbm_rr launched K5 {k5_launches} times, not once")
    k5_diffs = compare(k5, plain_on)
    check_diffs("sparse world: K5 vs plain macro walk", k5_diffs, n, hits)
    check_diffs("sparse world: K1 macro on vs K5", compare(k1_on, k5), n, hits)
    chunk = compare(k1_on, plain_off)
    say(f"sparse world: K1 macro on vs the chunk-by-chunk trace_brickmap: hit diffs {chunk[0]}, "
        f"steps diffs {chunk[1]}, normal diffs {chunk[2]}, position diffs {chunk[3]}")

    res, iters, phases = trace_brickmap_hbm(bm, lt, o, d, ms, return_iters=True, return_phases=True)
    check_diffs("sparse world: K1 diag build vs the production build", compare(res, k1_on), n, hits)
    check_diag("sparse world", phases, iters, pdg)
    events = phase_counts(phases, "sparse world")
    if int(phases["mskip"].sum()) <= 0:
        raise SystemExit("sparse world: no macro skip fired")
    k1_share = warp_iters_line(iters, pdg[-1], k1_on.steps, "sparse world")

    args, kw = line_kernel_args(bm, lt, o, d, ms)
    t_off = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=False, **kw), repeats=10)
    t_on = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=True, **kw), repeats=10)
    t_k5, k5_share = k5_sweep(args, kw, True)
    share_line("sparse world", k1_share, k5_share)
    p_off = cuda_ms(lambda: trace_brickmap(bm, o, d, ms), repeats=1)
    p_on = cuda_ms(lambda: trace_brickmap_lt(bm, lt, o, d, ms), repeats=1)
    steps_sum = int(k1_on.steps.sum())
    say(f"times: sparse world, {n} rays: K1 macro off {t_off:.3f} ms, K1 macro on {t_on:.3f} ms, K5 {k5_times(t_k5)}, "
        f"plain trace_brickmap {p_off:.3f} ms, plain macro walk {p_on:.3f} ms, sum(steps) {steps_sum}, "
        f"executed events {events} (macro off: sum(steps) {int(plain_off.steps.sum())}), on {card_line()}")
    return kernel_entry(
        "rrtrace", "rrtrace.cu", "voxelengine_tpu/ops/pallas_bigtrace.py:1694", k5_launches, k5_diffs[4],
        t_k5[rrtrace.REFILL],
        p_on, n, hit_table_bytes(plain_on, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick),
        steps_sum, events, refill=rrtrace.REFILL, lanes_active=k5_share[rrtrace.REFILL], k1_lanes_active=k1_share,
    )


def render_plain(bm, fb, origin, euler, env, frame_number, cfg, plain, block_perm=None, ortho_size=None,
                 primary=None):
    """``render_frame`` into ``fb`` with every trace (primary, shadow,
    reflection, AO) the plain ``plain(bm, origins, dirs, max_steps)``;
    ``primary`` reuses a plain primary trace of the same rays."""
    from voxelengine_tpu_torch.render.frame import composite_frame, primary_rays, shade_traced

    o, d, px, py, py_r = primary_rays(cfg, origin, euler, frame_number, block_perm, ortho_size)
    out = primary if primary is not None else plain(bm, o, d, cfg.max_steps)
    color, write = shade_traced(bm, out, o, d, px, py, py_r, origin, env, frame_number, cfg,
                                secondary=lambda a, b, ms: plain(bm, a, b, ms))
    return composite_frame(fb, color, write, cfg, frame_number, block_perm)


def full_diffs(got, want, mask=None):
    """(hit, steps, normal, position) diffs of two TraceOuts on every ray,
    misses included, or on the rays of ``mask``."""
    import torch

    m = torch.ones_like(got.hit) if mask is None else mask
    return (
        int(((got.hit != want.hit) & m).sum()), int(((got.steps != want.steps) & m).sum()),
        int(((got.normal != want.normal).any(dim=1) & m).sum()),
        int(((got.position != want.position).any(dim=1) & m).sum()),
    )


def pixel_gate(what, a, b, card):
    n = int((a != b).any(dim=-1).sum())
    say(f"app frame: {what}: {n} pixel diffs (tolerance: bit-equal), on {card}")
    if n:
        raise SystemExit(f"app frame: {what} differs from the plain path")


def app_batches(bm, lt, cfg, origin, euler, env, fn):
    """One frame's trace batches through K1, as ``render_frame(..., lt)``
    traces them: ``[(kind, origins, dirs, max_steps, K1 result)]``, the
    primary first."""
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm
    from voxelengine_tpu_torch.render.frame import primary_rays, shade_traced

    o, d, px, py, py_r = primary_rays(cfg, origin, euler, fn)
    out = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=cfg.trace_use_macro)
    batches = [("primary", o.contiguous(), d, cfg.max_steps, out)]
    kinds = iter(["shadow", "reflection"] + [f"ao{i}" for i in range(cfg.ao_samples)])

    def k1(a, b, ms):
        res = trace_brickmap_hbm(bm, lt, a, b, ms, use_macro=cfg.trace_use_macro)
        batches.append((next(kinds), a.contiguous(), b.contiguous(), ms, res))
        return res

    shade_traced(bm, out, o, d, px, py, py_r, origin, env, fn, cfg, lt, secondary=k1)
    return batches


def phase_app_frame(dev):
    """Phase 11, the app's frame (``apps/voxel_app.py``) at its default
    size; returns the records of K1 on its frames and in ``raytrace``, and
    of K4 in ``raytrace``."""
    import dataclasses

    import numpy as np
    import torch

    from voxelengine_tpu_torch import BitGrid, VoxelRaytracer3D
    from voxelengine_tpu_torch.config import DebugView, Projection
    from voxelengine_tpu_torch.core.brickmap import (
        apply_edits,
        build_brickmap_terrain,
        build_brickmap_terrain_compact,
        compact_brickmap,
    )
    from voxelengine_tpu_torch.engine import raytracer
    from voxelengine_tpu_torch.kernels import bigtrace, bmtrace, terrain
    from voxelengine_tpu_torch.ops.bigtrace import brick_lines_view, make_line_table, trace_brickmap_hbm, trace_brickmap_lt
    from voxelengine_tpu_torch.ops.trace import TraceOut, _dims, _edge_pad, _ray_setup, trace_brickmap
    from voxelengine_tpu_torch.render.camera import get_directions_np
    from voxelengine_tpu_torch.render.frame import block_permutation_from_steps, make_framebuffer, render_frame
    from voxelengine_tpu_torch.render.graphics import Graphics

    card = card_line()
    dims, W, H = APP_WORLD, APP_SIZE[0], APP_SIZE[1]

    # 1. build: the dense-slot world through W1, and its compact form
    terrain.launches = 0
    t0 = time.perf_counter()
    bm = build_brickmap_terrain(dims, 32, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    w1_launches = terrain.launches
    if w1_launches != dims[2] // 32:
        raise SystemExit(f"app frame: the dense-slot build launched W1 {w1_launches} times, not once a slab")
    want = build_brickmap_terrain_compact(dims, 32, device=dev)
    got = compact_brickmap(bm)
    d = {k: int((getattr(got, k) != getattr(want, k)).sum()) if getattr(got, k).shape == getattr(want, k).shape
         else "shape" for k in ("meta", "brick_idx", "bricks")}
    say(f"app frame: world {dims} f32 with dense slots built through W1 in {t_build:.2f} s ({w1_launches} W1 launches, "
        f"{bm.bricks.shape[0]} bricks, {bm.bricks.numel() * 4 / 1e6:.1f} MB); compact_brickmap of it vs "
        f"build_brickmap_terrain_compact ({want.bricks.shape[0]} bricks): diffs {json.dumps(d)}, on {card}")
    if any(d.values()):
        raise SystemExit("app frame: compact_brickmap of the dense-slot world differs from the compact build")
    del want, got

    # 2. frames through the facade
    rt = VoxelRaytracer3D(line_table=True)
    t0 = time.perf_counter()
    rt.upload_world(bm)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    lt = rt.line_table
    g = Graphics(W, H, device=dev, tile_order=True, shadow_rays=True, ao_samples=APP_AO, reflections=True)
    cfg = g.config
    env = g.environment
    origin = np.array([dims[0] / 2, APP_CAMERA_Y, dims[2] / 2], np.float32)  # the main path's camera
    euler = np.array([-0.25, 0.75, 0.0], np.float32)
    per_frame = 3 + cfg.ao_samples  # primary, shadow, reflection, AO

    bigtrace.launches = 0  # the app frames' launches only
    g.render_screen(rt, origin, euler)  # warm-up, frame 0
    torch.cuda.synchronize()
    counts = [bigtrace.launches]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, FRAMES + 1):
        fb = g.render_screen(rt, origin, euler + np.float32(1e-5 * i))  # the persistent framebuffer
        counts.append(bigtrace.launches)
    end.record()
    torch.cuda.synchronize()
    frame_launches = bigtrace.launches
    frame_ms = start.elapsed_time(end) / FRAMES
    if any(b != a + per_frame for a, b in zip([0] + counts, counts)):
        raise SystemExit(f"app frame: K1 was not launched {per_frame} times a frame: launch counts {counts}")
    if tuple(fb.shape) != (H, W, 3) or not bool(torch.isfinite(fb).all()) or float(fb.min()) < 0 or float(fb.max()) > 1:
        raise SystemExit("app frame: framebuffer has the wrong shape or values outside [0, 1]")
    say(f"app frame: upload_world (line table + brick lines) {t_upload * 1e3:.1f} ms; {W}x{H} checkerboard tile_order, "
        f"shadows, AO {cfg.ao_samples}, reflections, use_macro={cfg.trace_use_macro}, {FRAMES} chained render_screen "
        f"frames: {frame_ms:.3f} ms/frame, K1 launches {frame_launches} ({per_frame} a frame), "
        f"framebuffer checksum {float(fb.double().sum()):.6f}, on {card}")

    # 3. gates.  Every batch of the next frame through K1 against the plain
    # macro walk on the same rays: all rays, and the rays whose primary hit
    def plain(bm_, o, d, ms):
        return trace_brickmap_lt(bm_, lt, o, d, ms, use_macro=cfg.trace_use_macro)

    fn = FRAMES + 1
    e_gate = euler + np.float32(1e-5 * fn)
    origin_t, euler_t = (torch.from_numpy(a).to(dev) for a in (origin, e_gate))
    batches = app_batches(bm, lt, cfg, origin_t, euler_t, env, fn)
    primary_hit = batches[0][4].hit
    k1_total = {"rays": 0, "steps": 0, "events": 0, "table": 0, "ms": 0.0, "plain_ms": 0.0}
    plain_primary = None
    for kind, o, d, ms, res in batches:
        want, p_ms = events_ms(lambda: plain(bm, o, d, ms))
        if kind == "primary":
            plain_primary = want
        every, hits = full_diffs(res, want), full_diffs(res, want, primary_hit)
        args, kw = line_kernel_args(bm, lt, o, d, ms)
        k_ms = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=cfg.trace_use_macro, **kw), repeats=10)
        _, ph = trace_brickmap_hbm(bm, lt, o, d, ms, use_macro=cfg.trace_use_macro, return_phases=True)
        events = sum(int(ph[k].sum()) for k in EVENTS)
        k1_total["rays"] += o.shape[0]
        k1_total["steps"] += int(res.steps.sum())
        k1_total["events"] += events
        k1_total["table"] += hit_table_bytes(want, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick)
        k1_total["ms"] += k_ms
        k1_total["plain_ms"] += p_ms
        say(f"app frame: {kind} batch ({o.shape[0]} rays, max_steps {ms}, hits {int(want.hit.sum())}): K1 vs plain "
            f"(tolerance: bit-equal) diffs (hit, steps, normal, position) on all rays {every}, on the primary hits "
            f"{hits}; K1 {k_ms:.4f} ms, plain {p_ms:.1f} ms, sum(steps) {int(res.steps.sum())}, executed events "
            f"{events}, on {card}")
        if any(every):
            raise SystemExit(f"app frame: K1 disagrees with its plain version on the {kind} batch")

    n_next = [FRAMES + 1]  # the frame number g renders next
    primary_cache = {fn % 2: plain_primary}  # plain primaries of the gate camera, by frame parity

    def cached_primary(f):
        if f % 2 not in primary_cache:
            from voxelengine_tpu_torch.render.frame import primary_rays

            po, pd, _, _, _ = primary_rays(cfg, origin_t, euler_t, f)
            primary_cache[f % 2] = plain(bm, po, pd, cfg.max_steps)
        return primary_cache[f % 2]

    def gfx_gate(what, reuse_primary=True, ortho_size=None):
        """Render g's next frame on the gate camera through K1 and the same
        frame into a copy of the framebuffer through plain traces."""
        f = n_next[0]
        fb_prev = fb.clone()
        g.render_screen(rt, origin, e_gate)
        n_next[0] += 1
        want = render_plain(bm, fb_prev, origin_t, euler_t, env, f, g.config, plain, ortho_size=ortho_size,
                            primary=cached_primary(f) if reuse_primary else None)
        pixel_gate(what, fb, want, card)

    gfx_gate("the frame through K1 vs the same frame through plain traces")
    for view in (DebugView.DEBUG, DebugView.NORMALS, DebugView.DEPTH, DebugView.STEPS):
        g.set_debug_view(view)
        gfx_gate(f"{view.name} view through K1")
    g.set_debug_view(DebugView.SHADED)

    # a block permutation from the gate frame's steps, and the frame without it
    perm = block_permutation_from_steps(batches[0][4].steps, cfg)
    a = render_frame(bm, make_framebuffer(cfg, dev), origin_t, euler_t, env, fn, cfg, lt=lt, block_perm=perm)
    b = render_frame(bm, make_framebuffer(cfg, dev), origin_t, euler_t, env, fn, cfg, lt=lt)
    pixel_gate("frame with block_permutation_from_steps vs without", a, b, card)

    # an odd height
    c719 = dataclasses.replace(cfg, height=H - 1)
    a = render_frame(bm, make_framebuffer(c719, dev), origin_t, euler_t, env, fn, c719, lt=lt)
    b = render_plain(bm, make_framebuffer(c719, dev), origin_t, euler_t, env, fn, c719, plain)
    pixel_gate(f"{W}x{H - 1} checkerboard frame through K1", a, b, card)

    # orthographic, zoomed through the facade
    g.set_projection(Projection.ORTHOGRAPHIC)
    g.set_ortho_window_size(APP_ORTHO)
    gfx_gate(f"orthographic frame at zoom {APP_ORTHO} through K1", reuse_primary=False,
             ortho_size=torch.tensor(APP_ORTHO, dtype=torch.float32, device=dev))
    g.set_projection(Projection.PERSPECTIVE)

    # 4. edits: break and place under the crosshair (voxel_app.py:318-336),
    # then 62 random edits, pairs of them in one brick word
    def crosshair_edit(place: bool):
        aim = np.array([-0.8, 0.75, 0.0], np.float32)  # looking down at the ground
        fwd, _, _ = get_directions_np(aim)
        res = rt.raytrace(origin[None], fwd[None], cfg.max_steps)
        if not bool(res.valid[0]):
            raise SystemExit("app frame: the crosshair ray missed the ground")
        p, n = res.hit_point[0].cpu().numpy(), res.normal[0].cpu().numpy()
        tgt = p - 0.5 * n if place else p + 0.5 * n
        v = np.clip(tgt.astype(int), 0, np.array(dims) - 1)
        return v[None], np.array([place])

    rng = np.random.default_rng(7)
    pts = rng.integers(0, dims, (31, 3))
    pts = np.concatenate([pts, pts + [1, 0, 0]])
    pts = np.clip(pts, 0, np.array(dims) - 1)
    random_edit = (pts, rng.random(62) < 0.5)
    before = [t.clone() for t in (bm.meta, bm.brick_idx, bm.bricks)]
    edits = []
    for edit in ("break", "place", "random"):
        e = crosshair_edit(edit == "place") if edit != "random" else random_edit
        edits.append(e)
        rt.edit_voxels(*(torch.from_numpy(e[0][:, i].copy()).to(dev) for i in range(3)), torch.from_numpy(e[1]).to(dev))
    changed = int((rt.world.bricks != before[2]).sum())
    ref = dataclasses.replace(bm, meta=before[0], brick_idx=before[1], bricks=before[2])
    for pts_, vals in edits:
        apply_edits(ref, *(torch.from_numpy(pts_[:, i].copy()).to(dev) for i in range(3)), torch.from_numpy(vals).to(dev))
    fresh = make_line_table(rt.world)
    d = {k: int((getattr(rt.world, k) != getattr(ref, k)).sum()) for k in ("meta", "bricks")}
    d.update({k: int((getattr(lt, k) != getattr(fresh, k)).sum()) for k in ("region_lines", "macro", "macro2")})
    d["brick_lines"] = int((lt.brick_lines != brick_lines_view(rt.world)).sum())
    say(f"app frame: 64 edits through edit_voxels (break {edits[0][0][0].tolist()}, place {edits[1][0][0].tolist()}, "
        f"62 random): {changed} brick words changed; vs apply_edits on a copy and make_line_table of the edited "
        f"world, word diffs (tolerance: bit-equal) {json.dumps(d)}, on {card}")
    if any(d.values()):
        raise SystemExit("app frame: the edited world or its line table differs from a rebuild")
    del ref, before
    gfx_gate("frame after the edits through K1", reuse_primary=False)
    frame_kernels, frame_dev = kernel_profile(lambda: g.render_screen(rt, origin, e_gate))
    if frame_kernels:
        say(f"app frame: one render_screen frame launches {len(frame_kernels)} CUDA kernels, "
            f"{sum(frame_dev):.3f} ms of device time (torch.profiler), on {card}")

    def edit_ms(pts_, vals):  # the same edits again: the world does not change
        args = tuple(torch.from_numpy(pts_[:, i].copy()).to(dev) for i in range(3)) + (torch.from_numpy(vals).to(dev),)
        return cuda_ms(lambda: rt.edit_voxels(*args), repeats=10)

    all_pts = np.concatenate([e[0] for e in edits])
    all_vals = np.concatenate([e[1] for e in edits])
    e1_ms, e64_ms = edit_ms(edits[0][0], edits[0][1]), edit_ms(all_pts, all_vals)
    say(f"app frame: edit_voxels latency (CUDA events, mean of 10): K=1 {e1_ms:.3f} ms, K=64 {e64_ms:.3f} ms, "
        f"on {card}")

    # 5. the facade's batch queries: K1 on this world, K4 on a TILED_LINEAR
    # one (and a Graphics frame there through K4)
    fields = ("valid", "hit_point", "normal", "distance", "voxel_index", "steps")

    def batch_gate(rt_, name, o, d):
        got_ = rt_.raytrace(o, d, cfg.max_steps)
        want_, p_ms_ = events_ms(lambda: raytracer.results_from_trace(
            rt_.world, o, trace_brickmap(rt_.world, o, d, cfg.max_steps)))
        diffs = {k: int((getattr(got_, k) != getattr(want_, k)).reshape(o.shape[0], -1).any(dim=1).sum())
                 for k in fields}
        say(f"app frame: raytrace of {o.shape[0]} random rays through {name}: RayTraceResults field diffs vs the "
            f"plain walk (tolerance: bit-equal) {json.dumps(diffs)}, hits {int(want_.valid.sum())}, "
            f"last_kernel_ms {rt_.last_kernel_ms:.3f}, plain {p_ms_:.1f} ms, on {card}")
        if any(diffs.values()):
            raise SystemExit(f"app frame: raytrace through {name} differs from the plain walk")
        out_ = TraceOut(want_.valid, want_.hit_point, want_.normal, want_.steps)
        return out_, p_ms_

    o, d = random_rays(dims, FACADE_RAYS, 1.5, 301, dev)
    bigtrace.launches = 0  # the facade's K1 path
    k1_out, p_ms = batch_gate(rt, "K1", o, d)
    raytrace_launches = bigtrace.launches

    grid = BitGrid.from_dense(random_grid((128, 128, 128), 0.01, 9, dev))
    rt2 = VoxelRaytracer3D()
    rt2.upload_voxel_buffer(grid, 8)
    if rt2.line_table is not None or rt2.world.coarse_layout.name != "TILED_LINEAR":
        raise SystemExit("app frame: upload_voxel_buffer did not build a TILED_LINEAR world without a line table")
    o2, d2 = random_rays((128, 128, 128), FACADE_RAYS, 1.5, 302, dev)
    bmtrace.launches = 0  # the facade's K4 path and a Graphics frame
    k4_out, p2_ms = batch_gate(rt2, "K4", o2, d2)
    g2 = Graphics(W, H, device=dev, tile_order=True, shadow_rays=True, ao_samples=APP_AO, reflections=True)
    o4, e4 = np.array([64.0, 90.0, -30.0], np.float32), np.array([-0.5, 0.2, 0.0], np.float32)
    k4_frame = g2.render_screen(rt2, o4, e4)
    k4_launches = bmtrace.launches
    if (raytrace_launches, k4_launches) != (1, 1 + per_frame):
        raise SystemExit(f"app frame: raytrace launched K1 {raytrace_launches} times (not 1), raytrace and a frame "
                         f"over the TILED_LINEAR world K4 {k4_launches} times (not {1 + per_frame})")
    pixel_gate("Graphics frame over the TILED_LINEAR world through K4", k4_frame,
               render_plain(rt2.world, make_framebuffer(g2.config, dev), torch.from_numpy(o4).to(dev),
                            torch.from_numpy(e4).to(dev), g2.environment, 0, g2.config, trace_brickmap), card)

    # times of the facade's calls and of the kernels alone (ray setup excluded)
    call_ms = cuda_ms(lambda: rt.raytrace(o, d, cfg.max_steps), repeats=5)
    call2_ms = cuda_ms(lambda: rt2.raytrace(o2, d2, cfg.max_steps), repeats=5)
    args, kw = line_kernel_args(bm, lt, o, d, cfg.max_steps)
    k1_ms = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=False, **kw), repeats=10)
    bm2 = rt2.world
    dd, start_c, _, active = _ray_setup(bm2.grid_dims, bm2.factor, o2, d2)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm2.grid_dims, torch.int32, dev), dd)
    k4_ms = cuda_ms(lambda: bmtrace.bmtrace(
        start_c, dd, active.to(torch.int32), pad, bm2.meta, bm2.bricks, grid_dims=bm2.grid_dims, factor=bm2.factor,
        max_steps=cfg.max_steps, coarse_layout=bm2.coarse_layout, brick_layout=bm2.brick_layout), repeats=10)
    say(f"app frame: raytrace of {FACADE_RAYS} rays {call_ms:.3f} ms through K1 (K1 alone {k1_ms:.3f} ms), "
        f"{call2_ms:.3f} ms through K4 (K4 alone {k4_ms:.3f} ms) (CUDA events), on {card}")
    k1_raytrace = kernel_entry(
        "bigtrace_raytrace", "bigtrace.cu", "voxelengine_tpu/ops/pallas_bigtrace.py:1348", raytrace_launches, 0.0,
        k1_ms, p_ms, o.shape[0], hit_table_bytes(k1_out, dims, bm.brick_layout, bm.factor, bm.words_per_brick),
        int(k1_out.steps.sum()), raytrace_ms=call_ms,
    )
    k4_raytrace = kernel_entry(
        "bmtrace_raytrace", "bmtrace.cu", "voxelengine_tpu/ops/pallas_trace2.py:39", k4_launches, 0.0, k4_ms, p2_ms,
        o2.shape[0], hit_table_bytes(k4_out, bm2.world_dims, bm2.brick_layout, bm2.factor, bm2.words_per_brick),
        int(k4_out.steps.sum()), raytrace_ms=call2_ms,
    )

    k1_frame = kernel_entry(
        "bigtrace_app_frame", "bigtrace.cu", "voxelengine_tpu/ops/pallas_bigtrace.py:1348", frame_launches, 0.0,
        k1_total["ms"], k1_total["plain_ms"], k1_total["rays"], k1_total["table"], k1_total["steps"],
        k1_total["events"] if cfg.trace_use_macro else None, batches_per_frame=per_frame, frame_ms=frame_ms,
        kernels_per_frame=frame_kernels and len(frame_kernels), frame_device_ms=frame_dev and sum(frame_dev),
        edit_ms_k1=e1_ms, edit_ms_k64=e64_ms,
    )
    return [k1_frame, k1_raytrace, k4_raytrace]



# phase 12, the single-device remainder: the noise library's points, the 2D
# worlds (tests/test_dda2d.py's 64^2 world and the 2D demo's 512^2 world at
# factor 8 with its 1,000,000 radial rays), the record kernel's rays and
# the app's scripted input ('f' breaks, 'g' places, 'b' boosts, a drag
# pitches the camera down at the terrain, a scroll zooms)
NOISE_POINTS = 1 << 16
NOISE_SEED = -123457
DEMO_2D = (512, 8, 1_000_000)  # apps/dda2d_demo.py defaults: world, factor, rays
CROSSING_RAYS = 32
APP_SCRIPT = [["w"], ["drag:0,300"], ["f"], ["b", "w", "right"], ["g"], ["scroll:1"], ["a"]] + [[]] * 17


def noise_cases(N, pos, p01):
    """name -> thunk of every noise of the library beyond the worldgen
    subset, on ``pos`` (and ``p01``, ``pos`` scaled for the repeaters)."""
    B, S = N.Basis, N.Shape
    s = NOISE_SEED
    cases = {
        "simplex_noise": lambda: N.simplex_noise(pos, 0.37, s),
        "checker": lambda: N.checker(pos, 0.75, s),
        "discrete_noise": lambda: N.discrete_noise(pos, 0.5, s),
        "linear_value": lambda: N.linear_value(pos, 3.0, s),
        "faded_value": lambda: N.faded_value(pos, 1.0, s),
        "cubic_value": lambda: N.cubic_value(pos, 0.8, s),
        "worley_noise": lambda: N.worley_noise(pos, 1.0, s, 0.5, 2, 4, 0.9),
        "spots_step": lambda: N.spots(pos, 1.0, s, 0.3, 0, 3, 1.0, S.STEP),
        "spots_linear": lambda: N.spots(pos, 1.0, s, 0.3, 1, 3, 1.0, S.LINEAR),
        "spots_quadratic": lambda: N.spots(pos, 1.0, s, 0.3, 0, 2, 0.7, S.QUADRATIC),
        "vector_noise": lambda: N.vector_noise(pos[:, 0], pos[:, 1], pos[:, 2]),
        "random_grid": lambda: N.random_grid(pos[:, 0], pos[:, 1], pos[:, 2], 17.0),
        "repeater_perlin_bounded": lambda: N.repeater_perlin_bounded(p01, 1.0, s, 5, 2.0, 0.5, 0.3),
        "repeater_perlin_abs": lambda: N.repeater_perlin_abs(p01, 1.0, s, 4, 2.0, 0.5),
        "repeater_simplex": lambda: N.repeater_simplex(p01, 1.0, s, 4, 2.0, 0.5),
        "repeater_simplex_abs": lambda: N.repeater_simplex_abs(p01, 1.0, s, 4, 2.0, 0.5),
        "repeater_simplex_bounded": lambda: N.repeater_simplex_bounded(p01, 1.0, s, 4, 2.0, 0.5, 0.2),
        "fractal_simplex": lambda: N.fractal_simplex(p01, 1.0, s, 0.05, 8, 2.0, 0.5),
        "turbulence": lambda: N.turbulence(p01, 0.5, 0.25, s, 3.0, B.WORLEY, B.CUBICVALUE),
        "repeater_turbulence": lambda: N.repeater_turbulence(p01, 0.5, 1.0, s, 2.0, 2, B.PERLIN, B.SIMPLEX),
    }
    for b in B:
        cases[f"repeater_{b.name}"] = (lambda b=b: N.repeater(p01, 1.0, s, 2, 2.0, 0.5, b))
    return cases


def phase_noise_library(dev):
    """Every noise beyond the worldgen subset on the card against the CPU,
    on the same 65,536 points (small, medium and large coordinates)."""
    import numpy as np
    import torch

    from voxelengine_tpu_torch.ops import noise as N

    rng = np.random.default_rng(21)
    third = NOISE_POINTS // 3
    pts = np.concatenate([rng.uniform(-4, 4, (third, 3)), rng.uniform(-600, 600, (third, 3)),
                          rng.uniform(-2e5, 2e5, (NOISE_POINTS - 2 * third, 3))]).astype(np.float32)
    cpu_pos = torch.from_numpy(pts)
    cpu = noise_cases(N, cpu_pos, cpu_pos * 0.01)
    card_pos = cpu_pos.to(dev)
    card = noise_cases(N, card_pos, card_pos * 0.01)
    diffs = {}
    for name, fn in cpu.items():
        a, b = fn(), card[name]().cpu()
        diffs[name] = int((a != b).sum()) if a.shape == b.shape else -1
    bad = {k: v for k, v in diffs.items() if v}
    say(f"noise library: {len(diffs)} functions on {NOISE_POINTS} points, card against CPU (tolerance: bit-equal): "
        f"{sum(1 for v in diffs.values() if v == 0)} with 0 diffs{'; differing: ' + json.dumps(bad) if bad else ''}")
    if bad:
        raise SystemExit("noise library: the card's values differ from the CPU's")


def test_world_2d():
    """``tests/test_dda2d.py``'s 64^2 world (its fixture's seed)."""
    import numpy as np

    rng = np.random.default_rng(0xC0FFEE)
    dense = rng.random((64, 64)) < 0.05
    dense[26:38, 26:38] = False
    dense[0, :] = dense[-1, :] = True
    dense[:, 0] = dense[:, -1] = True
    return dense


def trace_diffs(got, want) -> dict:
    h, s, n, p = full_diffs(got, want)
    return dict(hit=h, steps=s, normal=n, position=p)


def phase_2d(dev, tmp):
    """K1 and K2 on 2D worlds against the plain walk, the two-level against
    single-level property, the 2D demo; returns their records."""
    import numpy as np
    import torch

    from voxelengine_tpu_torch.apps import dda2d_demo
    from voxelengine_tpu_torch.config import MAX_STEPS
    from voxelengine_tpu_torch.kernels import bigtrace, gridtrace
    from voxelengine_tpu_torch.ops import dda2d
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines
    from voxelengine_tpu_torch.ops.trace import trace_brickmap, trace_grid

    card = card_line()
    W, f, n = DEMO_2D
    worlds = {
        "64^2 test world": (torch.from_numpy(test_world_2d()).to(dev), (32.0, 32.0), 256),
        f"{W}^2 demo world": (dda2d_demo.make_world(W, dev), (W / 2.0, W / 2.0), n),
    }
    for name, (dense, center, count) in worlds.items():
        g, bm = dda2d.grid2d_from_dense(dense), dda2d.brickmap2d_from_dense(dense, f)
        lt = materialize_brick_lines(bm, make_line_table(bm))
        o, r = dda2d.radial_rays(center, count)
        o3, r3 = dda2d._lift(o, r, dev)
        k1, k2 = dda2d.trace_brickmap_2d(bm, o, r, lt=lt), dda2d.trace_grid_2d(g, o, r)
        p1, p1_ms = events_ms(lambda: trace_brickmap(bm, o3, r3))
        p2, p2_ms = events_ms(lambda: trace_grid(g, o3, r3))
        d1, d2 = trace_diffs(k1, p1), trace_diffs(k2, p2)
        say(f"2D ({name}, {count} radial rays, grid {g.dims}, brickmap {bm.grid_dims} chunks at factor {f}, "
            f"{lt.num_regions} regions): K1 against the plain trace_brickmap {json.dumps(d1)}, K2 against the plain "
            f"trace_grid {json.dumps(d2)} (tolerance: bit-equal); hits {int(k1.hit.sum())}, on {card}")
        if any(d1.values()) or any(d2.values()):
            raise SystemExit(f"2D ({name}): a kernel differs from the plain walk")
        if count == 256:  # tests/test_dda2d.py:29-47 on the card
            far = int(((k2.position[:, :2] - k1.position[:, :2]).abs().amax(dim=1) > 2e-3).sum())
            ok = bool(torch.equal(k1.hit, k2.hit) and k2.hit.all() and (k2.position[:, 2] == 0.5).all()
                      and far <= 4)
            say(f"2D ({name}): two-level against single-level: hits equal and all hit, z never stepped, "
                f"{far} corner-degenerate rays beyond 2e-3 (at most 4 allowed): {ok}")
            if not ok:
                raise SystemExit("2D: the two-level trace breaks the single-level property")
            continue
        args, kw = line_kernel_args(bm, lt, o3, r3, MAX_STEPS)
        k1_ms = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=False, **kw), repeats=10)
        k2_ms = cuda_ms(lambda: gridtrace.gridtrace(o3, r3, g.words, dims=g.dims, layout=g.layout,
                                                    max_steps=MAX_STEPS), repeats=10)
        # each kernel's path, counts at 0 just before: the 2D demo (K1: a
        # warm-up and a timed trace) and trace_grid_2d (K2)
        bigtrace.launches = 0
        dda2d_demo.main(["--world", str(W), "--factor", str(f), "--rays", str(n), "--out", str(Path(tmp) / "dda2d.ppm"),
                         "--device", str(dev)])
        k1_launches = bigtrace.launches
        gridtrace.launches = 0
        dda2d.trace_grid_2d(g, o, r)
        k2_launches = gridtrace.launches
        say(f"2D ({name}): K1 alone {k1_ms:.3f} ms ({n / k1_ms / 1e3:.1f} Mrays/s), plain trace_brickmap "
            f"{p1_ms:.1f} ms; K2 alone {k2_ms:.3f} ms ({n / k2_ms / 1e3:.1f} Mrays/s), plain trace_grid "
            f"{p2_ms:.1f} ms (CUDA events); the demo launched K1 {k1_launches} times, trace_grid_2d K2 "
            f"{k2_launches} time(s), on {card}")
        return [
            kernel_entry("bigtrace_2d", "bigtrace.cu", "voxelengine_tpu/ops/pallas_bigtrace.py:1348", k1_launches,
                         0.0, k1_ms, p1_ms, n,
                         hit_table_bytes(k1, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick),
                         int(k1.steps.sum())),
            kernel_entry("gridtrace_2d", "gridtrace.cu", "voxelengine_tpu/ops/pallas_trace.py:329", k2_launches,
                         0.0, k2_ms, p2_ms, n, hit_table_bytes(k2, g.dims, g.layout), int(k2.steps.sum()),
                         ray_bytes=grid_ray_bytes(o3, r3)),
        ]


def phase_crossings(dev):
    """The record instantiation of K1's loop against its plain version on 32
    rays of the demo world and of the sparse 16k world, macro on and off,
    its results against K1's; returns its record."""
    import torch

    from voxelengine_tpu_torch.config import MAX_STEPS
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.kernels import bigtrace, crossings
    from voxelengine_tpu_torch.ops import crossing_trace as C
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines

    card = card_line()
    demo = build_brickmap_terrain_compact(WORLDS["demo"][0], 32, device=dev)
    sparse = sparse_world(dev)
    rays = {"demo": random_rays(WORLDS["demo"][0], CROSSING_RAYS, 1.5, 401, dev),
            "sparse 16k": sparse_rays(CROSSING_RAYS, dev)}
    timing = None
    for name, bm in (("demo", demo), ("sparse 16k", sparse)):
        lt = materialize_brick_lines(bm, make_line_table(bm))
        o, d = rays[name]
        for use_macro in (True, False):
            rec, p_ms = events_ms(lambda: C.record_crossings(bm, lt, o, d, MAX_STEPS, use_macro))
            plain, plain_ms = events_ms(lambda: C._record_plain(bm, lt, o, d, MAX_STEPS, use_macro))
            args, kw = line_kernel_args(bm, lt, o, d, MAX_STEPS)
            k1 = bigtrace.bigtrace(*args, use_macro=use_macro, **kw)
            nrows = rec[1].long()
            row_diffs = sum(int((rec[0][i, :nrows[i]] != plain[0][i, :nrows[i]]).any(dim=1).sum())
                            for i in range(o.shape[0]))
            out_diffs = [int((a != b).reshape(a.shape[0], -1).any(dim=1).sum()) for a, b in zip(rec[2:], plain[2:])]
            k1_diffs = [int((a != b).reshape(a.shape[0], -1).any(dim=1).sum()) for a, b in zip(rec[2:], k1)]
            last = rec[0][torch.arange(o.shape[0], device=dev), (nrows - 1).clamp_min(0)]
            ran = nrows > 0
            last_diffs = int(((last[:, C.STEPS] != k1[3]) & ran).sum()
                             + (((last[:, C.STATE] >> 2) & 1 != (k1[0] & 1)) & ran).sum())
            say(f"record kernel ({name} world, macro {'on' if use_macro else 'off'}, {o.shape[0]} rays, "
                f"{int(nrows.sum())} rows): rows against the plain record {row_diffs} diffs, row counts "
                f"{int((rec[1] != plain[1]).sum())} diffs, results {out_diffs}; results against K1 {k1_diffs}, "
                f"last rows' steps and hit against K1 {last_diffs} (tolerance: bit-equal); record {p_ms:.2f} ms, "
                f"plain {plain_ms:.1f} ms (CUDA events), on {card}")
            if row_diffs or int((rec[1] != plain[1]).sum()) or any(out_diffs) or any(k1_diffs) or last_diffs:
                raise SystemExit(f"record kernel ({name}, macro {use_macro}): differs from its plain version or K1")
            if timing is None:
                timing = (bm, lt, o, d, use_macro, int(nrows.sum()), plain_ms)
    bm, lt, o, d, use_macro, rows, plain_ms = timing
    args, kw = line_kernel_args(bm, lt, o, d, MAX_STEPS)
    ms = cuda_ms(lambda: crossings.crossings(*args, use_macro=use_macro, max_rows=C.iter_limit(MAX_STEPS), **kw),
                 repeats=5)
    crossings.launches = 0  # its path: one dump through the entry point
    dump = C.trace_ray_crossings(bm, lt, o[0], d[0], MAX_STEPS)
    launches = crossings.launches
    say(f"record kernel: {ms:.3f} ms for {o.shape[0]} rays ({ms / o.shape[0]:.3f} ms a ray, one thread a ray), "
        f"plain {plain_ms:.1f} ms; trace_ray_crossings: {dump['iterations']} rows, hit {dump['hit']}, launched it "
        f"{launches} time(s), on {card}")
    # a one-thread diagnostic: its least time is the bytes it writes (the
    # rows, the row counts and the results) and reads (the rays)
    n = o.shape[0]
    out_bytes = rows * C.FIELDS * 4 + n * (4 + RAY_BYTES)
    return {
        "name": "crossings", "route": "cuda", "source": "voxelengine_tpu_torch/csrc/crossings.cu",
        "replaces": "voxelengine_tpu/ops/crossing_trace.py:67 (pallas_bigtrace.py:753)", "launches": launches,
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": out_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None, "rays": n, "rows": rows, "ms_per_ray": ms / n,
    }


def phase_apps(dev, tmp):
    """The ported app headless under a scripted input (default flags with
    shadows, AO 4 and reflections; --dense; --xla-trace; --macro auto), its
    edits against ``apply_edits`` on a copy, and ``bench_configs``."""
    import os

    import torch

    from voxelengine_tpu_torch.apps import bench_configs, voxel_app
    from voxelengine_tpu_torch.core.brickmap import apply_edits
    from voxelengine_tpu_torch.engine.raytracer import VoxelRaytracer3D
    from voxelengine_tpu_torch.io.checkpoint import load_world
    from voxelengine_tpu_torch.kernels import bigtrace, bmtrace, gridtrace
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table
    from voxelengine_tpu_torch.runtime.input import ScriptedInput

    card = card_line()
    edits = []
    real_edit = VoxelRaytracer3D.edit_voxels

    def recorded(self, x, y, z, value):
        edits.append((int(x[0]), int(y[0]), int(z[0]), bool(value)))
        return real_edit(self, x, y, z, value)

    runs = {
        "default --shadows --ao 4 --reflections": (["--shadows", "--ao", "4", "--reflections"], bigtrace),
        "--dense (128^3)": (["--dense", "--size", "128", "128", "128"], gridtrace),
        "--xla-trace": (["--xla-trace"], bmtrace),
        "--macro auto": (["--macro", "auto"], bigtrace),
    }
    cwd = os.getcwd()
    os.chdir(tmp)
    VoxelRaytracer3D.edit_voxels = recorded
    real_input = voxel_app.best_input
    voxel_app.best_input = lambda scripted=None: ScriptedInput(APP_SCRIPT)
    frame_ms = None
    try:
        for name, (flags, kernel) in runs.items():
            edits.clear()
            kernel.launches = 0  # the run is the kernel's path
            run = voxel_app.main(["--frames", str(len(APP_SCRIPT)), "--record", *flags])
            launches = kernel.launches
            ms = run.seconds * 1e3 / run.frames
            fb_ok = bool(torch.isfinite(run.framebuffer).all())
            line = (f"app ({name}): {run.frames} frames, {ms:.2f} ms/frame (host clock, frames presented, device "
                    f"synchronised at the end), {kernel.__name__.split('.')[-1]} launched {launches} times, "
                    f"{len(edits)} crosshair edits, framebuffer finite: {fb_ok}")
            if run.rt is not None and edits:
                X, Y, Z = run.rt.world.world_dims
                base = load_world(f".worlds_cache/terrain_{X}x{Y}x{Z}_f32_o32.npz", dev)
                want = apply_edits(base, *(torch.tensor([e[k] for e in edits], device=dev) for k in range(3)),
                                   torch.tensor([e[3] for e in edits], device=dev))
                same = all(torch.equal(getattr(run.rt.world, k), getattr(want, k)) for k in ("meta", "brick_idx",
                                                                                             "bricks"))
                lt_want, lt_got = make_line_table(want), run.rt.line_table
                same_lt = lt_got is None or all(torch.equal(getattr(lt_got, k), getattr(lt_want, k))
                                                for k in ("region_lines", "macro", "macro2"))
                line += f"; world after the edits equals apply_edits on a copy: {same}, its line table: {same_lt}"
                if not (same and same_lt):
                    raise SystemExit(f"app ({name}): the edited world differs from apply_edits on a copy")
            say(line + f", on {card}")
            if launches < 1 or not fb_ok or (run.rt is not None and len(edits) != 2):
                raise SystemExit(f"app ({name}): no kernel launch, a non-finite frame or the crosshair edits missed")
            frame_ms = frame_ms or ms
        VoxelRaytracer3D.edit_voxels = real_edit
        for fn in (bench_configs.config1, bench_configs.config2, bench_configs.config3, bench_configs.config5):
            t0 = time.perf_counter()
            line = fn()
            say(f"bench_configs [{fn.__name__}] {line} (setup+run {time.perf_counter() - t0:.1f} s), on {card}")
            if fn is bench_configs.config1 and not line.startswith("oracle parity: 100/100"):
                raise SystemExit("bench_configs config1: the kernel's hits differ from the oracle's")
    finally:
        VoxelRaytracer3D.edit_voxels = real_edit
        voxel_app.best_input = real_input
        os.chdir(cwd)
    return frame_ms


def phase_remainder(dev):
    """Phase 12: the single-device remainder; returns the new kernel
    records."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    phase_noise_library(dev)
    (ROOT / "_checkout").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="remainder_", dir=ROOT / "_checkout")
    try:
        kernels = phase_2d(dev, tmp)
        kernels.append(phase_crossings(dev))
        frame_ms = phase_apps(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"single-device remainder: {time.perf_counter() - t0:.1f} s; the app at its defaults with shadows, AO 4 "
        f"and reflections: {frame_ms:.2f} ms/frame, on {card_line()}")
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "voxelengine_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: run it from a checkout; {ROOT} holds no voxelengine_tpu_torch")
    sys.path.insert(0, str(ROOT))
    import voxelengine_tpu_torch  # noqa: F401  (the checkout's package)

    dev = torch.device("cuda", 0)
    say(f"device: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    phase_noise(dev)
    phase_kernel_vs_plain(dev)
    w1 = phase_terrain(dev)
    demo, _ = phase_main_path(dev, "demo")
    bench, w1["launches"] = phase_main_path(dev, "full")
    kernels = [bench, demo, w1]
    err = phase_dense_vs_plain(dev)
    kernels += phase_dense_path(dev, err)
    kernels += phase_bmtrace(dev)
    kernels.append(phase_sparse(dev))
    kernels += phase_app_frame(dev)
    kernels += phase_remainder(dev)
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise SystemExit(f"kernels never launched on their path: {idle}")
    say(f"wall time: {time.perf_counter() - t_start:.1f} s, kernel builds included")
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card_line()}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
