#!/usr/bin/env python3
"""Drive the PyTorch port's render paths once on an NVIDIA GPU.

    python3 chip_smoke.py   # all phases, the 8192x512x8192 bench world included

Phases, one stdout line each (plus the kernels' build logs):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every CUDA kernel (K1-K5, W1, K4-slab, the record, camera, ray-setup and shading kernels) from
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
   shared memory (K4's global-meta instantiation); K4-compact on the
   128^3 rays over that world made compact against the plain trace;
   times, K4 also on the 128^3 rays sorted by direction octant, then start
   chunk;
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
   warm-up plus 8 ``render_screen`` frames (K1 4 times a frame: its rays
   entry and its secondary entry once a kind); on the next frame each
   trace batch (primary, shadow, reflection, 4 AO, the secondary rays built
   eagerly) through K1's rays entry against its plain version on all rays
   and on the primary hits, each secondary entry against its plain version
   (those batches' rays and plain walks), the launch gate (a frame exactly
   6 CUDA kernels), the frame
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
   under ``_checkout/``, removed at the end;
13. multi-device (``voxelengine_tpu_torch/parallel/``): 4 ranks
   (processes, ``parallel/mesh.py::run_ranks``) sharing the one card over
   gloo, collectives staged through host memory, each loading the bench
   world from phase 5's cache: ``render_frame_sharded`` and
   ``render_frame_cyclic`` at 1920x1080 through K1 (a warm-up plus 8
   chained frames), the gathered framebuffer against single-device
   ``render_frame`` at both parities; ``raytrace_sharded`` on 1,048,576
   random rays and its mean against single-device K1; each rank's
   ``make_zsharded_hbm`` row and ``trace_brickmap_hbm_zsharded`` (K1's
   replicated walk) on a frame's rays against single-device K1; on the
   1024^3 app world with dense slots, ``trace_brickmap_zsharded`` (ray
   migration through K4-slab) on a 1280x720 frame's rays and 4,096
   axis-aligned rays against single-device K4, K4-slab against its plain
   slab walk on each rank's round-0 rays, each K4-slab launch of the two
   traces run again alone (ranks in turns) beside its bound, and
   ``render_frame_zsharded``
   with shadows, AO 4 and reflections through K4-slab and through K1
   (and primary-only through K1) against single-device frames; then the
   same on 1 rank over NCCL (2 timed frames).  The parent builds every
   kernel first, so ranks only load the libraries.  Its times are labelled
   as ranks sharing one card: they measure no scale-out;
14. the port's bench harness (``voxelengine_tpu_torch/bench.py``,
   ``bench.run``): the bench world from phase 5's cache through K1
   (``pallas``) and through K4's compact instantiation (``xla``, no line
   table), and the 1024^3 world with its raw bricks kept on the host (the
   16k world's flow), each with its own exactness gate (0 hit diffs) and
   its JSON line; then K4-compact against its plain version on the bench
   frame's 1,036,800 rays and its time, and the instantiation the ``xla``
   run took (by size: the bench world's 4 MB of meta in global memory)
   with its launch counts;
15. the camera and ray-setup kernels: the camera kernel
   (``csrc/camera.cu``: glibc's ``sinf`` and ``cosf``, which the
   reference's XLA:CPU computes, and the basis of ``get_directions``)
   against its plain version (``core/libm.py``) on 1,187,869 angle triples
   (a grid over [-3.3, 3.3], +-64 ulp of every multiple of pi/4 up to 120,
   |x| in [120, 1e5], the bench, demo and drifted cameras), bit for bit;
   ``get_directions`` at the cameras on the card against the CPU port's;
   its time and its plain version's for one triple.  The ray-setup kernel
   (``csrc/rays.cu``: ``primary_rays`` in one launch, the basis included)
   against its plain version (``primary_rays_plain``), 0 word diffs in
   origins, directions, px, py and py_r: the bench frame (both parities),
   the demo frame, a block permutation, no checkerboard, an odd height,
   1x1 pixel blocks, orthographic with a pair and a tensor window, and its
   ``pixels`` entry on 4 ranks' ``band_pixels`` and ``cyclic_pixels``; a
   frame's ray setup is exactly one CUDA kernel, the ray kernel (the
   wrapper's count, and a profile in which no other kernel runs); its time
   and its plain version's on the bench frame;
16. the measurement scripts (``voxelengine_tpu_torch/experiments/``) on
   the bench world from phase 5's cache: the frame breakdown (S0 ray
   setup, S1 with K1, S2 the frame; primary and with shadows, AO 4 and
   reflections: ms a frame over 5 batches, CUDA kernels and device ms a
   frame, busy share), the shard projection (K1 on each rank's pixels for
   N = 2, 4, 8 in row bands and block-cyclic, one shard's frame, frame_N and
   the imbalance) and the 1080p demo image of both fields (its PNG's size
   and checksum, and the pixels apart from the JAX reference's TPU render
   in ``docs/``, information only);
17. the block-cyclic frame at 1920x1080 (32x30 blocks) on 8 gloo ranks
   sharing the card, the 512^3 terrain at 8 octaves built by W1, both
   parities through K1 against single-device ``render_frame``: 0 byte
   diffs.
18. the fused frame kernels on the bench frame (phase 5's cache): K1's
   rays entry (``vx_bigtrace_rays``: the ray setup, the walk and the
   ``hit_imm`` fix-up in one launch) against ``vx_bigtrace`` after the
   eager setup and fix-up, macro on and off, production and diag builds,
   and K4-compact's rays entry against its prepared entry, 0 word diffs;
   the launch gates by ``torch.profiler`` (the trace stage exactly 1 CUDA
   kernel, the primary frame exactly 3: the ray kernel, K1, the shading
   kernel); the shading kernel (``csrc/shade.cu``) against
   ``shade_traced_plain`` and ``composite_frame`` at both parities and its
   ``shade`` entry on 4 ranks' band and cyclic pixels, 0 word diffs in
   color, write and framebuffer; its times and bound.  Its other gates
   run where their worlds are: the demo frame, each debug view, the
   crosshair without checkerboard, 1280x719 and a block permutation in
   phase 5; the dense frame (and its launch gate, 3 CUDA kernels) in phase
   8; the app frame with shadows, AO 4 and reflections in phase 11; K4's
   and K4-compact's rays entries against their prepared entries on the
   random rays in phase 9;
19. the shaded bench frame (shadows, AO 4, reflections; phase 5's cache)
   through the secondary entries of K1 (the line table), K4-compact (no
   line table) and K4 (the world with dense slots): a warm-up plus 8
   chained frames each, the launch gate (a frame exactly 6 CUDA kernels:
   the ray kernel, the rays entry, three secondary entries, the shading
   kernel), each entry against its plain version on every ray of the next
   frame's plain primary trace (0 word diffs), its time and bound.

Each kernel's path (the bench world's frames for K1, the ray kernel and
the shading kernel,
``get_directions`` at the phase-15 cameras for the camera kernel,
and the demo world's for K1's second record; the bench world's build for W1; the frames of
phase 8 for K2, the phase-8 batch for K3 and the 128^3 grid for its global
instantiation, the phase-9 128^3 batch for K4 with shared meta and its
512x256x512 batch for K4 with global meta, the phase-10 batch for K5; the
phase-11 frames for K1 with secondary rays, its ``raytrace`` for K1 on a
batch, its TILED_LINEAR world's ``raytrace`` and frame for K4; the 2D demo for
K1 on a 2D world, one ``trace_grid_2d`` call for K2 on it, one
``trace_ray_crossings`` for the record kernel; in phase 13 each sharded
entry for K1 and the migration traces for K4-slab, counted in every rank;
the harness's ``xla`` run on the bench world for K4-compact; phase 19's
shaded bench frames for each secondary entry)
runs
with the launch counts set to 0 just before it and read just after;
launches made to compare or time a kernel are not counted.  Then the run's
wall time and each phase's, one JSON line describing each kernel (its time, its plain
version's, and its bound: the larger of its bytes (rays in and out plus
the table words its hits need; W1's output) over the card's memory rate
and its operations over the card's instruction issue rate (SMs x 4 x 32 x
the SM clock, read on the card: the kernels fuse no multiply-add; W1's
integer instructions also over the INT32 pipe's half rate); with the macro levels on, the
operations of the DDA events the diag build counts, since a macro skip
charges steps it never walks; for K2 and K3 the bytes of their wrappers'
whole function, origins and raw directions in, the hit byte, position,
normal and steps out; for W1 the instructions a voxel counted in its
SASS, :func:`w1_sass_count`), the card line again, and last
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0)
before the last line.  Needs one CUDA device; there is no CPU fallback.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAMES = 8  # timed chained frames after the warm-up
# H100 SXM peak (NVIDIA data sheet): HBM3 bytes/s.  The operation rates are
# read on the card (issue_rates): the kernels are built with --fmad=false
# and count an integer op as one, so no op is a fused pair and the limit is
# the instruction issue rate, not the data sheet's 67e12 float32 rate (an
# FMA counted as two)
HBM_BYTES_PER_S = 3.35e12
# the prepared-ray entries (K1's vx_bigtrace, K4's and K5's) read start,
# dir, pad (12 B each) and active (4 B) and write flags, steps (4 B each),
# position and normal (12 B each) per ray
RAY_BYTES = 72
# K2, K3 and the rays entries of K1 and K4 read origins and raw directions
# (f32[N, 3] each, fewer bytes where a row is broadcast) and write hit
# (1 B), position, normal (12 B each) and steps (4 B) per ray
GRID_OUT_BYTES = 29
# float ops of one DDA step: the axis pick (3 compares), the two entry
# coordinates off the stepped axis (2 mul + 2 add), the tMax add; ray setup
# and the coarse level's box test are not counted
OPS_PER_STEP = 8
# the DDA events a run executes (diag counters): each one iteration of work
EVENTS = ("mskip", "cadv", "desc", "fstep", "step2", "asc")
SPARSE_RAYS = 1 << 18
# threads a block of each library's kernels (csrc/*.cu)
BLOCK_THREADS = {"bigtrace": 128, "rrtrace": 128, "gridtrace": 128, "bmtrace": 1024, "terrain": 256, "crossings": 32,
                 "zslab": 1024, "camera": 128, "rays": 256, "shade": 256}
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


@functools.cache
def issue_rates() -> dict:
    """The card's instruction rates, a lane-op a second: ``issue`` (4
    schedulers an SM each issue one 32-lane warp instruction a clock: SMs x
    4 x 32 x the SM clock), ``int32`` and ``fp64`` (64 lanes an SM a clock,
    half of it), with the SM count and the clock (``nvidia-smi``'s
    ``clocks.max.sm``) they come from."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    return {"sms": sms, "clock_hz": hz, "issue": sms * 4 * 32 * hz, "int32": sms * 64 * hz, "fp64": sms * 64 * hz}


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
    card's instruction issue rate (:func:`issue_rates`)."""
    bytes_ms = (rays * ray_bytes + table_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = work * OPS_PER_STEP / issue_rates()["issue"] * 1e3
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


def data_bytes(t) -> int:
    """The distinct float32 data of ``t``: a broadcast row counts once."""
    return 4 * math.prod(size for size, stride in zip(t.shape, t.stride()) if stride != 0)


def grid_ray_bytes(origins, rays) -> float:
    """Bytes a ray that K2, K3 or a rays entry of K1 or K4 must move: the
    distinct float32 data of
    ``origins`` and ``rays`` (a broadcast origin counts once) over the rays,
    plus :data:`GRID_OUT_BYTES`."""
    return GRID_OUT_BYTES + (data_bytes(origins) + data_bytes(rays)) / rays.shape[0]


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
    sass = w1_sass_count(OCTAVES)
    rates = issue_rates()
    # the instructions a voxel over the issue rate, and its integer ones
    # over the INT32 pipe's half rate: the larger is the operations' bound
    ops_ms = voxels * max(sass["per_voxel"] / rates["issue"], sass["int_per_voxel"] / rates["int32"]) * 1e3
    hand_ms = voxels * w1_ops_per_voxel(OCTAVES) / rates["issue"] * 1e3
    say(f"terrain: W1's SASS (cuobjdump -sass of {sass['library']}): {json.dumps(sass)}; the hand count "
        f"{w1_ops_per_voxel(OCTAVES)} ops a voxel ({hand_ms:.3f} ms at the issue rate)")
    say(f"times: W1 {ms:.3f} ms, plain solid_at + _slab_to_chunks {plain_ms:.1f} ms on the slab z0={z0} of "
        f"{dims} f{f} ({voxels} voxels, {gx * gy} chunks, {occupied} occupied); bound {max(bytes_ms, ops_ms):.3f} ms "
        f"({sass['per_voxel']} instructions a voxel, {sass['int_per_voxel']} of them integer, over the issue rate "
        f"{rates['issue']:.4g} and the INT32 rate {rates['int32']:.4g} lane-ops/s: {rates['sms']} SMs at "
        f"{rates['clock_hz'] / 1e6:.0f} MHz), W1 at {ms / max(bytes_ms, ops_ms):.3f}x its bound, on {card_line()}")
    return {
        "name": "terrain_slab", "route": "cuda", "source": "voxelengine_tpu_torch/csrc/terrain.cu",
        "replaces": "voxelengine_tpu/core/brickmap.py:284 build_brickmap_terrain_compact (XLA under jax.jit, "
                    "not a pallas_call: a port kernel with no TPU counterpart)",
        "launches": None, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no PyTorch call computes Perlin terrain
        "voxels": voxels, "ops_per_voxel": sass["per_voxel"], "int_ops_per_voxel": sass["int_per_voxel"],
        "hand_ops_per_voxel": w1_ops_per_voxel(OCTAVES), "out_bytes": out_bytes,
    }


# SASS mnemonics by pipe (Hopper): integer arithmetic and logic on the INT32
# pipe; conversions and the rest counted apart
SASS_INT = ("IADD3", "IMAD", "LOP3", "SHF", "ISETP", "IMNMX", "LEA", "SEL", "PRMT", "IABS", "SGXT", "BMSK",
            "POPC", "FLO", "BREV", "VIMNMX", "IMUL")
SASS_FLOAT = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET", "FCHK")
SASS_CONVERT = ("F2I", "I2F", "F2F", "FRND", "I2FP", "F2IP")


def w1_sass_count(octaves: int) -> dict:
    """W1's instructions a voxel from its SASS (``cuobjdump -sass`` of the
    built terrain library): the octave loop is the innermost backward
    branch whose body holds ``floorf``'s FRND (3 an octave, so the body
    holds FRND / 3 octaves, however the compiler unrolled it); the rest of
    a voxel is the enclosing loop's body less that loop.  Each instruction
    is one warp instruction, one op a lane, and a lane computes a voxel."""
    from voxelengine_tpu_torch.kernels import build

    lib = build.kernel_library("terrain")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    part = next(p for p in re.split(r"\n\s*Function : ", sass)[1:] if "terrain_slab" in p.split("\n", 1)[0])
    ins = [(int(a, 16), op.strip()) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
    loops = sorted(((int(m.group(1), 16), a) for a, op in ins
                    if (m := re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", op)) and int(m.group(1), 16) < a),
                   key=lambda t: t[1] - t[0])

    def body(lo, hi):
        return [op.split()[1] if op.startswith("@") else op.split()[0] for a, op in ins if lo <= a <= hi]

    def count(ops, names):
        return sum(1 for op in ops if op.split(".")[0] in names)

    inner = next((lo, hi) for lo, hi in loops if count(body(lo, hi), ("FRND",)) >= 3)
    outer = next(((lo, hi) for lo, hi in loops if lo <= inner[0] and hi >= inner[1] and (lo, hi) != inner), inner)
    ib, ob = body(*inner), body(*outer)
    per = len(ib) / (count(ib, ("FRND",)) / 3)  # instructions an octave
    rest = len(ob) - len(ib)
    per_int = count(ib, SASS_INT) / (count(ib, ("FRND",)) / 3)
    rest_int = count(ob, SASS_INT) - count(ib, SASS_INT)
    return {
        "library": lib.name, "instructions": len(ins), "octave_loop": len(ib),
        "octaves_a_pass": count(ib, ("FRND",)) // 3, "per_octave": per, "int_per_octave": per_int,
        "float_per_octave": count(ib, SASS_FLOAT) / (count(ib, ("FRND",)) / 3),
        "convert_per_octave": count(ib, SASS_CONVERT) / (count(ib, ("FRND",)) / 3),
        "rest_a_voxel": rest, "per_voxel": octaves * per + rest, "int_per_voxel": octaves * per_int + rest_int,
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


def k1_rays_call(bm, lt, o, d, max_steps, use_macro):
    """A call of K1's rays entry on rays ``o``, ``d``, the launch the frame
    path makes (``ops/bigtrace.py::trace_brickmap_k1``), for timing."""
    from voxelengine_tpu_torch.kernels import bigtrace
    from voxelengine_tpu_torch.ops.bigtrace import _kernel_tables

    tables, kw = _kernel_tables(bm, lt, max_steps, use_macro)
    return lambda: bigtrace.bigtrace_rays(o, d, *tables, **kw)


def k4_rays_call(bm, o, d, max_steps):
    """A call of K4's rays entry in ``bm``'s form (dense slots or compact)
    on rays ``o``, ``d``, the launch the frame path makes
    (``ops/trace2.py::_trace_brickmap_kernel``), for timing."""
    from voxelengine_tpu_torch.kernels import bmtrace

    kw = dict(grid_dims=bm.grid_dims, factor=bm.factor, max_steps=max_steps, coarse_layout=bm.coarse_layout,
              brick_layout=bm.brick_layout)
    if bm.dense_slots:
        return lambda: bmtrace.bmtrace_rays(o, d, bm.meta, bm.bricks, **kw)
    return lambda: bmtrace.bmtrace_compact_rays(o, d, bm.meta, bm.brick_idx, bm.bricks, **kw)


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

    key = bench_key(dims)
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


def bench_key(dims) -> str:
    """The bench world's cache key (``bench.py:139``)."""
    return f"terrain_{dims[0]}x{dims[1]}x{dims[2]}_f32_o32_v1"


def phase_main_path(dev, world: str, cache=None):
    """The main path on ``world``: ``demo`` (the 1024^3 world, built through
    W1) or ``full`` (the bench world through :func:`bench_world` into the
    cache directory ``cache``, which phase 13 reads again, its macro
    decision through ``memo_json``).  Returns K1's record and W1's launches
    on the world's build."""
    import torch

    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.kernels import terrain
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines
    from voxelengine_tpu_torch.utils.profiling import timed

    dims, W, H = WORLDS[world]
    name = f"{dims[0]}x{dims[1]}x{dims[2]}"
    ms = {}
    if world == "full":
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
    return main_path_frames(dev, world, bm, lt, (cache, key) if world == "full" else None), w1_launches


def main_path_frames(dev, world, bm, lt, memo):
    """The frames, the exactness gate, the diag build and the times of the
    main path on ``world``'s ``bm`` and ``lt``; the macro decision through
    ``memo_json`` in ``memo = (cache dir, world key)`` when given."""
    import dataclasses

    import torch

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.io.checkpoint import memo_json
    from voxelengine_tpu_torch.kernels import bigtrace, rays, shade
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

    bigtrace.launches = rays.launches = shade.launches = 0  # count the main path's launches only
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
    launches, ray_launches, shade_launches = bigtrace.launches, rays.launches, shade.launches
    frame_ms = start.elapsed_time(end) / FRAMES
    if any(b != a + 1 for a, b in zip([0] + counts, counts)):
        raise SystemExit(f"K1 was not launched once per frame: launch counts {counts}")
    if ray_launches != FRAMES + 1 or shade_launches != FRAMES + 1:
        raise SystemExit(f"the ray-setup and shading kernels were launched {ray_launches} and {shade_launches} "
                         f"times in {FRAMES + 1} frames")

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
        f"hit fraction {hit_frac:.4f}, K1 launches {launches}, ray kernel launches {ray_launches}, shading kernel "
        f"launches {shade_launches}, framebuffer checksum {float(fb.double().sum()):.6f}")
    if world == "demo":
        demo_shade_gates(bm, lt, cfg, origin, euler, env)

    # the diag build on the same rays: counters, warp iterations
    res, iters, phases = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=use_macro,
                                            return_iters=True, return_phases=True)
    check_diffs(f"main path ({world}): K1 diag build vs the production build", compare(res, got), o.shape[0],
                int(got.hit.sum()))
    check_diag(f"main path ({world})", phases, iters, pdg)
    events = phase_counts(phases, f"main path ({world})")
    k1_share = warp_iters_line(iters, pdg[-1], got.steps, f"main path ({world})")

    # times, macro off and on: K1's rays entry (the frame path's launch) and
    # its prepared entry (the walk alone, ray setup excluded); K5 alone; the
    # plain trace
    args, kw = line_kernel_args(bm, lt, o, d, cfg.max_steps)
    r_off = cuda_ms(k1_rays_call(bm, lt, o, d, cfg.max_steps, False), repeats=10)
    r_on = cuda_ms(k1_rays_call(bm, lt, o, d, cfg.max_steps, True), repeats=10)
    t_off = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=False, **kw), repeats=10)
    t_on = cuda_ms(lambda: bigtrace.bigtrace(*args, use_macro=True, **kw), repeats=10)
    t_k5, k5_share = k5_sweep(args, kw, use_macro)
    share_line(f"main path ({world})", k1_share, k5_share)
    k_ms, walk_ms = (r_on, t_on) if use_macro else (r_off, t_off)
    plain = trace_brickmap_lt if use_macro else (lambda bm, lt, *a: trace_brickmap(bm, *a))
    _, p_ms = events_ms(lambda: plain(bm, lt, o, d, cfg.max_steps))
    steps_sum = int(got.steps.sum())
    say(f"times ({world}): K1's rays entry macro off {r_off:.3f} ms, macro on {r_on:.3f} ms; the walk alone "
        f"(vx_bigtrace) macro off {t_off:.3f} ms, macro on {t_on:.3f} ms; K5 (use_macro={use_macro}) {k5_times(t_k5)}, "
        f"plain {'macro walk' if use_macro else 'trace'} {p_ms:.3f} ms, {o.shape[0]} frame rays, "
        f"sum(steps) {steps_sum}, executed events {events}, on {card_line()}")
    return kernel_entry(
        "bigtrace" if world == "full" else "bigtrace_demo_world", "bigtrace.cu",
        "voxelengine_tpu/ops/pallas_bigtrace.py:1348", launches, diffs[4], k_ms, p_ms,
        o.shape[0], hit_table_bytes(want, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick), steps_sum,
        events if use_macro else None, ray_bytes=grid_ray_bytes(o, d), walk_ms=walk_ms, rays_launches=ray_launches,
        shade_launches=shade_launches,
    )


# the shading kernel's gates (csrc/shade.cu) across the phases: frames
# compared and the largest absolute error, for its record (phase 18)
SHADE_GATES = {"frames": 0, "rays": 0, "err": 0.0}


def word_diffs(a, b) -> int:
    """Elements of ``a`` and ``b`` that differ, float32 compared as int32
    words (so a signed zero or a NaN's payload counts)."""
    import torch

    a, b = a.reshape(-1), b.reshape(-1)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def shade_gate(what, bm, lt, cfg, origin, euler, env, fn, trace, block_perm=None, ortho_size=None, pixels=None):
    """The shading kernel against its plain versions on one frame's rays,
    the same traces feeding both (``trace(origins, dirs)`` the primary;
    the secondary traces through ``lt``, or ``bm``'s K4): its ``shade``
    entry (color, write) against ``shade_traced_plain`` and, for a whole
    frame, its composite entry against ``composite_frame`` over a
    framebuffer of stale values.  ``pixels = (px, py_r)``: a rank's pixels
    (``_rays_for_pixels``), the ``shade`` entry only.  0 word diffs, or
    the run fails."""
    import torch

    from voxelengine_tpu_torch.parallel import sharded
    from voxelengine_tpu_torch.render.frame import (
        composite_frame, primary_rays, shade_and_composite, shade_traced, shade_traced_plain,
    )

    if pixels is None:
        o, d, px, py, py_r = primary_rays(cfg, origin, euler, fn, block_perm, ortho_size)
    else:
        px, py_r = pixels
        o, d, py = sharded._rays_for_pixels(cfg, origin, euler, fn, px, py_r, cfg.ortho_size)
    out = trace(o, d)
    args = (bm, out, o, d, px, py, py_r, origin, env, fn, cfg, lt)
    got, want = shade_traced(*args), shade_traced_plain(*args)
    diffs = {"color": word_diffs(got[0], want[0]), "write": word_diffs(got[1], want[1])}
    err = float((got[0] - want[0]).abs().max())
    if pixels is None:
        gen = torch.Generator(device=origin.device).manual_seed(fn)
        stale = torch.rand((cfg.height, cfg.width, 3), generator=gen, device=origin.device)
        fb = shade_and_composite(stale.clone(), *args, block_perm=block_perm)
        diffs["framebuffer"] = word_diffs(fb, composite_frame(stale.clone(), *want, cfg, fn, block_perm))
        err = max(err, float((fb - composite_frame(stale.clone(), *want, cfg, fn, block_perm)).abs().max()))
    SHADE_GATES["frames"] += 1
    SHADE_GATES["rays"] += o.shape[0]
    SHADE_GATES["err"] = max(SHADE_GATES["err"], err)
    say(f"shade: {what}, frame {fn} ({o.shape[0]} rays): shading kernel vs plain (tolerance: equal words) diffs "
        f"{json.dumps(diffs)}")
    if any(diffs.values()):
        raise SystemExit(f"shade: the shading kernel disagrees with its plain version: {what}, frame {fn}")


def prepared_result(outs, bm, o, d):
    """A prepared-ray entry's outputs (K1's ``bigtrace``, K4's ``bmtrace``
    and ``bmtrace_compact``) after the eager ray setup and ``hit_imm``
    fix-up, as the frame path ran them until the rays entries
    (``ops/trace.py::_ray_setup``, ``kernel_result``)."""
    from voxelengine_tpu_torch.ops.trace import _ray_setup, kernel_result

    _, start_c, start_normal, _ = _ray_setup(bm.grid_dims, bm.factor, o, d)
    return kernel_result(*outs[:4], start_c, start_normal, bm.factor)


def rays_entry_gate(what, got, want, got_diag=None, want_diag=None):
    """0 word diffs in hit, steps, normal and position (and the diag
    counters where given) between a rays entry and its prepared-ray entry
    fed by the eager setup, or the run fails."""
    diffs = {k: word_diffs(getattr(got, k), getattr(want, k)) for k in ("hit", "steps", "normal", "position")}
    if got_diag is not None:
        diffs["diag"] = word_diffs(got_diag, want_diag)
    say(f"{what} (tolerance: equal words): diffs {json.dumps(diffs)}, {got.hit.shape[0]} rays, "
        f"{int(got.hit.sum())} hits")
    if any(diffs.values()):
        raise SystemExit(f"{what}: the rays entry disagrees with the prepared-ray entry")


def launch_gate(what, fn, kernels):
    """Exactly one launch of each of ``kernels`` (name fragments; a fragment
    given k times: k launches) a call of ``fn`` and nothing else, by
    ``torch.profiler`` over :data:`FRAMES` calls.  The profiler can drop
    events, so a profile with too few of them is taken again, up to 3
    times; another kernel fails at once.  Returns the kernel names of one
    call and its device ms."""
    from voxelengine_tpu_torch.utils.profiling import kernel_profile

    wanted = {k: kernels.count(k) for k in kernels}
    attempts = []
    for _ in range(3):
        names, ms = kernel_profile(fn, FRAMES)
        names, ms = names or [], ms or []
        others = sorted({n for n in names if not any(k in n for k in wanted)})
        counts = [sum(k in n for n in names) for k in wanted]
        attempts.append(counts)
        if others:
            raise SystemExit(f"{what}: other CUDA kernels than {kernels} ran: {others}")
        if counts == [FRAMES * c for c in wanted.values()]:
            per = [n for n in names[:len(kernels)]]
            say(f"{what}: {len(names) / FRAMES} CUDA kernels a call ({', '.join(kernels)}: {counts} in {FRAMES} "
                f"calls), {sum(ms) / FRAMES:.5f} ms of device time a call (torch.profiler); attempts {attempts}")
            return per, [sum(ms) / FRAMES]
    raise SystemExit(f"{what}: not exactly {list(wanted.values())} launches of {list(wanted)} a call: {attempts} in "
                     f"{FRAMES} calls")


# a shaded frame's kernels (shadows, AO, reflections): the ray kernel, K1's or
# K4's rays entry, the three secondary entries, the shading kernel
SHADED_FRAME_KERNELS = ("rays_kernel", "OriginRays", "SecondaryRays", "SecondaryRays", "SecondaryRays",
                        "shade_kernel")


def secondary_bytes(kind, dirs) -> float:
    """Bytes a secondary entry must move a ray besides its walks' tables
    (``csrc/secondary.cuh``): the primary position (12 B), the normal (12
    B) where the kind reads it, the reflection's direction (12 B a ray, or
    one shared row), AO's pixel (``px``, ``py``: 16 B); out the shadow's
    hit and steps (5 B), the reflection's hit, position and normal (25 B),
    the AO factor (4 B).  The light's 12 B, read once, are left out."""
    if kind == "shadow":
        return 12 + 5
    if kind == "reflection":
        return 24 + data_bytes(dirs) / dirs.shape[0] + 25
    return 24 + 16 + 4


def recording(walk, log):
    """``walk(o, d, max_steps)`` that also appends each result to ``log``."""
    def run(o, d, ms):
        res = walk(o, d, ms)
        log.append(res)
        return res
    return run


def walk_work(results, world_dims, layout, factor, wpb):
    """``(steps, table bytes)`` of a kind's walks (``results``, its
    TraceOuts): the sum of their steps and of :func:`hit_table_bytes`."""
    return (sum(int(r.steps.sum()) for r in results),
            sum(hit_table_bytes(r, world_dims, layout, factor, wpb) for r in results))


def secondary_diffs(got, want) -> dict:
    """Word diffs of a secondary entry's results against its plain
    version's (``(hit, steps)``, ``(hit, position, normal)`` or the AO
    factor)."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return {f"out{k}": word_diffs(g, w) for k, (g, w) in enumerate(zip(got, want))}


def demo_shade_gates(bm, lt, cfg, origin, euler, env):
    """The shading kernel on the demo frame (1280x720): both parities, each
    debug view (STEPS with shadow steps), the crosshair without
    checkerboard, 1280x719 and a block permutation."""
    import dataclasses

    from voxelengine_tpu_torch.config import DebugView
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm
    from voxelengine_tpu_torch.render.frame import block_permutation_from_steps, primary_rays

    def trace_for(c):
        return lambda o, d: trace_brickmap_hbm(bm, lt, o, d, c.max_steps, use_macro=c.trace_use_macro)

    cases = [("demo frame", cfg, (1, 2), None)]
    for view, extra in ((DebugView.DEBUG, {}), (DebugView.NORMALS, {}), (DebugView.DEPTH, {}),
                        (DebugView.STEPS, dict(shadow_rays=True))):
        cases.append((f"{view.name} view", dataclasses.replace(cfg, debug_view=view, **extra), (1,), None))
    nocb = dataclasses.replace(cfg, checkerboard=False)
    cases.append(("crosshair without checkerboard", nocb, (0,), None))
    odd = dataclasses.replace(cfg, height=cfg.height - 1)
    cases.append((f"{odd.width}x{odd.height}", odd, (1, 2), None))
    o, d, _, _, _ = primary_rays(cfg, origin, euler, 1)
    perm = block_permutation_from_steps(trace_for(cfg)(o, d).steps, cfg)
    cases.append(("block_perm", cfg, (1, 2), perm))
    for what, c, frames, bp in cases:
        for fn in frames:
            shade_gate(what, bm, lt, c, origin, euler + 1e-5 * fn, env, fn, trace_for(c), block_perm=bp)


def random_grid(dims, fill, seed, dev):
    """A dense grid of random voxels over a floor (``tests/test_pallas_trace.py:80-81``)."""
    import torch

    X, Y, Z = dims
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = torch.rand((Z, Y, X), generator=gen, device=dev) < fill
    dense[:, :4, :] = torch.rand((Z, 4, X), generator=gen, device=dev) < 0.6
    return dense


def render_dense_plain(grid, fb, origin, euler, env, frame_number, cfg):
    """``render_frame_dense`` with the plain ``trace_grid`` in K2's place and
    the plain shading and composite in the shading kernel's."""
    from voxelengine_tpu_torch.ops.trace import trace_grid
    from voxelengine_tpu_torch.render.frame import composite_frame, primary_rays, shade_traced_plain

    origins, dirs, px, py, py_r = primary_rays(cfg, origin, euler, frame_number)
    out = trace_grid(grid, origins, dirs, cfg.max_steps)
    color, write = shade_traced_plain(None, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg)
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
    from voxelengine_tpu_torch.utils.profiling import kernel_profile
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

    for fn in (1, 2):
        shade_gate("dense frame", None, None, cfg, origin, euler + 1e-5 * fn, env, fn,
                   lambda o, d: trace_grid_vpu(g, o, d, cfg.max_steps))

    # the CUDA kernels one dense frame and one trace_grid_vpu call launch
    frame_kernels, frame_dev = launch_gate(
        "dense path: one render_frame_dense frame", lambda: render_frame_dense(g, fb, origin, euler, env, 1, cfg),
        ("rays_kernel", "grid_kernel", "shade_kernel"))
    call_kernels, _ = kernel_profile(lambda: trace_grid_vpu(g, fo, fd, cfg.max_steps))
    if call_kernels is None:
        say("dense path: kernels a call: not measured (torch.profiler recorded no device activity)")
    else:
        say(f"dense path: CUDA kernels launched by one trace_grid_vpu call on its rays: {len(call_kernels)} "
            f"({', '.join(sorted(set(call_kernels)))}); a frame {len(frame_kernels)} ({sum(frame_dev):.4f} ms of "
            f"device time)")
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
    from voxelengine_tpu_torch.core.brickmap import build_brickmap, compact_brickmap
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.kernels import bmtrace
    from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup, trace_brickmap
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_mxu, trace_brickmap_no_table
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

    # K4-compact on the same random rays over the world made compact
    cbm = compact_brickmap(bm)
    cgot = trace_brickmap_no_table(cbm, o, d, 2048)
    cdiffs = compare(cgot, want)
    check_diffs(f"on-chip brickmap: K4-compact ({'shared' if bmtrace.meta_in_shared(cbm.num_chunks) else 'global'} "
                "meta) vs plain, compact_brickmap of the 128^3 f8 world", cdiffs, o.shape[0], int(want.hit.sum()))

    # the rays entries (the frame path's) against the prepared-ray entries
    # fed by the eager setup, every word of every output
    prepared = {
        "K4": (got, lambda *a, **k: bmtrace.bmtrace(*a, bm.meta, bm.bricks, **k)),
        "K4-compact": (cgot, lambda *a, **k: bmtrace.bmtrace_compact(*a, cbm.meta, cbm.brick_idx, cbm.bricks, **k)),
    }
    for what, (rays_out, entry) in prepared.items():
        args, kw = kernel_args(bm, o, d)
        want_k = prepared_result(entry(*args, **kw), bm, o, d)
        rays_entry_gate(f"on-chip brickmap: {what}'s rays entry vs its prepared entry, 128^3 f8 random rays",
                        rays_out, want_k)

    # times: the rays entry (the frame path's launch) and, ray setup
    # excluded, the walk alone, also on the rays sorted by direction
    args, kw = kernel_args(bm, o, d)
    sargs = direction_sorted(*args[:4])
    k_ms = cuda_ms(k4_rays_call(bm, o, d, 2048), repeats=10)
    g_ms = cuda_ms(k4_rays_call(gbm, go, gd, 2048), repeats=10)
    walk_ms = cuda_ms(lambda: bmtrace.bmtrace(*args, bm.meta, bm.bricks, **kw), repeats=10)
    sorted_ms = cuda_ms(lambda: bmtrace.bmtrace(*sargs, bm.meta, bm.bricks, **kw), repeats=10)
    p_ms = cuda_ms(lambda: trace_brickmap(bm, o, d), repeats=1)
    gp_ms = cuda_ms(lambda: trace_brickmap(gbm, go, gd), repeats=1)
    steps_sum, g_steps = int(want.steps.sum()), int(gwant.steps.sum())
    say(f"times: K4 (shared meta) {k_ms:.3f} ms (the walk alone {walk_ms:.3f} ms, on the same rays sorted by "
        f"direction octant then start chunk {sorted_ms:.3f} ms, sorted/unsorted {sorted_ms / walk_ms:.3f}), plain trace_brickmap {p_ms:.3f} ms, "
        f"{o.shape[0]} rays, sum(steps) {steps_sum}; K4 (global meta) {g_ms:.3f} ms, plain {gp_ms:.3f} ms on the "
        f"{gname} world's {go.shape[0]} rays, sum(steps) {g_steps}, on {card_line()}")
    replaces = "voxelengine_tpu/ops/pallas_trace2.py:39"
    return [
        kernel_entry("bmtrace", "bmtrace.cu", replaces, launches, err, k_ms, p_ms, o.shape[0],
                     table_bytes(want, bm), steps_sum, ray_bytes=grid_ray_bytes(o, d), walk_ms=walk_ms,
                     sorted_walk_ms=sorted_ms),
        kernel_entry("bmtrace_global_meta", "bmtrace.cu", replaces, g_launches, gdiffs[4], g_ms, gp_ms,
                     go.shape[0], table_bytes(gwant, gbm), g_steps, ray_bytes=grid_ray_bytes(go, gd)),
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
    reflection, AO) the plain ``plain(bm, origins, dirs, max_steps)`` and
    the plain shading and composite; ``primary`` reuses a plain primary
    trace of the same rays."""
    from voxelengine_tpu_torch.render.frame import composite_frame, primary_rays, shade_traced_plain

    o, d, px, py, py_r = primary_rays(cfg, origin, euler, frame_number, block_perm, ortho_size)
    out = primary if primary is not None else plain(bm, o, d, cfg.max_steps)
    color, write = shade_traced_plain(bm, out, o, d, px, py, py_r, origin, env, frame_number, cfg,
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
    from voxelengine_tpu_torch.render.frame import primary_rays, shade_traced_plain

    o, d, px, py, py_r = primary_rays(cfg, origin, euler, fn)
    out = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=cfg.trace_use_macro)
    batches = [("primary", o.contiguous(), d, cfg.max_steps, out)]
    kinds = iter(["shadow", "reflection"] + [f"ao{i}" for i in range(cfg.ao_samples)])

    def k1(a, b, ms):
        res = trace_brickmap_hbm(bm, lt, a, b, ms, use_macro=cfg.trace_use_macro)
        batches.append((next(kinds), a.contiguous(), b.contiguous(), ms, res))
        return res

    shade_traced_plain(bm, out, o, d, px, py, py_r, origin, env, fn, cfg, lt, secondary=k1)
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
    from voxelengine_tpu_torch.ops.trace import TraceOut, trace_brickmap
    from voxelengine_tpu_torch.render.camera import get_directions_np
    from voxelengine_tpu_torch.ops.bigtrace import trace_secondary_hbm
    from voxelengine_tpu_torch.ops.secondary import frame_kinds, secondary_plain
    from voxelengine_tpu_torch.render.frame import (
        block_permutation_from_steps, make_framebuffer, primary_rays, render_frame,
    )
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
    per_frame = 1 + len(frame_kinds(cfg))  # the primary, then one secondary launch a kind
    batches_per_frame = 3 + cfg.ao_samples  # the walks: primary, shadow, reflection, AO's samples

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
    k1_total = {"rays": 0, "steps": 0, "events": 0, "table": 0, "ms": 0.0, "plain_ms": 0.0, "ray_bytes": 0.0}
    plain_primary = None
    plain_batches = []  # the secondary batches' plain walks, in order
    for kind, o, d, ms, res in batches:
        want, p_ms = events_ms(lambda: plain(bm, o, d, ms))
        if kind == "primary":
            plain_primary = want
            primary_ms = cuda_ms(k1_rays_call(bm, lt, o, d, ms, cfg.trace_use_macro), repeats=10)
            primary_bytes = o.shape[0] * grid_ray_bytes(o, d)
        else:
            plain_batches.append(want)
        every, hits = full_diffs(res, want), full_diffs(res, want, primary_hit)
        k_ms = cuda_ms(k1_rays_call(bm, lt, o, d, ms, cfg.trace_use_macro), repeats=10)
        _, ph = trace_brickmap_hbm(bm, lt, o, d, ms, use_macro=cfg.trace_use_macro, return_phases=True)
        events = sum(int(ph[k].sum()) for k in EVENTS)
        k1_total["rays"] += o.shape[0]
        k1_total["steps"] += int(res.steps.sum())
        k1_total["events"] += events
        k1_total["table"] += hit_table_bytes(want, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick)
        k1_total["ms"] += k_ms
        k1_total["plain_ms"] += p_ms
        k1_total["ray_bytes"] += o.shape[0] * grid_ray_bytes(o, d)
        say(f"app frame: {kind} batch ({o.shape[0]} rays, max_steps {ms}, hits {int(want.hit.sum())}): K1 vs plain "
            f"(tolerance: bit-equal) diffs (hit, steps, normal, position) on all rays {every}, on the primary hits "
            f"{hits}; K1 {k_ms:.4f} ms, plain {p_ms:.1f} ms, sum(steps) {int(res.steps.sum())}, executed events "
            f"{events}, on {card}")
        if any(every):
            raise SystemExit(f"app frame: K1 disagrees with its plain version on the {kind} batch")

    # each secondary entry (K1, macro as the frame) against its plain
    # version: the eager rays of the batches above and their plain walks,
    # replayed in order (the rays checked equal to the batches')
    o, d, px, py, _ = primary_rays(cfg, origin_t, euler_t, fn)
    out = batches[0][4]
    walks = iter(batches[1:])
    plain_walks = iter(plain_batches)

    def replay(o_, d_, ms_):
        _, bo, bd, bms, _ = next(walks)
        if bms != ms_ or word_diffs(o_, bo) or word_diffs(d_, bd.expand_as(d_)):
            raise SystemExit("app frame: the plain secondary rays differ from the frame's batches")
        return next(plain_walks)

    entry_ms, entry_bytes = {}, 0.0
    for kind in frame_kinds(cfg):
        got = trace_secondary_hbm(bm, lt, kind, out, d, px, py, env, fn, cfg)
        want = secondary_plain(kind, replay, out, d, px, py, env, fn, cfg)
        diffs = secondary_diffs(got, want)
        entry_ms[kind] = cuda_ms(lambda k=kind: trace_secondary_hbm(bm, lt, k, out, d, px, py, env, fn, cfg),
                                 repeats=10)
        entry_bytes += o.shape[0] * secondary_bytes(kind, d)
        say(f"app frame: K1's secondary entry, {kind} ({o.shape[0]} rays), vs its plain version (the eager rays, "
            f"the plain macro walk; tolerance: equal words): diffs {json.dumps(diffs)}; {entry_ms[kind]:.4f} ms "
            f"(CUDA events over 10 calls), on {card}")
        if any(diffs.values()):
            raise SystemExit(f"app frame: K1's secondary entry disagrees with its plain version ({kind})")

    n_next = [FRAMES + 1]  # the frame number g renders next
    primary_cache = {fn % 2: plain_primary}  # plain primaries of the gate camera, by frame parity

    def cached_primary(f):
        if f % 2 not in primary_cache:
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
    shade_gate(f"app frame, shadows, AO {cfg.ao_samples} and reflections", bm, lt, cfg, origin_t, euler_t, env, fn,
               lambda o_, d_: trace_brickmap_hbm(bm, lt, o_, d_, cfg.max_steps, use_macro=cfg.trace_use_macro))
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
    frame_kernels, frame_dev = launch_gate("app frame: one render_screen frame (shadows, AO, reflections)",
                                           lambda: g.render_screen(rt, origin, e_gate), SHADED_FRAME_KERNELS)

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

    # times of the facade's calls and of the kernels' rays entries alone
    call_ms = cuda_ms(lambda: rt.raytrace(o, d, cfg.max_steps), repeats=5)
    call2_ms = cuda_ms(lambda: rt2.raytrace(o2, d2, cfg.max_steps), repeats=5)
    k1_ms = cuda_ms(k1_rays_call(bm, lt, o, d, cfg.max_steps, False), repeats=10)
    bm2 = rt2.world
    k4_ms = cuda_ms(k4_rays_call(bm2, o2, d2, cfg.max_steps), repeats=10)
    say(f"app frame: raytrace of {FACADE_RAYS} rays {call_ms:.3f} ms through K1 (K1 alone {k1_ms:.3f} ms), "
        f"{call2_ms:.3f} ms through K4 (K4 alone {k4_ms:.3f} ms) (CUDA events), on {card}")
    k1_raytrace = kernel_entry(
        "bigtrace_raytrace", "bigtrace.cu", "voxelengine_tpu/ops/pallas_bigtrace.py:1348", raytrace_launches, 0.0,
        k1_ms, p_ms, o.shape[0], hit_table_bytes(k1_out, dims, bm.brick_layout, bm.factor, bm.words_per_brick),
        int(k1_out.steps.sum()), ray_bytes=grid_ray_bytes(o, d), raytrace_ms=call_ms,
    )
    k4_raytrace = kernel_entry(
        "bmtrace_raytrace", "bmtrace.cu", "voxelengine_tpu/ops/pallas_trace2.py:39", k4_launches, 0.0, k4_ms, p2_ms,
        o2.shape[0], hit_table_bytes(k4_out, bm2.world_dims, bm2.brick_layout, bm2.factor, bm2.words_per_brick),
        int(k4_out.steps.sum()), ray_bytes=grid_ray_bytes(o2, d2), raytrace_ms=call2_ms,
    )

    # K1 a frame: its rays entry and its secondary entries (the walks'
    # work as the batches count it; the bytes the entries move)
    k1_frame = kernel_entry(
        "bigtrace_app_frame", "bigtrace.cu", "voxelengine_tpu/ops/pallas_bigtrace.py:1348", frame_launches, 0.0,
        primary_ms + sum(entry_ms.values()), k1_total["plain_ms"], k1_total["rays"], k1_total["table"],
        k1_total["steps"], k1_total["events"] if cfg.trace_use_macro else None,
        ray_bytes=(primary_bytes + entry_bytes) / k1_total["rays"], launches_per_frame=per_frame,
        batches_per_frame=batches_per_frame, frame_ms=frame_ms, entry_ms=entry_ms, primary_ms=primary_ms,
        rays_entry_batch_ms=k1_total["ms"], kernels_per_frame=len(frame_kernels), frame_device_ms=frame_dev[0],
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
        k1_ms = cuda_ms(k1_rays_call(bm, lt, o3, r3, MAX_STEPS, False), repeats=10)
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
                         int(k1.steps.sum()), ray_bytes=grid_ray_bytes(o3, r3)),
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


# phase 13, multi-device: the port's torch.distributed layer on ranks that
# share the one card (gloo, collectives staged through host memory), then
# on one rank over NCCL.  Both check that the decompositions are exact at
# full size; neither measures scaling across cards.
MD_RANKS = 4
MD_FRAMES = 8  # timed chained frames of each sharded layout, after the warm-up
MD_NCCL_FRAMES = 2  # the NCCL rank's (depth cut: its gates are the same)
MD_RAYS = 1 << 20  # raytrace_sharded's batch
MD_AXIS_RAYS = 4096  # axis-aligned rays through every slab of the app world
# K4-slab's bytes a ray in round 0: start, dir, pad (12 B each) and active
# (4 B) in, status and result (32 B) out; and a paused ray's state row (35
# words) out.  The kernel writes a row for every ray, but a ray that is done
# needs none, so the bound counts the paused rays' rows only.
SLAB_RAY_BYTES = 40 + 4 + 32
SLAB_ROW_BYTES = 4 * 35


def md_label(n: int, backend: str) -> str:
    if backend == "gloo":
        return f"{n} ranks sharing one card (gloo, host-staged): not a scale-out figure"
    return f"{n} rank over NCCL on one card: not a scale-out figure"


def md_in_turns(mesh, fn):
    """``fn()`` on one rank at a time, the others waiting at a barrier (so a
    kernel's time is not shared with the other ranks' work); returns this
    rank's result."""
    import torch.distributed as dist

    out = None
    for turn in range(mesh.size):
        dist.barrier()
        if turn == mesh.rank:
            out = fn()
    dist.barrier()
    return out


def md_k1_check(bm, lt, o, d, max_steps, use_macro, mesh, plain_on_rank):
    """K1's rays entry alone on this rank's rays, timed in turns; on ``plain_on_rank``
    also its plain version on the same rays (the gate: bit-equal) and its
    time.  Returns a dict for the kernels line."""
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_k1, trace_brickmap_lt

    ms = md_in_turns(mesh, lambda: cuda_ms(k1_rays_call(bm, lt, o, d, max_steps, use_macro), repeats=10))
    rec = {"ms": ms, "rays": o.shape[0], "ray_bytes": grid_ray_bytes(o, d)}
    if mesh.rank == plain_on_rank:
        got = trace_brickmap_k1(bm, lt, o, d, max_steps, use_macro)
        want, p_ms = events_ms(lambda: trace_brickmap_lt(bm, lt, o, d, max_steps, use_macro))
        diffs = compare(got, want)
        rec.update(plain_ms=p_ms, diffs=list(diffs[:4]), err=diffs[4], steps=int(got.steps.sum()),
                   hits=int(want.hit.sum()),
                   table=hit_table_bytes(want, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick))
    return rec


def md_rank(mesh, cache, key, frames):
    """One rank of phase 13 (see :func:`phase_multi_device`); returns its
    measurements and gates as plain values."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.core.brickmap import BrickMap, build_brickmap_terrain
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.io.checkpoint import generate_or_load, line_table_or_build
    from voxelengine_tpu_torch.kernels import bigtrace, bmtrace
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines, trace_brickmap_hbm
    from voxelengine_tpu_torch.ops.trace import (
        TraceOut, _dims, _edge_pad, _init_state, _ray_setup, kernel_result, run_slab, unpack_slab_state,
    )
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_mxu
    from voxelengine_tpu_torch.parallel import distributed as D
    from voxelengine_tpu_torch.parallel import sharded as S
    from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, probe_use_macro, render_frame

    dev, n, r = mesh.device, mesh.size, mesh.rank
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"rank": r}

    def sync_wall(fn):
        """``(fn(), host ms)`` from a barrier (ranks start together; rank 0's
        single-device checks would otherwise count in the others' time)
        to the end of the work on the card."""
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t0) * 1e3

    def not_cached():
        raise RuntimeError("the bench world is not in phase 5's cache")

    def load():
        world = generate_or_load(cache, key, not_cached, device=dev)
        return world, materialize_brick_lines(world, line_table_or_build(cache, key + "_lt1", world))

    # the bench world and its line table from phase 5's cache
    (bm, lt), out["load_ms"] = sync_wall(load)
    out["frames"] = frames
    dims, W, H = WORLDS["full"]
    cfg = RenderConfig(width=W, height=H, checkerboard=True, tile_order=True)
    origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)  # bench.py:191-192
    euler = torch.tensor([-0.25, 0.75, 0.0], device=dev)
    po, pd, _, _, _ = primary_rays(cfg, origin, euler, 1)
    use_macro = probe_use_macro(bm, lt, po, pd, cfg)
    cfg = dataclasses.replace(cfg, trace_use_macro=use_macro)
    out["use_macro"] = use_macro
    env = Environment.default(dev)

    # 1. the pixel-sharded frames: warm-up, timed chained frames, then the
    # gate at both parities against single-device frames on rank 0
    ref = {}
    if r == 0:
        fb1 = make_framebuffer(cfg, dev)
        for i in range(frames + 2):
            render_frame(bm, fb1, origin, euler + 1e-5 * i, env, i, cfg, lt=lt)
            if i >= frames:
                ref[i] = fb1.clone()
    for kind in ("rows", "cyclic"):
        render = S.render_frame_sharded if kind == "rows" else S.render_frame_cyclic
        fb = S.make_framebuffer_rows(cfg, mesh) if kind == "rows" else S.make_framebuffer_cyclic(cfg, mesh)
        bigtrace.launches = 0  # the path's launches
        render(bm, fb, origin, euler, env, 0, cfg, mesh, lt)
        torch.cuda.synchronize(dev)
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(1, frames + 1):
            render(bm, fb, origin, euler + 1e-5 * i, env, i, cfg, mesh, lt)
        end.record()
        torch.cuda.synchronize(dev)
        out[f"{kind}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / frames
        out[f"{kind}_ms"] = start.elapsed_time(end) / frames
        out[f"{kind}_launches"] = bigtrace.launches
        diffs = []
        for i in (frames, frames + 1):
            if i > frames:
                render(bm, fb, origin, euler + 1e-5 * i, env, i, cfg, mesh, lt)
            img = S.gather_rows(fb, mesh)
            if kind == "cyclic":
                img = torch.from_numpy(S.cyclic_to_image(img, cfg)).to(dev)
            if r == 0:
                diffs.append(int((img != ref[i]).any(dim=-1).sum()))
        out[f"{kind}_diffs"] = diffs
        if r == 0:
            out[f"{kind}_checksum"] = float(img.double().sum())
        px, py_r = S.band_pixels(cfg, mesh, dev) if kind == "rows" else S.cyclic_pixels(cfg, mesh, dev)
        o, d, _ = S._rays_for_pixels(cfg, origin, euler + 1e-5 * frames, frames, px, py_r, cfg.ortho_size)
        out[f"{kind}_k1"] = md_k1_check(bm, lt, o.contiguous(), d, cfg.max_steps, use_macro, mesh, 0)
    del ref

    # 2. raytrace_sharded on random rays through K1, its mean
    o, d = random_rays(dims, MD_RAYS, 1.5, 401, dev)
    bigtrace.launches = 0
    res, mean = S.raytrace_sharded(bm, o, d, mesh, cfg.max_steps, lt)
    out["raytrace_launches"] = bigtrace.launches
    got = TraceOut(*(S.gather_rows(f, mesh) for f in res))
    if r == 0:
        want = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps)
        out["raytrace_diffs"] = list(full_diffs(got, want))
        single = float(fdiv32(want.steps.to(torch.float32).sum(), MD_RAYS))
        out["raytrace_mean"], out["raytrace_mean_single"] = float(mean), single
    k = MD_RAYS // n
    out["raytrace_k1"] = md_k1_check(bm, lt, o[r * k:(r + 1) * k].contiguous(), d[r * k:(r + 1) * k].contiguous(),
                                     cfg.max_steps, True, mesh, 0)

    # 3. the replicated walk over each rank's slab row, on a frame's rays
    zw, out["zw_build_ms"] = sync_wall(lambda: D.make_zsharded_hbm(bm, n, r))
    out["zw_bytes"] = sum(t.numel() * 4 for t in (zw.brick_lines_stack, zw.region_lines_stack))
    bigtrace.launches = 0
    zout, out["zw_trace_ms"] = sync_wall(lambda: D.trace_brickmap_hbm_zsharded(zw, po, pd, mesh, cfg.max_steps))
    out["zw_launches"] = bigtrace.launches
    if r == 0:
        want = trace_brickmap_hbm(bm, lt, po, pd, cfg.max_steps, use_macro=True)
        h = want.hit
        out["zw_diffs"] = [int((zout.hit != want.hit).sum()), int((zout.normal[h] != want.normal[h]).any(1).sum()),
                           int((zout.position[h] != want.position[h]).any(1).sum())]
        out["zw_steps_over"] = int((zout.steps > want.steps).sum())
        out["zw_steps_equal"] = float((zout.steps == want.steps).float().mean())
    placeholder = BrickMap(meta=torch.zeros(1, dtype=torch.int32, device=dev),
                           brick_idx=torch.zeros(1, dtype=torch.int32, device=dev),
                           bricks=torch.zeros((1, bm.words_per_brick), dtype=torch.int32, device=dev),
                           grid_dims=bm.grid_dims, factor=bm.factor, coarse_layout=Layout.LINEAR,
                           brick_layout=bm.brick_layout, dense_slots=False)
    out["zw_k1"] = md_k1_check(placeholder, zw.line_table(r), po, pd, cfg.max_steps, True, mesh, 0)
    del zw, bm, lt
    torch.cuda.empty_cache()

    # 4. the app world (dense slots, LINEAR): migration through K4-slab
    app, out["app_build_ms"] = sync_wall(lambda: build_brickmap_terrain(APP_WORLD, 32, device=dev))
    acfg = RenderConfig(width=APP_SIZE[0], height=APP_SIZE[1], checkerboard=True, tile_order=True,
                        shadow_rays=True, ao_samples=APP_AO, reflections=True)
    aorigin = torch.tensor([APP_WORLD[0] / 2, APP_CAMERA_Y, APP_WORLD[2] / 2], device=dev)
    fo, fd, _, _, _ = primary_rays(acfg, aorigin, euler, 1)
    gen = torch.Generator(device=dev).manual_seed(402)
    m = MD_AXIS_RAYS // 2
    xy = torch.rand((MD_AXIS_RAYS, 2), generator=gen, device=dev) * (APP_WORLD[0] - 4) + 2
    zs = torch.cat([torch.full((m, 1), APP_WORLD[2] - 0.5, device=dev), torch.full((m, 1), 0.5, device=dev)])
    xo = torch.cat([xy, zs], dim=1)
    xd = torch.cat([torch.tensor([[0.0, 0.0, -1.0]], device=dev).expand(m, 3),
                    torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(m, 3)]).contiguous()
    gx, gy, gz = app.grid_dims
    slab_gz = gz // n
    slab_calls = []  # every K4-slab launch of the two migration traces, timed afterwards
    real_slab = bmtrace.bmtrace_slab

    def recording_slab(meta, bricks, *, rays=None, rows=None, **kw):
        res = real_slab(meta, bricks, rays=rays, rows=rows, **kw)
        if res[0].shape[0]:  # a launch (the wrapper launches nothing for no rays)
            slab_calls.append((meta, bricks, rays, rows, kw, res))
        return res

    for name, (o, d) in (("frame", (fo.contiguous(), fd)), ("axis", (xo, xd))):
        stats = []
        bmtrace.slab_launches = 0
        bmtrace.bmtrace_slab = recording_slab
        try:
            zres, ms = sync_wall(lambda: D.trace_brickmap_zsharded(app, o, d, mesh, acfg.max_steps, stats))
        finally:
            bmtrace.bmtrace_slab = real_slab
        out[f"mig_{name}_ms"], out[f"mig_{name}_launches"] = ms, bmtrace.slab_launches
        out[f"mig_{name}_rounds"] = stats
        if r == 0:
            out[f"mig_{name}_diffs"] = list(full_diffs(zres, trace_brickmap_mxu(app, o, d, acfg.max_steps)))
            out[f"mig_{name}_hits"] = int(zres.hit.sum())
        # K4 alone on the same rays, single-device, beside K4-slab's round 0
        dd, start_c, start_normal, active = _ray_setup(app.grid_dims, app.factor, o, d)
        pad = _edge_pad(start_c.to(torch.int32), _dims(app.grid_dims, torch.int32, dev), dd)
        k4 = (start_c.contiguous(), dd.contiguous(), active.to(torch.int32), pad.contiguous())
        out[f"k4_{name}_ms"] = md_in_turns(mesh, lambda: r == 0 and cuda_ms(lambda: bmtrace.bmtrace(
            *k4, app.meta, app.bricks, grid_dims=app.grid_dims, factor=app.factor, max_steps=acfg.max_steps,
            coarse_layout=app.coarse_layout, brick_layout=app.brick_layout), repeats=10))
        # K4-slab against its plain version on this rank's round-0 rays
        meta_s, bricks_s, _ = D.shard_world_z(app, n)
        own = torch.nonzero(active & (torch.clamp(start_c.to(torch.int32)[:, 2] // slab_gz, 0, n - 1) == r)).squeeze(1)
        setup = (start_c[own].contiguous(), dd[own].contiguous(), active[own].to(torch.int32), pad[own].contiguous())
        kw = dict(grid_dims=app.grid_dims, z0=r * slab_gz, slab_gz=slab_gz, factor=app.factor,
                  max_steps=acfg.max_steps, brick_layout=app.brick_layout)
        k_ms = md_in_turns(mesh, lambda: own.numel() and cuda_ms(
            lambda: bmtrace.bmtrace_slab(meta_s[r], bricks_s[r], rays=setup, **kw), repeats=10))
        if own.numel() == 0:
            continue
        rows, status, *kres = bmtrace.bmtrace_slab(meta_s[r], bricks_s[r], rays=setup, **kw)
        spec = app.grid_dims + (app.factor, app.coarse_layout, app.brick_layout)
        local = D._slab_bm(spec, meta_s[r], bricks_s[r], slab_gz)
        st = _init_state(local, o[own], d[own], full_gz=gz)
        (p_rows, p_status, *pres), p_ms = events_ms(lambda: run_slab(local, st, acfg.max_steps, r * slab_gz, gz))
        st = unpack_slab_state(p_rows)
        paused = status == 1
        done = ~paused
        fin = kernel_result(*pres, start_c[own], start_normal[own], app.factor)
        kr = kernel_result(*kres, start_c[own], start_normal[own], app.factor)
        bad = {
            "pause points": int((status != p_status).sum()),
            "paused cell": int((rows[paused, bmtrace.STATE_CELL] != st["ccell"][paused]).any(1).sum()),
            "paused tmax": int((rows[paused, bmtrace.STATE_TMAX].view(torch.float32) != st["ctmax"][paused]).any(1).sum()),
            "paused entry t": int((rows[paused, bmtrace.STATE_TLAST].view(torch.float32) != st["centry_t"][paused]).sum()),
            "paused steps": int((rows[paused, bmtrace.STATE_STEPS] != st["steps"][paused]).sum()),
        }
        bad.update({f"done {f}": v for f, v in zip(("hit", "steps", "normal", "position"),
                                                   full_diffs(TraceOut(*(t[done] for t in kr)),
                                                              TraceOut(*(t[done] for t in fin))))})
        h = kr.hit & done
        err = torch_max((kr.position[h] - fin.position[h]).abs(), (kr.normal[h] - fin.normal[h]).abs())
        out[f"slab_{name}"] = {
            "ms": k_ms, "plain_ms": p_ms, "rays": int(own.numel()), "paused": int(paused.sum()), "bad": bad,
            "err": err, "steps": int(torch.where(paused, rows[:, bmtrace.STATE_STEPS], kres[3]).sum()),
            "table": hit_table_bytes(TraceOut(*(t[done] for t in fin)), app.world_dims, app.brick_layout, app.factor,
                                     app.words_per_brick),
        }

    out["slab_launches"] = md_in_turns(mesh, lambda: [slab_launch_time(app, *c) for c in slab_calls])
    del slab_calls

    # 5. the z-sharded frames with shadows, AO 4 and reflections
    zw_app = D.make_zsharded_hbm(app, n, r)
    lt_app = materialize_brick_lines(app, make_line_table(app))
    primary = dataclasses.replace(acfg, shadow_rays=False, ao_samples=0, reflections=False)
    for name, c, use_zw in (("migration", acfg, False), ("zw", acfg, True), ("zw_primary", primary, True)):
        fb = make_framebuffer(c, dev)
        bigtrace.launches = bmtrace.slab_launches = 0
        _, ms = sync_wall(lambda: D.render_frame_zsharded(app, fb, aorigin, euler, env, 1, c, mesh,
                                                           zw=zw_app if use_zw else None))
        out[f"zframe_{name}"] = {"ms": ms, "k1": bigtrace.launches, "k4slab": bmtrace.slab_launches}
        if r == 0:
            want = render_frame(app, make_framebuffer(c, dev), aorigin, euler, env, 1, c, lt=lt_app if use_zw else None)
            diff = (fb - want).abs()
            out[f"zframe_{name}"].update(max_diff=float(diff.max()), pixels=int((diff > 0).any(-1).sum()))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["staged_bytes"] = mesh.staged_bytes
    return out


def slab_launch_time(app, meta, bricks, rays, rows, kw, res):
    """One recorded K4-slab launch of a migration trace, run again alone:
    ``{rays, round0, paused, ms, bound_ms}``, its time by CUDA events over 10
    launches and its bound (:func:`bound`: ray bytes in and out, the paused
    rays' state rows out, a handed-on row in for each ray of a later round,
    the table words of its hits; the DDA steps it took)."""
    import torch

    from voxelengine_tpu_torch.kernels import bmtrace
    from voxelengine_tpu_torch.ops.trace import TraceOut

    ms = cuda_ms(lambda: bmtrace.bmtrace_slab(meta, bricks, rays=rays, rows=rows, **kw), repeats=10)
    rows_out, status, flags, pos, nrm, steps = res
    m = rows_out.shape[0]
    paused = int((status == 1).sum())
    done_hit = ((flags & 1) == 1) & (status == 0)
    table = hit_table_bytes(TraceOut(done_hit, pos, nrm, steps), app.world_dims, app.brick_layout, app.factor,
                            app.words_per_brick)
    taken = torch.where(status == 1, rows_out[:, bmtrace.STATE_STEPS], steps).long()  # a done ray writes no row
    if rows is not None:
        taken = taken - rows[:, bmtrace.STATE_STEPS].long()
    per_ray = SLAB_RAY_BYTES if rows is None else SLAB_ROW_BYTES + SLAB_RAY_BYTES - 40
    bound_ms, _ = bound(m, table + SLAB_ROW_BYTES * paused, int(taken.sum()), per_ray)
    return {"rays": m, "round0": rows is None, "paused": paused, "ms": ms, "bound_ms": bound_ms}


def fdiv32(a, b):
    """float32 ``a / b`` as one IEEE division."""
    import torch

    return a / torch.tensor(float(b), dtype=torch.float32, device=a.device)


def md_gates(label, res, card):
    """Print the gates of one run (every rank's results ``res``) and raise on
    a failed one."""
    r0 = res[0]
    fails = []
    for kind in ("rows", "cyclic"):
        say(f"multi-device ({label}): render_frame_{'sharded' if kind == 'rows' else 'cyclic'} {WORLDS['full'][1]}x"
            f"{WORLDS['full'][2]}, gathered "
            f"vs single-device render_frame at both parities (tolerance: bit-equal): pixel diffs {r0[f'{kind}_diffs']}"
            f", checksum {r0[f'{kind}_checksum']:.6f}; K1 vs plain on rank 0's rays {r0[f'{kind}_k1']['diffs']}, "
            f"on {card}")
        fails += [f"{kind} frame"] * (any(r0[f"{kind}_diffs"]) or any(r0[f"{kind}_k1"]["diffs"]))
    rel = abs(r0["raytrace_mean"] - r0["raytrace_mean_single"]) / r0["raytrace_mean_single"]
    say(f"multi-device ({label}): raytrace_sharded, {MD_RAYS} rays through K1, gathered vs single-device K1 "
        f"(tolerance: bit-equal): diffs (hit, steps, normal, position) {r0['raytrace_diffs']}; mean steps "
        f"{r0['raytrace_mean']:.6f} vs {r0['raytrace_mean_single']:.6f} (relative {rel:.2e}, tolerance 1e-6), on {card}")
    fails += ["raytrace_sharded"] * (any(r0["raytrace_diffs"]) or rel > 1e-6 or any(r0["raytrace_k1"]["diffs"]))
    say(f"multi-device ({label}): trace_brickmap_hbm_zsharded (K1's replicated walk, make_zsharded_hbm row a rank) on "
        f"the frame's rays vs single-device K1 (tolerance: bit-equal on hits, normals, positions): diffs "
        f"{r0['zw_diffs']}; rays whose steps exceed the single walk's {r0['zw_steps_over']} (must be 0), steps equal "
        f"on {r0['zw_steps_equal']:.4f} of rays; K1 vs plain on rank 0's row {r0['zw_k1']['diffs']}, on {card}")
    fails += ["replicated walk"] * (any(r0["zw_diffs"]) or r0["zw_steps_over"] > 0 or any(r0["zw_k1"]["diffs"]))
    for name in ("frame", "axis"):
        say(f"multi-device ({label}): trace_brickmap_zsharded through K4-slab, app world, {name} rays vs single-device "
            f"K4 (tolerance: bit-equal): diffs (hit, steps, normal, position) {r0[f'mig_{name}_diffs']}, hits "
            f"{r0[f'mig_{name}_hits']}, on {card}")
        fails += [f"migration {name}"] * any(r0[f"mig_{name}_diffs"])
        for x in res:
            s = x.get(f"slab_{name}")
            if s:
                say(f"multi-device ({label}): K4-slab vs its plain slab walk on rank {x['rank']}'s round-0 {name} rays "
                    f"({s['rays']} rays, {s['paused']} paused; tolerance: bit-equal): {json.dumps(s['bad'])}")
                fails += [f"K4-slab rank {x['rank']}"] * any(s["bad"].values())
    for name, tol in (("migration", 1e-6), ("zw", 3e-2), ("zw_primary", 0.0)):
        z = r0[f"zframe_{name}"]
        say(f"multi-device ({label}): render_frame_zsharded ({name}) {APP_SIZE[0]}x{APP_SIZE[1]} vs single-device "
            f"render_frame: max abs "
            f"diff {z['max_diff']:.3e} (tolerance {tol:g}), {z['pixels']} pixels differ, on {card}")
        fails += [f"z-sharded frame {name}"] * (z["max_diff"] > tol)
    if fails:
        raise SystemExit(f"multi-device ({label}): gates failed: {fails}")


def md_times(label, res, wall_s, card):
    tag = f"{label}, on {card}"
    for kind in ("rows", "cyclic"):
        say(f"multi-device ({tag}): {kind} {WORLDS['full'][1]}x{WORLDS['full'][2]}, {res[0]['frames']} chained frames: ms/frame by CUDA events "
            f"per rank {[round(x[f'{kind}_ms'], 3) for x in res]}, host wall per rank "
            f"{[round(x[f'{kind}_wall_ms'], 3) for x in res]} (slowest {max(x[f'{kind}_wall_ms'] for x in res):.3f}); "
            f"K1 alone per rank (in turns) {[round(x[f'{kind}_k1']['ms'], 4) for x in res]} ms; K1 launches "
            f"{sum(x[f'{kind}_launches'] for x in res)}")
    say(f"multi-device ({tag}): raytrace_sharded K1 per rank (in turns) {[round(x['raytrace_k1']['ms'], 4) for x in res]}"
        f" ms; replicated walk: make_zsharded_hbm row {[round(x['zw_build_ms'], 1) for x in res]} ms, "
        f"{[x['zw_bytes'] for x in res]} B of lines, trace {[round(x['zw_trace_ms'], 2) for x in res]} ms (host wall, "
        f"synchronised), K1 alone per rank (in turns) {[round(x['zw_k1']['ms'], 4) for x in res]} ms")
    for name in ("frame", "axis"):
        rounds = [[(s["sent_up"], s["sent_down"]) for s in x[f"mig_{name}_rounds"]] for x in res]
        say(f"multi-device ({tag}): migration ({name} rays): {len(res)} rounds, rays sent (up, down) per rank and "
            f"round {rounds}, K4-slab launches {sum(x[f'mig_{name}_launches'] for x in res)}, trace "
            f"{[round(x[f'mig_{name}_ms'], 2) for x in res]} ms (host wall); K4-slab alone on round 0 "
            f"{ {x['rank']: round(x[f'slab_{name}']['ms'], 4) for x in res if f'slab_{name}' in x} } ms, its plain "
            f"{ {x['rank']: round(x[f'slab_{name}']['plain_ms'], 1) for x in res if f'slab_{name}' in x} } ms; "
            f"single-device K4 alone on the same {name} rays {res[0][f'k4_{name}_ms']:.4f} ms")
    launches = [dict(x, rank=r["rank"]) for r in res for x in r["slab_launches"]]
    each = [(x["rank"], x["rays"], 0 if x["round0"] else "later", x["paused"], round(x["ms"], 4),
             round(x["bound_ms"], 5)) for x in launches]
    say(f"multi-device ({tag}): each K4-slab launch of the two migration traces, run again alone (ranks in turns; "
        f"rank, rays, round 0 or a handed-on round, paused rays, ms, bound ms): {each}"
        f"; {len(launches)} launches, sum(ms) {sum(x['ms'] for x in launches):.4f}, "
        f"launches x (ms - bound) = sum(ms - bound) {sum(x['ms'] - x['bound_ms'] for x in launches):.4f} ms")
    for name in ("migration", "zw", "zw_primary"):
        say(f"multi-device ({tag}): render_frame_zsharded ({name}): "
            f"{[round(x[f'zframe_{name}']['ms'], 1) for x in res]} ms per rank (host wall, one frame), K1 launches "
            f"{sum(x[f'zframe_{name}']['k1'] for x in res)}, K4-slab launches "
            f"{sum(x[f'zframe_{name}']['k4slab'] for x in res)}")
    say(f"multi-device ({tag}): bench world load {[round(x['load_ms']) for x in res]} ms, app world build "
        f"{[round(x['app_build_ms']) for x in res]} ms; max_memory_allocated per rank "
        f"{[x['max_memory_allocated'] for x in res]} B; bytes staged through the host per rank "
        f"{[x['staged_bytes'] for x in res]}; run_ranks wall {wall_s:.1f} s")


def md_kernels(res):
    """The kernels line's records of phase 13 (the gloo run's)."""
    r0 = res[0]
    recs = []
    paths = (("rows", "bigtrace_sharded_rows", "render_frame_sharded"),
             ("cyclic", "bigtrace_sharded_cyclic", "render_frame_cyclic"),
             ("raytrace", "bigtrace_raytrace_sharded", "raytrace_sharded"),
             ("zw", "bigtrace_zsharded_hbm", "trace_brickmap_hbm_zsharded"))
    for key, name, path in paths:
        k = r0[f"{key}_k1"]
        launches = sum(x[f"{key}_launches"] for x in res)
        recs.append(kernel_entry(
            name, "bigtrace.cu", "voxelengine_tpu/ops/pallas_bigtrace.py:1348", launches, k["err"], k["ms"],
            k["plain_ms"], k["rays"], k["table"], k["steps"], ray_bytes=k["ray_bytes"], path=path, ranks=len(res),
            ms_per_rank=[x[f"{key}_k1"]["ms"] for x in res], timed_on="rank 0's rays, ranks in turns",
        ))
    owner = max((x for x in res if "slab_frame" in x), key=lambda x: x["slab_frame"]["rays"])
    s = owner["slab_frame"]
    launches = sum(x["mig_frame_launches"] + x["mig_axis_launches"] for x in res)
    each = [x for r in res for x in r["slab_launches"]]
    recs.append(kernel_entry(
        "bmtrace_slab", "zslab.cu", "voxelengine_tpu/ops/trace.py:221 _run_loop(slab=) (XLA, no pallas_call)",
        launches, s["err"], s["ms"], s["plain_ms"], s["rays"], s["table"], s["steps"],
        ray_bytes=SLAB_RAY_BYTES + SLAB_ROW_BYTES * s["paused"] / s["rays"],
        path="trace_brickmap_zsharded (frame and axis rays)", timed_on=f"rank {owner['rank']}'s round-0 frame rays",
        launch_ms=[x["ms"] for x in each], launch_bound_ms=[x["bound_ms"] for x in each],
        launches_x_ms_minus_bound=sum(x["ms"] - x["bound_ms"] for x in each),
    ))
    return recs


def phase_multi_device(dev, cache, key):
    """Phase 13: the multi-device entries on 4 ranks sharing the card over
    gloo, then on 1 rank over NCCL; returns the kernels line's records."""
    import torch

    from voxelengine_tpu_torch.parallel.mesh import run_ranks

    card = card_line()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    (ROOT / "_checkout").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    res = run_ranks(md_rank, MD_RANKS, "gloo", "cuda", cache, key, MD_FRAMES, timeout=900,
                    workdir=str(ROOT / "_checkout"))
    wall = time.perf_counter() - t0
    label = md_label(MD_RANKS, "gloo")
    md_gates(label, res, card)
    md_times(label, res, wall, card)
    kernels = md_kernels(res)
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise SystemExit(f"multi-device: kernels never launched on their path: {idle}")
    t0 = time.perf_counter()
    res1 = run_ranks(md_rank, 1, "nccl", "cuda", cache, key, MD_NCCL_FRAMES, timeout=900,
                     workdir=str(ROOT / "_checkout"))
    wall1 = time.perf_counter() - t0
    label1 = md_label(1, "nccl")
    md_gates(label1, res1, card)
    md_times(label1, res1, wall1, card)
    say(f"multi-device: phase 13 in {wall + wall1:.1f} s; no multi-card number exists: the card is one H100, "
        f"on {card}")
    return kernels


# phase 14, the port's bench harness (voxelengine_tpu_torch/bench.py) on
# the card: its launches on each route, which the harness's own gate checks
HARNESS_WARM = 3  # bench.run's warm-up frames at its default 8 frames a batch
HARNESS_FRAMES = 1 + HARNESS_WARM + 3 * 8 + 1  # frame 0, warm-up, 3 batches of 8, the gate's trace


def phase_harness(dev, cache, key):
    """Phase 14: ``bench.run`` on the bench world from phase 5's cache
    through K1 (``pallas``) and K4's compact instantiation (``xla``), and on
    the 1024^3 world with its raw bricks kept on the host (the 16k flow);
    then K4-compact against its plain version on the bench frame's rays.
    Returns K4-compact's record."""
    import torch

    from voxelengine_tpu_torch import bench
    from voxelengine_tpu_torch.config import RenderConfig
    from voxelengine_tpu_torch.io.checkpoint import generate_or_load
    from voxelengine_tpu_torch.kernels import bigtrace, bmtrace, terrain
    from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup, trace_brickmap
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table
    from voxelengine_tpu_torch.render.frame import primary_rays

    card = card_line()
    t_phase = time.perf_counter()
    counts = {}
    for world, backend, host in (("full", "pallas", False), ("full", "xla", False), ("small", "pallas", True)):
        bigtrace.launches = bmtrace.launches = bmtrace.compact_launches = bmtrace.compact_shared_launches = 0
        terrain.launches = 0
        t0 = time.perf_counter()
        res = bench.run(world=world, backend=backend, cache_dir=cache, device=dev, host_bricks=host)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"K1": bigtrace.launches, "K4": bmtrace.launches, "K4-compact": bmtrace.compact_launches,
               "W1": terrain.launches}
        counts[world, backend] = dict(got, shared=bmtrace.compact_shared_launches)
        want = {"K4": 0, "W1": 0 if world == "full" else bench.WORLDS[world][2] // 32}
        if backend == "xla":
            want.update({"K1": 0, "K4-compact": HARNESS_FRAMES})
        else:
            want["K4-compact"] = 0
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if world == "full" and backend == "pallas" and got["K1"] < HARNESS_FRAMES:
            bad["K1"] = (got["K1"], f">= {HARNESS_FRAMES}")
        metric = bench.metric_name(world, 1080, False, 0, False)
        say(f"bench harness ({world}, {backend}{', raw bricks on the host' if host else ''}): "
            f"{json.dumps(res.record)}")
        say(f"bench harness ({world}, {backend}): gate hit diffs {res.hit_diffs} (must be 0), launches {got}, "
            f"framebuffer checksum {float(res.framebuffer.double().sum()):.6f}, {wall:.1f} s with the world's "
            f"load{' and build' if world == 'small' else ''}, on {card}")
        if res.hit_diffs or bad or res.record["metric"] != metric or res.record["device"] != card:
            raise SystemExit(f"bench harness ({world}, {backend}): diffs {res.hit_diffs}, launches off {bad}, "
                             f"metric {res.record['metric']!r}, device {res.record['device']!r}")
        del res

    # K4-compact against its plain version on the bench frame's rays, and
    # the instantiation the xla run took with its launch counts
    def not_cached():
        raise SystemExit("the bench world is not in phase 5's cache")

    bm = generate_or_load(cache, key, not_cached, device=dev)
    dims, W, H = WORLDS["full"]
    cfg = RenderConfig(width=W, height=H, checkerboard=True, tile_order=True)
    origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)  # bench.py:191-192
    euler = torch.tensor(bench.EULER, device=dev)
    o, d, _, _, _ = primary_rays(cfg, origin, euler, 1)
    got = trace_brickmap_no_table(bm, o, d, cfg.max_steps)
    want, p_ms = events_ms(lambda: trace_brickmap(bm, o, d, cfg.max_steps))
    shared = bmtrace.meta_in_shared(bm.num_chunks)
    meta = "shared" if shared else "global"
    xla = counts["full", "xla"]
    if xla["shared"] != xla["K4-compact"] * shared:
        raise SystemExit(f"bench harness (full, xla): {xla['shared']} of {xla['K4-compact']} K4-compact launches "
                         f"had meta in shared memory, not all in the {meta}-meta instantiation")
    diffs = compare(got, want)
    check_diffs(f"bench harness: K4-compact ({meta} meta) vs plain on the bench frame's rays", diffs, o.shape[0],
                int(want.hit.sum()))
    dd, start_c, _, active = _ray_setup(bm.grid_dims, bm.factor, o, d)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, dev), dd)
    args = (start_c.contiguous(), dd.contiguous(), active.to(torch.int32), pad.contiguous(), bm.meta, bm.brick_idx,
            bm.bricks)
    kw = dict(grid_dims=bm.grid_dims, factor=bm.factor, max_steps=cfg.max_steps, coarse_layout=bm.coarse_layout,
              brick_layout=bm.brick_layout)
    # the rays entry (bench.run(xla)'s launch) and the walk alone
    k_ms = cuda_ms(k4_rays_call(bm, o, d, cfg.max_steps), repeats=10)
    walk_ms = cuda_ms(lambda: bmtrace.bmtrace_compact(*args, **kw), repeats=10)
    # the bound's table bytes: each distinct hit word and hit chunk's meta
    # word (hit_table_bytes), and the hit chunks' brick_idx words
    h = hit_voxels(want, bm.world_dims) // bm.factor
    gx, gy, _ = bm.grid_dims
    slot_bytes = 4 * int(torch.unique(h[:, 0] + h[:, 1] * gx + h[:, 2] * gx * gy).numel())
    table = hit_table_bytes(want, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick) + slot_bytes
    steps_sum = int(want.steps.sum())
    say(f"bench harness: K4-compact ({meta} meta; the xla run's launches {xla['K4-compact']}, "
        f"{xla['shared']} of them shared meta) {k_ms:.4f} ms (the walk alone {walk_ms:.4f} ms), plain trace_brickmap {p_ms:.1f} ms on the bench "
        f"frame's {o.shape[0]} rays, sum(steps) {steps_sum}; phase 14 in {time.perf_counter() - t_phase:.1f} s, "
        f"on {card}")
    return kernel_entry(
        "bmtrace_compact", "bmtrace.cu",
        "none: voxelengine_tpu/ops/trace.py:411,435 trace_brickmap / trace_brickmap_staged (XLA, no pallas_call)",
        xla["K4-compact"], diffs[4], k_ms, p_ms, o.shape[0], table, steps_sum, ray_bytes=grid_ray_bytes(o, d),
        walk_ms=walk_ms, path="bench.run(backend='xla') on the bench world", table_form=f"compact, {meta} meta",
    )


# phase 15, the camera kernel (csrc/camera.cu): glibc's sinf and cosf, as
# the reference's XLA:CPU computes them, and the basis of get_directions;
# and the ray-setup kernel (csrc/rays.cu), which computes the same basis
CAMERA_GRID = 1 << 20  # pitch and yaw angle pairs of the grid over [-3.3, 3.3]
# the cameras whose basis the card and the CPU must give alike: the bench's
# (bench.py:192) and its drifted frames (bench.py:324; this script's main
# path adds 1e-5 * i in torch), the demo's (apps/voxel_app.py:198), the
# JAX package's sharding tests' and the 1080p cyclic check's
CAMERAS = [(-0.25, 0.75, 0.0), (0.3, 0.8, 0.0), (0.9, 0.3, 0.0), (-0.5, 0.75, 0.0)]
# the basis' work a triple: per angle the reduction (a product, a fused
# step, two conversions) and the two polynomials (4 products and 3 fused
# steps for the sine, 4 and 4 for the cosine, the signs and 2 roundings):
# 24 float64 ops; the basis 9 products, 3 differences and 7 negations
CAMERA_FP64_OPS, CAMERA_F32_OPS, CAMERA_BYTES = 2 * 24, 19, 12 + 36


def camera_angles():
    """The phase's angle triples, float32 numpy ``[n, 3]``: the grid as
    pitch and (reversed) yaw, +-64 ulp of every multiple of pi/4 up to 120
    and random |x| in [120, 1e5] in both, and the cameras with the bench
    drift."""
    import numpy as np

    f32 = np.float32
    x = np.linspace(-3.3, 3.3, CAMERA_GRID, dtype=f32)
    k = np.arange(-152, 153)
    edges = ((k * np.pi / 4).astype(f32).view(np.int32)[:, None] + np.arange(-64, 65)).astype(np.int32).view(f32)
    edges = edges[np.isfinite(edges) & (np.abs(edges) <= 120)].reshape(-1)
    rng = np.random.default_rng(15)
    large = (120 + rng.random(100_000) * (1e5 - 120)).astype(f32) * rng.choice(f32([-1, 1]), 100_000)
    a = np.concatenate([x, edges, large])
    e = np.stack([a, a[::-1], np.zeros_like(a)], 1)
    cams = np.asarray(CAMERAS, f32)
    drift = cams[:1] + (f32(1e-5) * np.arange(1, FRAMES + 1, dtype=f32))[:, None]
    return np.concatenate([e, cams, drift]).astype(f32)


def phase_camera(dev, ray_launches):
    """Phase 15, the camera and ray-setup kernels.  The camera kernel
    against its plain version (``render/camera.py::basis_plain``,
    ``core/libm.py``) on the card over :func:`camera_angles`, bit for bit;
    ``get_directions`` of :data:`CAMERAS` and the drifted bench camera on
    the card (the camera kernel's path, counted) and on the CPU, bit for
    bit; the kernel's and the plain version's times for one triple.  Then
    the ray-setup kernel (:func:`ray_cases`, :func:`ray_setup_record`).
    ``ray_launches``: the ray kernel's on the main path (phase 5).
    Returns the two kernels' records."""
    import torch

    from voxelengine_tpu_torch.kernels import camera as ck
    from voxelengine_tpu_torch.render import camera as cam

    card = card_line()
    angles = camera_angles()
    e = torch.from_numpy(angles).to(dev)
    got = ck.camera_basis(e)
    want = torch.cat(cam.basis_plain(e), dim=1)
    diffs = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    err = float((got - want).abs().max())
    if diffs or err:
        raise SystemExit(f"camera kernel vs plain on {e.shape[0]} triples: {diffs} word diffs, max abs err {err}")
    cams = torch.from_numpy(angles[-len(CAMERAS) - FRAMES:])
    ck.launches = 0  # the camera kernel's path: get_directions on the card
    on_card = torch.cat(cam.get_directions(cams.to(dev)), dim=1).cpu()
    launches = ck.launches
    on_cpu = torch.cat(cam.get_directions(cams), dim=1)
    cpu_diffs = int((on_card.view(torch.int32) != on_cpu.view(torch.int32)).sum())
    say(f"camera: kernel vs plain (libm's sincosf in torch ops) on {e.shape[0]} angle triples on the card (tolerance: "
        f"equal): {diffs} diffs, max abs err {err}; get_directions of {cams.shape[0]} cameras (bench, demo, "
        f"drifted bench) on the card ({launches} camera kernel launch) vs the CPU port: {cpu_diffs} diffs")
    if cpu_diffs:
        raise SystemExit("the card's camera basis differs from the CPU port's")

    one = torch.tensor(CAMERAS[0], device=dev)
    k_ms = cuda_ms(lambda: ck.camera_basis(one.reshape(1, 3)), repeats=100)
    p_ms = cuda_ms(lambda: cam.basis_plain(one), repeats=20)
    rates = issue_rates()
    bytes_ms = CAMERA_BYTES / HBM_BYTES_PER_S * 1e3
    ops_ms = (CAMERA_FP64_OPS / rates["fp64"] + CAMERA_F32_OPS / rates["issue"]) * 1e3
    say(f"camera: kernel {k_ms:.5f} ms (CUDA events over 100 launches), plain {p_ms:.4f} ms for one triple; bound "
        f"{max(bytes_ms, ops_ms):.3g} ms; launches on its path (get_directions) {launches}, on {card}")
    camera = {
        "name": "camera", "route": "cuda", "source": "voxelengine_tpu_torch/csrc/camera.cu",
        "replaces": "none: voxelengine_tpu/render/camera.py:19-34 get_directions (jnp.sin and jnp.cos inside the "
                    "jitted frame, glibc's sinf and cosf on XLA:CPU; no pallas_call)",
        "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # torch.sin and torch.cos compute other functions (not glibc's)
        "triples_compared": int(e.shape[0]), "path": "get_directions",
    }
    return [ray_setup_record(dev, ray_launches, *ray_cases(dev)), camera]


# the ray-setup kernel (csrc/rays.cu): a perspective ray writes its
# direction (12 B) and px, py, py_r (int64, 24 B); its work a ray: 2
# conversions and 2 divisions for u and v, 4 ops for ux and vy, 2 scales,
# 12 for the direction, 5 for its squared norm, the root through float64
# (3), 3 divisions, and ~17 integer ops for the pixel and the remap
RAY_BYTES_OUT, RAY_OPS = 36, 50
RAY_THREADS = 256  # a block of csrc/rays.cu, which computes the basis once


def ray_diffs(got, want):
    """``(word diffs, max abs err)`` of two ray tuples (float rows compared
    as int32 words)."""
    import torch

    def words(t):
        t = t.reshape(-1)
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    if [tuple(g.shape) for g in got] != [tuple(w.shape) for w in want]:
        raise SystemExit(f"ray shapes differ: {[tuple(g.shape) for g in got]} vs {[tuple(w.shape) for w in want]}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want) if g.dtype == torch.float32)
    return sum(int((words(g) != words(w)).sum()) for g, w in zip(got, want)), err


def ray_cases(dev) -> int:
    """The ray kernel against its plain version on the card, 0 word diffs
    in every output: the bench frame (1920x1080, checkerboard, tile order,
    both parities), the demo frame (1280x720), a block permutation, no
    checkerboard, an odd height, 1x1 pixel blocks (untiled), orthographic
    with a pair and with a tensor window, and the ``pixels`` entry on each
    rank's pixels of a 4-rank ``band_pixels`` and ``cyclic_pixels``
    layout.  Returns the rays compared and the largest absolute error."""
    import dataclasses

    import numpy as np
    import torch

    from voxelengine_tpu_torch.config import Projection, RenderConfig
    from voxelengine_tpu_torch.kernels import rays
    from voxelengine_tpu_torch.parallel import sharded
    from voxelengine_tpu_torch.parallel.mesh import Mesh
    from voxelengine_tpu_torch.render.frame import block_geometry, block_permutation_from_steps, primary_rays
    from voxelengine_tpu_torch.render.frame import primary_rays_plain

    dims, W, H = WORLDS["full"]
    dW, dH = APP_SIZE
    bench = RenderConfig(width=W, height=H, checkerboard=True, tile_order=True)
    demo = RenderConfig(width=dW, height=dH, checkerboard=True, tile_order=True)
    ortho = dataclasses.replace(demo, projection=Projection.ORTHOGRAPHIC, ortho_size=APP_ORTHO)
    bw, bh, nb = block_geometry(demo)
    steps = torch.from_numpy(np.random.default_rng(13).integers(0, 500, nb * bw * bh)).to(dev)
    perm = block_permutation_from_steps(steps, demo)
    origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)
    bench_e = torch.tensor(CAMERAS[0], device=dev)
    # name: (cfg, euler, frame numbers, block_perm, ortho_size)
    cases = {
        "bench 1920x1080": (bench, bench_e, (1, 2), None, None),
        "demo 1280x720": (demo, torch.tensor(CAMERAS[1], device=dev), (1, 2), None, None),
        "block_perm 1280x720": (demo, bench_e, (1, 2), perm, None),
        "no checkerboard 1280x720": (dataclasses.replace(demo, checkerboard=False), bench_e, (0,), None, None),
        "odd height 1280x719": (dataclasses.replace(demo, height=719), bench_e, (1, 2), None, None),
        "1x1 blocks 1279x718": (dataclasses.replace(demo, width=1279, height=718), bench_e, (1,), None, None),
        "ortho pair 1280x720": (ortho, bench_e, (1, 2), None, None),
        "ortho tensor 1280x720": (ortho, bench_e, (1,), None, torch.tensor([150.5, 90.25], device=dev)),
    }
    compared, err, lines = 0, 0.0, []
    for name, (cfg, e, frames, bp, osz) in cases.items():
        for fn in frames:
            ed = e + 1e-5 * fn  # the bench drift
            before = rays.launches
            got = primary_rays(cfg, origin, ed, fn, bp, osz)
            if rays.launches != before + 1:
                raise SystemExit(f"ray setup ({name}): {rays.launches - before} ray kernel launches, not 1")
            n, e_max = ray_diffs(got, primary_rays_plain(cfg, origin, ed, fn, bp, osz))
            compared, err = compared + got[1].shape[0], max(err, e_max)
            lines.append(f"{name} frame {fn}: {n}")
            if n:
                raise SystemExit(f"ray kernel vs plain ({name}, frame {fn}): {n} word diffs")
    for layout, pixels in (("band", sharded.band_pixels), ("cyclic", sharded.cyclic_pixels)):
        n = 0
        for rank in range(MD_RANKS):
            px, py_r = pixels(bench, Mesh(None, rank, MD_RANKS, "rows", dev), dev)
            for fn in (1, 2):
                ed = bench_e + 1e-5 * fn
                got = sharded._rays_for_pixels(bench, origin, ed, fn, px, py_r, bench.ortho_size)
                d, e_max = ray_diffs(got, sharded._rays_for_pixels_plain(bench, origin, ed, fn, px, py_r,
                                                                          bench.ortho_size))
                n, compared, err = n + d, compared + px.shape[0], max(err, e_max)
        lines.append(f"pixels entry, {layout}_pixels of {MD_RANKS} ranks at 1920x1080, frames 1 and 2: {n}")
        if n:
            raise SystemExit(f"ray kernel's pixels entry vs plain ({layout}): {n} word diffs")
    say(f"rays: kernel vs plain on the card (tolerance: equal; word diffs in origins, dirs, px, py, py_r): "
        f"{'; '.join(lines)}; {compared} rays compared, max abs err {err}")
    return compared, err


def ray_setup_record(dev, launches, compared, err):
    """The gate (a frame's ray setup is exactly one CUDA kernel, the ray
    kernel), the kernel's times on the bench frame and its record, with
    ``compared`` and ``err`` from :func:`ray_cases`."""
    import torch

    from voxelengine_tpu_torch.config import RenderConfig
    from voxelengine_tpu_torch.kernels import rays
    from voxelengine_tpu_torch.render.frame import primary_rays, primary_rays_plain
    from voxelengine_tpu_torch.utils.profiling import kernel_profile

    card = card_line()
    dims, W, H = WORLDS["full"]
    cfg = RenderConfig(width=W, height=H, checkerboard=True, tile_order=True)
    origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)
    one = torch.tensor(CAMERAS[0], device=dev)
    # the wrapper's count says how many launches the profiled ray setups
    # made (kernel_profile runs FRAMES of them in its warm-up step and
    # FRAMES recorded): exactly one each.  The profile shows that no other
    # kernel ran.  The profiler can drop events (CUPTI), so a profile with
    # fewer ray kernels than FRAMES, or none, is taken again, up to 3
    # times; every attempt's (kernels, ray kernels) is printed
    attempts = []
    for _ in range(3):
        before = rays.launches
        setup, setup_ms = kernel_profile(lambda: primary_rays(cfg, origin, one, 1), FRAMES)
        if rays.launches - before != 2 * FRAMES:
            raise SystemExit(f"rays: {2 * FRAMES} ray setups launched the ray kernel {rays.launches - before} times")
        setup, setup_ms = setup or [], setup_ms or []
        attempts.append((len(setup), sum("rays_kernel" in k for k in setup)))
        if attempts[-1][1] >= FRAMES:
            break
    others = sorted({k for k in setup if "rays_kernel" not in k})
    ray_ms = [t for k, t in zip(setup, setup_ms) if "rays_kernel" in k]
    dev_ms = sum(ray_ms) / max(len(ray_ms), 1)  # the kernel's own device time a launch
    k_ms = cuda_ms(lambda: primary_rays(cfg, origin, one, 1), repeats=100)
    p_ms = cuda_ms(lambda: primary_rays_plain(cfg, origin, one, 1), repeats=20)
    n = W * (H // 2)
    rates = issue_rates()
    blocks = -(-n // RAY_THREADS)
    bytes_ms = (n * RAY_BYTES_OUT + 24) / HBM_BYTES_PER_S * 1e3  # rays out; euler and origin in
    ops_ms = (n * RAY_OPS / rates["issue"] + blocks * CAMERA_FP64_OPS / rates["fp64"]) * 1e3
    say(f"rays: the bench frame's ray setup ({n} rays) launches {len(setup) / FRAMES} CUDA kernels a frame, "
        f"{len(ray_ms) / FRAMES} of them the ray kernel (kernels and ray kernels of each profile of {FRAMES} taken: "
        f"{attempts}; other kernels {others}); the wrapper counted {2 * FRAMES} launches for {2 * FRAMES} ray "
        f"setups; kernel {k_ms:.5f} ms a call (CUDA events over 100 calls), {dev_ms:.5f} ms of device time a launch "
        f"(torch.profiler), plain {p_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.3g} ms (bytes {bytes_ms:.3g}, "
        f"operations {ops_ms:.3g}); main-path launches {launches}, on {card}")
    if others or len(ray_ms) != FRAMES:
        raise SystemExit(f"a frame's ray setup is not exactly the ray kernel: {len(ray_ms)} ray kernels in "
                         f"{FRAMES} ray setups, other kernels {others}")
    return {
        "name": "rays", "route": "cuda", "source": "voxelengine_tpu_torch/csrc/rays.cu",
        "replaces": "none: voxelengine_tpu/render/frame.py:171-220 primary_rays (XLA ops fused into the jitted "
                    "frame; no pallas_call)",
        "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no PyTorch call computes a frame's rays
        "device_ms": dev_ms, "rays": n, "rays_compared": compared, "setup_kernels": len(setup) / FRAMES,
    }


# phase 18, the fused frame kernels: K1's and K4's rays entries, the
# shading kernel (csrc/shade.cu)
# float ops of a primary SHADED ray in shade.cuh::shade_ray (a division
# counted once): a hit's shading, and a miss's sky (the clamp of 3 channels)
SHADE_OPS, SHADE_MISS_OPS = 80, 6


def framebuffer_sector_bytes(cfg, px, py, write) -> int:
    """Bytes the card's memory moves to write a frame's pixels into the
    framebuffer (``f32[H, W, 3]``): each 32-byte sector the written pixels
    touch is written, and one they fill only in part is read first, since
    the memory takes whole sectors.  A checkerboard frame writes every
    other pixel of a row, so nearly every sector is read and written."""
    import torch

    keep = write & (py < cfg.height)
    off = 12 * (py[keep] * cfg.width + px[keep])
    first = off // 32
    in_first = torch.clamp(32 - off % 32, max=12)
    sectors = torch.cat([first, first[in_first < 12] + 1])
    filled = torch.cat([in_first, 12 - in_first[in_first < 12]])
    per = torch.zeros(int(sectors.max()) + 1 if sectors.numel() else 1, dtype=torch.int64, device=px.device)
    per.index_add_(0, sectors, filled)
    touched, full = int((per > 0).sum()), int((per == 32).sum())
    return 32 * (2 * (touched - full) + full)


def shade_bytes(cfg, out, o, d, px, py, write, shadow=False):
    """Bytes the shading and composite of a primary frame must move, for
    its bound: each ray's hit (1 B) and pixel (``px``, ``py``: 8 B each);
    the hits' position and normal (12 B each); the misses' directions, the
    sky (one row where the direction is broadcast); steps (4 B) where the
    STEPS or DEBUG view or a shadow trace reads them; the hits' origins in
    the DEBUG and DEPTH views (one row where broadcast); the pre-remap row
    (8 B) of the rays in the crosshair's column; the camera position and
    the environment's three vectors (48 B); the framebuffer's sectors that
    the written pixels touch (:func:`framebuffer_sector_bytes`; 12 B a
    written pixel until PR 15's run showed the partly written sectors'
    reads)."""
    from voxelengine_tpu_torch.config import DebugView

    n, hits = out.hit.shape[0], int(out.hit.sum())
    view = cfg.debug_view
    b = n * (1 + 8 + 8) + 24 * hits + (12 if d.stride(0) == 0 else 12 * (n - hits)) + 48
    if view in (DebugView.STEPS, DebugView.DEBUG) or shadow:
        b += 4 * n
    if view in (DebugView.DEBUG, DebugView.DEPTH):
        b += 12 if o.stride(0) == 0 else 12 * hits
    if cfg.crosshair:
        b += 8 * int((px == cfg.width // 2).sum())
    return b + framebuffer_sector_bytes(cfg, px, py, write)


def phase_frame_kernels(dev, cache, launches):
    """Phase 18 on the bench frame (phase 5's cache): K1's rays entry
    against its prepared-ray entry fed by the eager setup, macro on and
    off, the diag counters included, and K4-compact's likewise; the launch
    gates (the trace stage 1 CUDA kernel, the primary frame 3); the
    shading kernel against its plain versions at both parities and on 4
    ranks' band and cyclic pixels; its times and its record, with
    ``launches`` from phase 5's frames."""
    from voxelengine_tpu_torch.experiments.scene import bench_scene
    from voxelengine_tpu_torch.kernels import bigtrace, bmtrace
    from voxelengine_tpu_torch.ops.bigtrace import _kernel_rays, _kernel_tables, trace_brickmap_hbm, trace_brickmap_k1
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table
    from voxelengine_tpu_torch.parallel import sharded
    from voxelengine_tpu_torch.parallel.mesh import Mesh
    from voxelengine_tpu_torch.render.frame import (
        composite_frame, make_framebuffer, primary_rays, render_frame, shade_and_composite, shade_traced,
        shade_traced_plain,
    )

    card = card_line()
    bm, lt, cfg, origin, euler, env, _ = bench_scene("full", dev, cache)
    ms = cfg.max_steps
    o, d, px, py, py_r = primary_rays(cfg, origin, euler, 1)

    # K1's rays entry against vx_bigtrace after the eager setup, diag builds too
    for use_macro in (False, True):
        tables, kw = _kernel_tables(bm, lt, ms, use_macro)
        start_c, dd, active, pad, _ = _kernel_rays(bm, o, d)
        for diag in (False, True):
            got = trace_brickmap_k1(bm, lt, o, d, ms, use_macro, diag=diag)
            outs = bigtrace.bigtrace(start_c, dd, active, pad, *tables, diag=diag, **kw)
            want = prepared_result(outs, bm, o, d)
            rays_entry_gate(f"frame kernels: K1's rays entry vs vx_bigtrace, bench frame, use_macro={use_macro}, "
                            f"diag={diag}", got[0] if diag else got, want, got[1] if diag else None,
                            outs[4] if diag else None)
    # K4-compact's rays entry on the same rays (the bench world is compact)
    kw4 = dict(grid_dims=bm.grid_dims, factor=bm.factor, max_steps=ms, coarse_layout=bm.coarse_layout,
               brick_layout=bm.brick_layout)
    start_c, dd, active, pad, _ = _kernel_rays(bm, o, d)
    want = prepared_result(bmtrace.bmtrace_compact(start_c, dd, active, pad, bm.meta, bm.brick_idx, bm.bricks, **kw4),
                           bm, o, d)
    rays_entry_gate("frame kernels: K4-compact's rays entry vs vx_trace_brickmap_compact, bench frame",
                    trace_brickmap_no_table(bm, o, d, ms), want)

    # the launch gates
    def trace(o_, d_):
        return trace_brickmap_hbm(bm, lt, o_, d_, ms, use_macro=cfg.trace_use_macro)

    launch_gate("frame kernels: the trace stage of the bench frame (trace_brickmap_hbm)", lambda: trace(o, d),
                ("bigtrace_kernel",))
    fb = make_framebuffer(cfg, dev)
    _, frame_dev = launch_gate("frame kernels: the primary bench frame (render_frame)",
                               lambda: render_frame(bm, fb, origin, euler, env, 1, cfg, lt=lt),
                               ("rays_kernel", "bigtrace_kernel", "shade_kernel"))

    # the shading kernel's gates
    for fn in (1, 2):
        shade_gate("bench frame", bm, lt, cfg, origin, euler + 1e-5 * fn, env, fn, trace)
    for layout, pixels in (("band", sharded.band_pixels), ("cyclic", sharded.cyclic_pixels)):
        for rank in range(MD_RANKS):
            pix = pixels(cfg, Mesh(None, rank, MD_RANKS, "rows", dev), dev)
            for fn in (1, 2):
                shade_gate(f"shade entry on {layout}_pixels, rank {rank} of {MD_RANKS}", bm, lt, cfg, origin,
                           euler + 1e-5 * fn, env, fn, trace, pixels=pix)

    # times on the bench frame's rays: the composite entry, its plain versions
    out = trace(o, d)
    args = (bm, out, o, d, px, py, py_r, origin, env, 1, cfg, lt)
    _, dev_ms = launch_gate("frame kernels: the shading of the bench frame (shade_and_composite)",
                            lambda: shade_and_composite(fb, *args), ("shade_kernel",))
    # its shade entry (color and write, contiguous) on the same rays: the
    # composite's scattered pixel writes are what it leaves out
    _, entry_dev = launch_gate("frame kernels: the shading of the bench frame, shade entry (shade_traced)",
                               lambda: shade_traced(*args), ("shade_kernel",))
    k_ms = cuda_ms(lambda: shade_and_composite(fb, *args), repeats=100)
    p_ms = cuda_ms(lambda: composite_frame(fb, *shade_traced_plain(*args), cfg, 1), repeats=10)
    _, write = shade_traced_plain(*args)
    n = o.shape[0]
    written = int((write & (py < cfg.height)).sum())
    bytes_ = shade_bytes(cfg, out, o, d, px, py, write)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    hits = int(out.hit.sum())
    ops_ms = (hits * SHADE_OPS + (n - hits) * SHADE_MISS_OPS) / issue_rates()["issue"] * 1e3
    pixel_bytes = 12 * written  # the pixels alone, the bound's count until PR 15
    say(f"frame kernels: shading kernel on the bench frame ({n} rays, {written} pixels written): composite entry "
        f"{k_ms:.5f} ms a call (CUDA events over 100 calls), {dev_ms[0]:.5f} ms of device time (torch.profiler; "
        f"the shade entry {entry_dev[0]:.5f}); "
        f"plain shade_traced_plain + composite_frame {p_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.5f} ms (bytes "
        f"{bytes_ms:.5f}: {bytes_ / n:.1f} B a ray, of which the framebuffer's sectors "
        f"{framebuffer_sector_bytes(cfg, px, py, write)} B, its pixels alone {pixel_bytes} B; operations "
        f"{ops_ms:.5f}); the primary frame {frame_dev[0]:.5f} "
        f"ms of device time; gates: {SHADE_GATES['frames']} frames, {SHADE_GATES['rays']} rays, 0 diffs; main-path "
        f"launches {launches}, on {card}")
    return {
        "name": "shade", "route": "cuda", "source": "voxelengine_tpu_torch/csrc/shade.cu",
        "replaces": "none: voxelengine_tpu/render/frame.py:350-470 shade_traced and :114-169 composite_frame "
                    "(XLA ops fused into the jitted frame; no pallas_call)",
        "launches": launches, "max_abs_err": SHADE_GATES["err"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no PyTorch call shades a frame
        "device_ms": dev_ms[0], "shade_entry_device_ms": entry_dev[0], "rays": n, "hits": hits,
        "pixels_written": written, "bytes": bytes_, "framebuffer_sector_bytes": framebuffer_sector_bytes(cfg, px, py, write),
        "frame_device_ms": frame_dev[0],
        "gate_frames": SHADE_GATES["frames"], "gate_rays": SHADE_GATES["rays"],
    }


def dense_slot_form(bm):
    """``bm`` (compact) with dense slots: each chunk's brick at its own
    index, empty chunks' words 0 (``build_brickmap``'s form), on its
    device."""
    import dataclasses

    import torch

    nc, dev = bm.num_chunks, bm.meta.device
    slots = bm.brick_idx.long()
    occ = slots >= 0
    bricks = torch.zeros((nc, bm.words_per_brick), dtype=torch.int32, device=dev)
    bricks[occ] = bm.bricks[slots[occ]]
    return dataclasses.replace(bm, brick_idx=torch.arange(nc, dtype=torch.int32, device=dev), bricks=bricks,
                               dense_slots=True)


def phase_secondary(dev, cache):
    """Phase 19, the shaded bench frame (shadows, AO 4, reflections; phase
    5's cache) through the secondary entries (``csrc/secondary.cuh``): K1's
    (line table, the probe's macro decision), K4-compact's (the world
    without its line table) and K4's dense-slot form's (the same world with
    dense slots).  For each: a warm-up plus 8 chained frames with the
    secondary counts set to 0 just before and read just after (each kind
    once a frame), the launch gate (the frame exactly 6 CUDA kernels),
    each entry against its plain version (``secondary_plain`` over the
    plain walk) on every ray of the next frame's plain primary trace (0
    word diffs), and its time (CUDA events over 10 calls).  Returns the
    nine entries' records."""
    import dataclasses

    import torch

    from voxelengine_tpu_torch.experiments.scene import bench_scene
    from voxelengine_tpu_torch.kernels import bigtrace, bmtrace
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_lt, trace_secondary_hbm
    from voxelengine_tpu_torch.ops.secondary import frame_kinds, secondary_plain
    from voxelengine_tpu_torch.ops.trace import trace_brickmap
    from voxelengine_tpu_torch.ops.trace2 import trace_secondary_no_table
    from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, render_frame

    card = card_line()
    bm, lt, cfg, origin, euler, env, _ = bench_scene("full", dev, cache)
    cfg = dataclasses.replace(cfg, shadow_rays=True, ao_samples=APP_AO, reflections=True)
    kinds = frame_kinds(cfg)
    ms = cfg.max_steps
    fn = FRAMES + 1
    e_gate = euler + 1e-5 * fn
    o, d, px, py, _ = primary_rays(cfg, origin, e_gate, fn)
    n = o.shape[0]
    out = trace_brickmap(bm, o, d, ms)  # the plain primary trace every route's entries take

    # the plain versions: secondary_plain over the chunk walk (K4's, and
    # K1's with the macro levels off) or the macro walk (K1's with them on)
    plain = {}

    def plain_of(walk_name):
        if walk_name not in plain:
            walk = ((lambda a, b, m: trace_brickmap_lt(bm, lt, a, b, m, True)) if walk_name == "macro"
                    else (lambda a, b, m: trace_brickmap(bm, a, b, m)))
            plain[walk_name] = {}
            for kind in kinds:
                log = []
                want, p_ms = events_ms(lambda: secondary_plain(kind, recording(walk, log), out, d, px, py, env, fn,
                                                               cfg))
                plain[walk_name][kind] = (want, p_ms, log)
        return plain[walk_name]

    dense = dense_slot_form(bm)
    k1_walk = "macro" if cfg.trace_use_macro else "chunk"
    routes = (
        ("bigtrace", bm, lt, k1_walk, bigtrace.secondary_launches, "bigtrace.cu",
         "voxelengine_tpu/ops/pallas_bigtrace.py:1348 (and the rays' XLA ops, voxelengine_tpu/render/"
         "frame.py:245-293, 378-420)"),
        ("bmtrace_compact", bm, None, "chunk", bmtrace.compact_secondary_launches, "bmtrace.cu",
         "none: voxelengine_tpu/ops/trace.py:411,435 and the rays' XLA ops (voxelengine_tpu/render/"
         "frame.py:245-293, 378-420), no pallas_call"),
        ("bmtrace", dense, None, "chunk", bmtrace.secondary_launches, "bmtrace.cu",
         "voxelengine_tpu/ops/pallas_trace2.py:39 (and the rays' XLA ops, voxelengine_tpu/render/"
         "frame.py:245-293, 378-420)"),
    )
    records = []
    for route, world, table, walk_name, counts, source, replaces in routes:
        def entry(kind, w=world, t=table):
            if t is not None:
                return trace_secondary_hbm(w, t, kind, out, d, px, py, env, fn, cfg)
            return trace_secondary_no_table(w, kind, out, d, px, py, env, fn, cfg)

        # the main path: chained shaded frames, counts from 0
        fb = make_framebuffer(cfg, dev)
        for k in counts:
            counts[k] = 0
        render_frame(world, fb, origin, euler, env, 0, cfg, lt=table)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(1, FRAMES + 1):
            render_frame(world, fb, origin, euler + 1e-5 * i, env, i, cfg, lt=table)
        end.record()
        torch.cuda.synchronize()
        launched = dict(counts)
        frame_ms = start.elapsed_time(end) / FRAMES
        if any(launched[k] != FRAMES + 1 for k in kinds):
            raise SystemExit(f"secondary: {route}'s secondary entry was not launched once a kind a frame: {launched}")
        if not bool(torch.isfinite(fb).all()) or float(fb.min()) < 0 or float(fb.max()) > 1:
            raise SystemExit(f"secondary: {route}'s shaded frames hold values outside [0, 1]")
        names, frame_dev = launch_gate(f"secondary: the shaded bench frame through {route}",
                                       lambda: render_frame(world, fb, origin, e_gate, env, fn, cfg, lt=table),
                                       SHADED_FRAME_KERNELS)
        say(f"secondary: {route}, {cfg.width}x{cfg.height} shaded bench frames (shadows, AO {cfg.ao_samples}, "
            f"reflections, use_macro={cfg.trace_use_macro}): {frame_ms:.3f} ms/frame ({FRAMES} chained, CUDA "
            f"events), {len(names)} CUDA kernels and {frame_dev[0]:.4f} device ms a frame; secondary launches "
            f"{json.dumps(launched)}, framebuffer checksum {float(fb.double().sum()):.6f}, on {card}")
        for kind in kinds:
            want, p_ms, log = plain_of(walk_name)[kind]
            diffs = secondary_diffs(entry(kind), want)
            k_ms = cuda_ms(lambda k=kind: entry(k), repeats=10)
            steps, table_bytes = walk_work(log, world.world_dims, world.brick_layout, world.factor,
                                           world.words_per_brick)
            rec = kernel_entry(f"{route}_{kind}", source, replaces, launched[kind], 0.0, k_ms, p_ms, n,
                               table_bytes, steps, ray_bytes=secondary_bytes(kind, d), walks_per_ray=len(log),
                               frame_ms=frame_ms, kernels_per_frame=len(names), frame_device_ms=frame_dev[0])
            records.append(rec)
            say(f"secondary: {route}'s {kind} entry vs plain ({n} rays, {len(log)} walks a ray; tolerance: equal "
                f"words) diffs {json.dumps(diffs)}; {k_ms:.4f} ms (CUDA events over 10 calls), plain {p_ms:.1f} ms; "
                f"bound {rec['bound_ms']:.5f} ms by {rec['bound_by']} ({rec['ray_bytes']:.1f} B a ray, "
                f"{table_bytes} table bytes, {steps} steps); {launched[kind]} launches, on {card}")
            if any(diffs.values()):
                raise SystemExit(f"secondary: {route}'s {kind} entry disagrees with its plain version")
    del dense
    return records


# phases 16-17, the measurement scripts (voxelengine_tpu_torch/experiments/)
def phase_experiments(dev, cache):
    """Phase 16: the frame breakdown (S0 ray setup, S1 + K1, S2 the
    frame; primary and shaded) on the bench world from phase 5's cache;
    the shard projection (N = 2, 4, 8, row bands and block-cyclic) on the
    same scene; the 1080p demo image of both fields (primary), its size,
    checksum and pixels apart from the JAX reference's TPU render."""
    import hashlib

    from voxelengine_tpu_torch.experiments import bench_frame_breakdown as b1
    from voxelengine_tpu_torch.experiments import bench_shard_projection as b2
    from voxelengine_tpu_torch.experiments import render_demo as b4
    from voxelengine_tpu_torch.experiments.scene import bench_scene

    card = card_line()
    t0 = time.perf_counter()
    scene = bench_scene("full", dev, cache)
    breakdown = {}
    for shading in b1.SHADINGS:
        breakdown[shading] = res = b1.measure(scene, shading, batches=5, frames=FRAMES)
        for line in b1.report(shading, res, card):
            say(f"frame breakdown: {line}")
        if not all("kernels_per_frame" in res[st] for st in b1.STAGES):
            raise SystemExit("frame breakdown: the profiler recorded no device activity")
    say(json.dumps({"frame_breakdown": breakdown, "device": card}))
    proj = b2.project(scene, (2, 4, 8), repeats=10, frames=FRAMES)
    one = proj["1"]
    say(f"shard projection: N=1 K1 {one['k1_ms'][0]} ms, rest {one['rest_ms']} ms, frame {one['frame_ms']} ms")
    for layout in b2.LAYOUTS:
        for n, r in proj[layout].items():
            if "refused" in r:
                say(f"shard projection: N={n} {layout}: not measured, {r['refused']}")
                continue
            say(f"shard projection: N={n} {layout}: K1 a rank {' '.join(f'{k:.4f}' for k in r['k1_ms'])} ms, "
                f"imbalance (max/mean) {r['imbalance']}, rest of a shard's frame {r['rest_ms']} ms, projected frame_N "
                f"{r['frame_ms']} ms")
    say(json.dumps({"shard_projection": proj, "device": card}))
    img = b4.render(scene)
    png = b4._encode_png(img)
    ref = b4.decode_png((b4.DOCS / b4.name("full", False, 0, False)).read_bytes())
    apart = int((img != ref).any(-1).sum())
    say(f"demo image (full, both fields, primary): {img.shape[1]}x{img.shape[0]} PNG {len(png)} bytes, sha256 "
        f"{hashlib.sha256(png).hexdigest()}, {apart} of {img.shape[0] * img.shape[1]} pixels apart from "
        f"docs/{b4.name('full', False, 0, False)} (the JAX reference's TPU render: information, not a gate)")
    if not 0 < int(img.max()) or img.shape != (1080, 1920, 3):
        raise SystemExit("the demo image is empty or of the wrong shape")
    say(f"experiments: phase 16 in {time.perf_counter() - t0:.1f} s, on {card}")


def phase_cyclic_1080p(dev):
    """Phase 17: ``experiments/verify_cyclic_1080p``: 8 gloo ranks sharing
    the card render 1920x1080 block-cyclic frames (32x30 blocks) of the
    512^3 terrain (W1, 8 octaves) through K1, both parities, against
    single-device ``render_frame``: 0 byte diffs."""
    import torch

    from voxelengine_tpu_torch.experiments import verify_cyclic_1080p as b3

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = b3.run(dev, ranks=b3.RANKS, workdir=str(ROOT / "_checkout"))
    say(f"cyclic 1080p: {json.dumps(rec)} in {time.perf_counter() - t0:.1f} s, on {card_line()}")
    if not rec["ok"] or rec["geometry"] != list(b3.GEOMETRY_1080P) or any(k < 2 for k in rec["k1_launches"]):
        raise SystemExit(f"cyclic 1080p: byte diffs {rec['byte_diffs']}, geometry {rec['geometry']}, "
                         f"K1 launches {rec['k1_launches']}")


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
    secs = {}  # each phase's wall seconds, printed with the total

    def timed(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            secs[name] = round(time.perf_counter() - t, 1)

    timed("build", phase_build)
    (ROOT / "_checkout").mkdir(exist_ok=True)
    cache = tempfile.mkdtemp(prefix="world_cache_", dir=ROOT / "_checkout")  # the bench world's, phases 5 and 13
    try:
        timed("noise", phase_noise, dev)
        timed("kernel vs plain", phase_kernel_vs_plain, dev)
        w1 = timed("terrain", phase_terrain, dev)
        demo, _ = timed("main path demo", phase_main_path, dev, "demo")
        bench, w1["launches"] = timed("main path full", phase_main_path, dev, "full", cache)
        kernels = [bench, demo, w1]
        err = timed("dense vs plain", phase_dense_vs_plain, dev)
        kernels += timed("dense path", phase_dense_path, dev, err)
        kernels += timed("bmtrace", phase_bmtrace, dev)
        kernels.append(timed("sparse", phase_sparse, dev))
        kernels += timed("app frame", phase_app_frame, dev)
        kernels += timed("remainder", phase_remainder, dev)
        kernels += timed("multi-device", phase_multi_device, dev, cache, bench_key(WORLDS["full"][0]))
        kernels.append(timed("harness", phase_harness, dev, cache, bench_key(WORLDS["full"][0])))
        kernels[:0] = timed("camera and rays", phase_camera, dev, bench["rays_launches"])
        timed("experiments", phase_experiments, dev, cache)
        timed("cyclic 1080p", phase_cyclic_1080p, dev)
        kernels.append(timed("frame kernels", phase_frame_kernels, dev, cache, bench["shade_launches"]))
        kernels += timed("secondary", phase_secondary, dev, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise SystemExit(f"kernels never launched on their path: {idle}")
    say(f"wall time: {time.perf_counter() - t_start:.1f} s, kernel builds included; by phase (s): {json.dumps(secs)}")
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card_line()}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
