#!/usr/bin/env python3
"""Time the port's traversal kernels (K1-K5) of several source trees in
turns on one NVIDIA GPU.

    python3 kernel_ab.py                          # this checkout alone
    python3 kernel_ab.py --before _checkout/prev  # an earlier checkout too, in turns (repeatable)
    python3 kernel_ab.py --quick                  # without the 1024^3 demo frame (~95 s of worldgen)
    python3 kernel_ab.py --sass sass_out          # also write each traversal library's SASS there
    python3 kernel_ab.py --variant='-maxrregcount=72'  # this checkout built with other nvcc flags too
    python3 kernel_ab.py --only 'K4-compact|K4-slab'  # only the cases whose names match (inputs built for them)
    python3 kernel_ab.py --quick --only 'ray setup' --before _checkout/prev  # the bench frame's primary_rays in two trees
    python3 kernel_ab.py --quick --only 'bench frame' --before _checkout/prev --sass sass_out  # the frame's kernels, in turns
    python3 kernel_ab.py --zsharded --before _checkout/prev  # the z-sharded shaded bench frame on 4 ranks, in turns
    python3 kernel_ab.py --quick --only 'app query' --before _checkout/prev  # raytrace of a query batch in two trees
    python3 kernel_ab.py --quick --only 'turned' --before _checkout/prev  # K1 on the turning camera's frames, in turns

K1, K4, K4-compact, K5 and K4-slab are timed through their rays entries
(origins and raw directions in, the ray setup and the ``hit_imm`` fix-up in
the launch), the wrapper called alone or through the tree's whole trace
call.  The inputs are made once, in this process, on the card: the demo
frame's 460,800 rays over the 1024^3 terrain (``chip_smoke.py`` phase 5),
the dense path's 64^3 terrain with the last dense frame's 460,800 rays and
the config-2 batch of 1,048,576 rays (phase 8), the sparse 16k world's
262,144 rays (phase 10), and K4's 1,048,576 random rays over the 128^3
terrain at factor 8 (phase 9), as given and sorted by direction octant,
then by the chunk of the clipped start, and as given through the tree's
whole ``trace_brickmap_no_table`` call; without ``--quick`` also K4 on
terrains of 16-224 KB of meta with each of its two instantiations (shared
or global meta, forced through the wrapper's limit).  K3 is also timed in
its global instantiation (plain blocks, the four-plane fetch; forced
through the wrapper's limit) on the config-2 batch.  On the bench frame's
1,036,800 rays over the 8192x512x8192 world (built by W1), macro levels
off: K4-compact (``bmtrace_compact_rays``) alone and as the whole
``trace_brickmap_no_table`` call, K1 (``bigtrace_rays``) alone and as the
whole ``trace_brickmap_hbm`` call, the frame's shading and composite (the
shading kernel's composite
entry, or the eager ``shade_traced`` and ``composite_frame``), the shading
alone (the ``shade`` entry: color and write, no composite) and 8 chained
``render_frame`` frames, primary and shaded (shadows, AO 4, reflections);
each kind of the shaded frame's secondary traces (the tree's
``_secondary_inputs``: one launch of K1's or K4-compact's secondary entry,
or the eager rays around the rays entry's walks) and, through K1, the same
kind's eager rays (made once) through the rays entry alone; K1's rays entry and each kind of its
secondary stage at 8 yaws, evenly spaced, of the benchmark's turning camera (the position and pitch of
``voxbench/traffic/terrain8k_1080p.shaded.json``; each yaw's rays and primary trace made once), 8
launches a call, reported a frame; K4-compact also on K4's random rays over the 128^3
terrain made compact; K4-slab's
batch form (``bmtrace_slab_rays``) on the 1024^3 world with dense slots at
4 slabs: round 0 over the 1280x720 frame's whole batch on the slab that
owns most of its rays, over the rays that slab owns and over 2,048 of them,
round 1 on the rows it hands down (made once by this checkout's K4-slab),
and the whole world as one slab (one rank's whole walk), beside K4's rays
entry on the same rays.  The bench
frame's ray setup: one ``primary_rays`` call at 1920x1080 (the ray-setup
kernel, ``csrc/rays.cu``, in a tree that has it; an earlier tree's eager
ops).  The ray API's call: ``VoxelRaytracer3D.raytrace`` of 1,048,576
rays around the app's camera over its 1024^3 world with the line table,
as the benchmark's query cell calls it (K1's record entry, or an earlier
tree's rays entry and eager record).  K2 and K3 are timed alone (the
kernel's launch; a tree whose kernel takes prepared rays gets them from
its own ray setup, made once) and as the whole ``trace_grid_vpu`` /
``trace_grid_mxu`` call; the dense frame as 8 chained ``render_frame_dense``
frames, whose CUDA kernels ``torch.profiler`` also counts; K5 at each
refill of ``--refills``.  Each build (a tree,
or this checkout with extra nvcc flags) is
then timed in a worker process of its own that imports that tree's
``voxelengine_tpu_torch`` wrappers (their Python signatures are the same
across trees): the order is the earlier trees, this one, its variants,
then the same backwards, so that drift on the card shows as a difference
between the two runs of one build.  Each time is the median of 5 windows
of 20 launches, by CUDA events, after 0.3 s of untimed launches that
bring the card's clocks up; beside it, the kernels' own device time a
call from ``torch.profiler`` over 20 more (the event time of a host-bound
call also counts the card's idle gaps; a count of kernels a call that is
not a whole number shows that the profiler lost events).  Each worker
also prints a digest of every kernel's outputs (for K2 and K3 alone: of
hit and steps, which are the same before the wrapper's zero-step fix-up),
so the trees' results can be seen to be equal (K4-slab's: the results, the
counts and the paused rays' rows and batch indices in batch order, since
the card appends them in its warps' order).  Prints each library's ptxas
registers and spills, one JSON line per worker, and the card's name and
power limit;
with ``--sass``, also whether each kernel function of the first earlier
tree has the same SASS in this checkout.  With ``--zsharded`` it times
only the z-sharded shaded frame instead (shadows, AO 4, reflections; the
bench world at 1920x1080 through K1's replicated walk,
``render_frame_zsharded`` with ``make_zsharded_hbm``), on 4 gloo ranks
sharing the one card, each tree's ranks in turns (earlier trees, this one,
then backwards): each rank's host wall time a frame from a barrier, over
``ZS_FRAMES`` frames after an untimed one, the frames' checksum and
their peak ``max_memory_allocated`` a rank.  Four
ranks share one card there: the times are no scale-out figure.  Needs one
CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPEATS = 20  # launches (or dense frames) in one timed window
WINDOWS = 5  # timed windows; the median is reported
WARM_S = 0.3  # seconds of launches before the first window, so the card's clocks are up
# cases timed as 8 chained frames (or 8 yaws' launches), reported a frame
FRAME_KINDS = ("dense_frames", "bench_frames", "turned_rays", "turned_secondary")
ZS_RANKS = 4  # ranks of the z-sharded frame (--zsharded), sharing the card over gloo
ZS_FRAMES = 5  # its timed frames a run, after an untimed one
# the libraries whose SASS --sass writes and compares: the traversal kernels
SASS_LIBRARIES = ("bigtrace", "rrtrace", "gridtrace", "bmtrace", "zslab")


def say(*parts):
    print(*parts, flush=True)


def make_inputs(dev, quick: bool, refills, only=None):
    """``{case: (kernel, args, kw)}`` for the workers, built on ``dev``;
    with ``only`` (a regex), the cases whose names match it."""
    import torch

    import chip_smoke as cs
    from voxelengine_tpu_torch.config import MAX_STEPS, RenderConfig
    from voxelengine_tpu_torch.core.brickmap import build_brickmap, build_brickmap_terrain_compact, compact_brickmap
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines
    from voxelengine_tpu_torch.render.frame import primary_rays
    from voxelengine_tpu_torch.worldgen.terrain import generate_world

    def wanted(name):
        return only is None or re.search(only, name) is not None

    cases = {}
    # the bench frame's ray setup (phase 15): primary_rays, whatever kernels the tree launches for it
    dims, W, H = cs.WORLDS["full"]
    cases["ray setup, bench frame (primary_rays call)"] = (
        "ray_setup", (torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev),
                      torch.tensor(cs.CAMERAS[0], device=dev)), dict(width=W, height=H))
    # the dense path (phase 8): K2 on the last frame's rays, K3 on the config-2 batch, the frames
    g = generate_world((64, 64, 64), octaves=8, device=dev)
    grid = (g.words, g.dims, g.layout.value)
    cfg = RenderConfig(width=1280, height=720, checkerboard=True)
    origin = torch.tensor([32.0, 40.0, -20.0], device=dev)
    euler = torch.tensor([-0.35, 3.14159, 0.0], device=dev)
    fo, fd, _, _, _ = primary_rays(cfg, origin, euler + 1e-5 * cs.FRAMES, cs.FRAMES)
    co, cd = cs.config2_rays(dev)
    cases["K2 dense frame rays, alone"] = ("grid", (fo, fd) + grid, dict(max_steps=cfg.max_steps))
    cases["K2 dense frame rays, trace_grid_vpu call"] = ("grid_call", (fo, fd) + grid, dict(max_steps=cfg.max_steps))
    cases["K3 config-2 batch, alone"] = ("grid_limbs", (co, cd) + grid, dict(max_steps=MAX_STEPS))
    # K3 in plain 128-thread blocks with the four-plane fetch: the global
    # instantiation, forced through the wrapper's limit (trees that have one)
    cases["K3 config-2 batch, alone, global instantiation"] = (
        "grid_limbs", (co, cd) + grid, dict(max_steps=MAX_STEPS, _k3_limit=0))
    cases["K3 config-2 batch, trace_grid_mxu call"] = ("grid_limbs_call", (co, cd) + grid, dict(max_steps=MAX_STEPS))
    cases["dense frame (8 chained render_frame_dense, ms a frame)"] = (
        "dense_frames", grid + (origin, euler), dict(width=cfg.width, height=cfg.height))

    def k5_cases(what, args, kw):
        for r in refills:
            cases[f"K5 {what} refill {r}"] = ("rrtrace_rays", args, dict(kw, refill=r))

    if not quick:
        dims, W, H = cs.WORLDS["demo"]
        bm = build_brickmap_terrain_compact(dims, 32, device=dev)
        lt = materialize_brick_lines(bm, make_line_table(bm))
        cfg = RenderConfig(width=W, height=H, checkerboard=True, tile_order=True)
        origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)
        euler = torch.tensor([-0.25, 0.75, 0.0], device=dev)
        o, d, _, _, _ = primary_rays(cfg, origin, euler + 1e-5 * cs.FRAMES, cs.FRAMES)
        args, kw = line_args(bm, lt, o, d, cfg.max_steps, False)
        cases["K1 frame macro off"] = ("bigtrace_rays", args, kw)
        k5_cases("frame macro off", args, kw)

    bm = cs.sparse_world(dev)
    lt = materialize_brick_lines(bm, make_line_table(bm))
    o, d = cs.sparse_rays(cs.SPARSE_RAYS, dev)
    args, kw = line_args(bm, lt, o, d, MAX_STEPS, False)
    cases["K1 sparse macro off"] = ("bigtrace_rays", args, kw)
    cases["K1 sparse macro on"] = ("bigtrace_rays", args, dict(kw, use_macro=True))
    k5_cases("sparse macro on", args, dict(kw, use_macro=True))
    # the tree's whole trace_brickmap_hbm_rr call
    cases["K5 sparse macro on, trace_brickmap_hbm_rr call"] = ("k5_call", (bm, lt, o, d), dict(max_steps=MAX_STEPS))

    def k4_args(bm):
        return cs.random_rays(bm.world_dims, 1 << 20, 2.0, 109, dev), k4_kw(bm, 2048)

    if not quick:
        # K4 with meta in shared and in global memory on terrains of growing
        # meta (16-224 KB), to place the shared-memory limit
        for dims in ((128, 128, 128), (256, 128, 256), (384, 128, 384), (448, 128, 448), (512, 128, 448)):
            bm = build_brickmap(generate_world(dims, octaves=8, device=dev), 8)
            rays, kw = k4_args(bm)
            name = f"K4 {dims[0]}x{dims[1]}x{dims[2]} ({bm.num_chunks * 4 // 1024} KB meta)"
            for where, limit in (("shared", bm.num_chunks * 4), ("global", 0)):
                cases[f"{name} {where}"] = ("bmtrace_rays", rays + (bm.meta, bm.bricks), dict(kw, _smem_limit=limit))

    bm = build_brickmap(generate_world((128, 128, 128), octaves=8, device=dev), 8)
    rays, kw = k4_args(bm)
    cases["K4 random"] = ("bmtrace_rays", rays + (bm.meta, bm.bricks), kw)
    # the same rays through the tree's whole trace call
    cases["K4 random, trace_brickmap_no_table call"] = ("k4_call", (bm, *rays), dict(max_steps=2048))
    cases["K4 sorted"] = ("bmtrace_rays", cs.direction_sorted(bm, *rays) + (bm.meta, bm.bricks), kw)
    # K4-compact on K4's random rays over the same terrain made compact
    cbm = compact_brickmap(bm)
    name = "K4-compact random rays, 128^3 compact"
    cases[name] = ("bmtrace_compact_rays", rays + (cbm.meta, cbm.brick_idx, cbm.bricks), kw)
    if any(wanted(n) for n in BENCH_FRAME_CASES):
        bench_frame_cases(cases, dev)
    if wanted(QUERY_CASE):
        query_case(cases, dev)
    if wanted("K4-slab"):
        slab_cases(cases, dev)
    return {k: v for k, v in cases.items() if wanted(k)}


def line_args(bm, lt, o, d, max_steps, use_macro):
    """The arguments and keywords of K1's and K5's rays entries for rays
    ``o``, ``d`` through ``bm``'s line table ``lt``."""
    from voxelengine_tpu_torch.ops.bigtrace import _kernel_tables

    tables, kw = _kernel_tables(bm, lt, max_steps, use_macro)
    return (o, d) + tables, kw


def k4_kw(bm, max_steps):
    """The keywords of K4's rays entries for ``bm``."""
    return dict(grid_dims=bm.grid_dims, factor=bm.factor, max_steps=max_steps, coarse_layout=bm.coarse_layout,
                brick_layout=bm.brick_layout)


# the cases on the bench frame (bench_frame_cases); --only picks among them by these names
SECONDARY_KINDS = ("shadow", "reflection", "ao")
BENCH_FRAME_CASES = (
    "K4-compact bench frame", "K4-compact bench frame, trace_brickmap_no_table call", "K1 bench frame, alone",
    "K1 bench frame, trace_brickmap_hbm call", "bench frame shading (shade + composite)",
    "bench frames (8 chained render_frame, ms a frame)", "bench frame shading, shade entry (color, write)",
    "bench frames shaded (8 chained render_frame, ms a frame)",
    *(f"{k} bench frame {kind}, secondary stage" for kind in SECONDARY_KINDS for k in ("K1", "K4-compact")),
    *(f"K1 bench frame {kind}, its walks through the rays entry" for kind in SECONDARY_KINDS),
    "bench frame, rank 0's band of 4 (render_frame_sharded)", "bench frame, rank 0's blocks of 4 (render_frame_cyclic)",
    "bench frame, rank 0's band of 4, its composite alone (composite entry, the band its destination)",
    "bench frame secondary rays for a caller's tracer, build (3 kinds)",
    "bench frame secondary rays for a caller's tracer, reduce (AO)",
    "K1 bench frame turned (8 yaws), rays entry",
    *(f"K1 bench frame turned (8 yaws) {kind}, secondary entry" for kind in SECONDARY_KINDS),
)
# the turning camera of the benchmark's shaded 8k traffic, whose position and pitch the turned cases take
TURN_TRAFFIC = ROOT / "voxbench" / "traffic" / "terrain8k_1080p.shaded.json"
TURN_YAWS = 8  # yaws a turn, evenly spaced


QUERY_CASE = "app query batch, raytrace call"


def query_case(cases, dev):
    """``VoxelRaytracer3D.raytrace`` of a query batch over the app's world,
    as the benchmark's ``app1k_720p.query`` cell calls it: the 1024^3
    terrain at factor 32 with dense slots and its line table, 1,048,576
    rays with origins uniform in a 64-voxel cube around (136, 330, 936) and
    directions uniform on the sphere (the tree's card path: K1's rays entry
    and the eager record, or K1's record entry)."""
    import torch

    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines

    bm = build_brickmap_terrain((1024, 1024, 1024), 32, octaves=32, device=dev)
    lt = materialize_brick_lines(bm, make_line_table(bm))
    gen = torch.Generator(device=dev).manual_seed(311)
    n = 1 << 20
    box = (torch.rand((n, 3), generator=gen, device=dev) - 0.5) * 64
    o = torch.tensor([136.0, 330.0, 936.0], device=dev) + box
    d = torch.randn((n, 3), generator=gen, device=dev)
    cases[QUERY_CASE] = ("raytrace", (bm, lt, o, d / d.norm(dim=-1, keepdim=True)), dict(max_steps=2048))


def bench_frame_cases(cases, dev):
    """The bench frame's 1,036,800 rays over the bench world (``chip_smoke.py``
    phases 5, 14 and 18), macro levels off as the probe decides there:
    K4-compact's and K1's rays entries alone and as the whole
    ``trace_brickmap_no_table`` and ``trace_brickmap_hbm`` calls, the
    frame's shading and composite, and 8 chained ``render_frame`` frames."""
    import torch

    import chip_smoke as cs
    from voxelengine_tpu_torch.config import RenderConfig
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines
    from voxelengine_tpu_torch.render.frame import primary_rays

    dims, W, H = cs.WORLDS["full"]
    bm = build_brickmap_terrain_compact(dims, 32, device=dev)
    lt = materialize_brick_lines(bm, make_line_table(bm))
    cfg = RenderConfig(width=W, height=H, checkerboard=True, tile_order=True)
    origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)
    euler = torch.tensor(cs.CAMERAS[0], device=dev)
    o, d, _, _, _ = primary_rays(cfg, origin, euler, 1)
    names = iter(BENCH_FRAME_CASES)
    cases[next(names)] = ("bmtrace_compact_rays", (o, d, bm.meta, bm.brick_idx, bm.bricks), k4_kw(bm, cfg.max_steps))
    cases[next(names)] = ("k4_call", (bm, o, d), dict(max_steps=cfg.max_steps))
    cases[next(names)] = ("bigtrace_rays", *line_args(bm, lt, o, d, cfg.max_steps, False))
    cases[next(names)] = ("k1_call", (bm, lt, o, d), dict(max_steps=cfg.max_steps, use_macro=False))
    frame_kw = dict(width=W, height=H)
    cases[next(names)] = ("shade_stage", (bm, lt, origin, euler), frame_kw)
    cases[next(names)] = ("bench_frames", (bm, lt, origin, euler), frame_kw)
    cases[next(names)] = ("shade_entry", (bm, lt, origin, euler), frame_kw)
    cases[next(names)] = ("bench_frames", (bm, lt, origin, euler), dict(frame_kw, shaded=True))
    # the shaded frame's secondary traces, a kind at a time: the tree's
    # _secondary_inputs (the secondary entries, or the eager rays around K1's
    # or K4's rays entry), and the same eager rays' walks alone
    for kind in SECONDARY_KINDS:
        for table in (lt, None):
            cases[next(names)] = ("secondary_stage", (bm, table, origin, euler), dict(frame_kw, kind=kind))
    for kind in SECONDARY_KINDS:
        cases[next(names)] = ("secondary_walks", (bm, lt, origin, euler), dict(frame_kw, kind=kind))
    # one rank's frame of the pixel-sharded layouts (no collective in a frame):
    # its rays, trace and shading, then the pair select (eager) or the shading
    # kernel's composite entry into the rank's part
    for layout in ("rows", "cyclic"):
        cases[next(names)] = ("sharded_frame", (bm, lt, origin, euler), dict(frame_kw, layout=layout, rank=0, ranks=4))
    # a tree's new kernels alone: the band's composite (its trace made once), and
    # the shaded frame's secondary rays built and reduced around K1 as a caller's tracer
    cases[next(names)] = ("dest_composite", (bm, lt, origin, euler), dict(frame_kw, rank=0, ranks=4))
    for part in ("build", "reduce"):
        cases[next(names)] = ("secondary_kernels", (bm, lt, origin, euler), dict(frame_kw, part=part, shaded=True))
    # K1's rays and secondary entries at 8 yaws of the benchmark's turning camera
    # (its position and pitch), where walk lengths vary more than at the fixed camera
    cam = json.loads(TURN_TRAFFIC.read_text())["camera"]
    yaws = torch.arange(TURN_YAWS, dtype=torch.float64) * (2 * math.pi / TURN_YAWS)
    eulers = torch.stack([torch.full_like(yaws, cam["pitch"]), yaws, torch.zeros_like(yaws)], 1).float().to(dev)
    turned = (bm, lt, torch.tensor(cam["position"], device=dev), eulers)
    cases[next(names)] = ("turned_rays", turned, frame_kw)
    for kind in SECONDARY_KINDS:
        cases[next(names)] = ("turned_secondary", turned, dict(frame_kw, kind=kind))


def slab_cases(cases, dev):
    """K4-slab's batch form on the 1024^3 world with dense slots at 4 slabs
    (``chip_smoke.py`` phase 13's migration world and frame): round 0 on
    the slab that owns most of the frame's rays, over the whole batch, over
    the rays it owns and over 2,048 of them; round 1 on the rows it hands
    down; the whole world as one slab; K4's rays entry on the same rays."""
    import torch

    import chip_smoke as cs
    from voxelengine_tpu_torch.config import RenderConfig
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain
    from voxelengine_tpu_torch.kernels import bmtrace
    from voxelengine_tpu_torch.ops.trace import _ray_setup
    from voxelengine_tpu_torch.parallel.distributed import shard_world_z
    from voxelengine_tpu_torch.render.frame import primary_rays

    app = build_brickmap_terrain(cs.APP_WORLD, 32, device=dev)
    cfg = RenderConfig(width=cs.APP_SIZE[0], height=cs.APP_SIZE[1], checkerboard=True, tile_order=True)
    origin = torch.tensor([cs.APP_WORLD[0] / 2, cs.APP_CAMERA_Y, cs.APP_WORLD[2] / 2], device=dev)
    o, d, _, _, _ = primary_rays(cfg, origin, torch.tensor([-0.25, 0.75, 0.0], device=dev), 1)
    o = o.contiguous()
    n = 4
    meta_s, bricks_s, slab_gz = shard_world_z(app, n)
    _, start_c, _, active = _ray_setup(app.grid_dims, app.factor, o, d)
    owner = torch.clamp(start_c[:, 2].to(torch.int32) // slab_gz, 0, n - 1)
    k = int(torch.mode(owner[active]).values)
    idx = torch.nonzero(active & (owner == k)).squeeze(1)
    own = (o[idx].contiguous(), d[idx].contiguous())
    few = (own[0][:2048].contiguous(), own[1][:2048].contiguous())
    gz = app.grid_dims[2]
    skw = dict(grid_dims=app.grid_dims, slab_gz=slab_gz, factor=app.factor, max_steps=cfg.max_steps,
               brick_layout=app.brick_layout)
    slab = lambda j: (meta_s[j].clone(), bricks_s[j].clone())  # noqa: E731
    # round 0 over the whole batch, with the rows handed down made once
    outs = tuple(torch.zeros(shape, dtype=dt, device=dev) for shape, dt in
                 (((o.shape[0],), torch.int32), ((o.shape[0], 3), torch.float32),
                  ((o.shape[0], 3), torch.float32), ((o.shape[0],), torch.int32)))
    rows, ridx, counts = bmtrace.bmtrace_slab_rays(*slab(k), o, d, outs, z0=k * slab_gz, **skw)
    paused = int(counts[1])
    down = rows[:paused, bmtrace.STATE_CELL.start + 2] < k * slab_gz
    handed, hidx = rows[:paused][down].contiguous(), ridx[:paused][down].contiguous()
    groups = {
        f"K4-slab batch form round 0, slab {k} of 4, the whole frame batch ({o.shape[0]} rays)":
            (slab(k) + (o, d), dict(skw, z0=k * slab_gz)),
        f"K4-slab round 0, slab {k} of 4 ({idx.numel()} frame rays)": (slab(k) + own, dict(skw, z0=k * slab_gz)),
        f"K4-slab round 0, slab {k} of 4, 2048 of its frame rays": (slab(k) + few, dict(skw, z0=k * slab_gz)),
        f"K4-slab round 1, slab {k - 1} of 4 ({handed.shape[0]} handed-down rows)":
            (slab(k - 1) + (o, d), dict(skw, z0=(k - 1) * slab_gz, rows=handed, idx=hidx)),
        f"K4-slab whole world as one slab ({o.shape[0]} frame rays)":
            ((app.meta, app.bricks, o, d), dict(skw, z0=0, slab_gz=gz)),
    }
    for name, (args, kw) in groups.items():
        cases[name] = ("slab_rays", args, kw)
    kw4 = k4_kw(app, cfg.max_steps)
    cases[f"K4-slab beside: K4 on slab {k}'s round-0 rays"] = ("bmtrace_rays", own + (app.meta, app.bricks), kw4)
    cases["K4-slab beside: K4 on 2048 of them"] = ("bmtrace_rays", few + (app.meta, app.bricks), kw4)
    cases["K4-slab beside: K4 on the whole frame"] = ("bmtrace_rays", (o, d, app.meta, app.bricks), kw4)


def tree_functions(torch):
    """``{kernel kind: fn(args, kw) -> (launch(), outputs to digest)}`` for
    the tree on ``sys.path``, adapting to its wrappers' signatures."""
    import inspect

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.kernels import bigtrace, bmtrace, gridtrace, rrtrace
    from voxelengine_tpu_torch.ops import bigtrace as ops_bigtrace
    from voxelengine_tpu_torch.ops import gridtrace as ops_grid
    from voxelengine_tpu_torch.ops import trace as ops_trace
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table
    from voxelengine_tpu_torch.render import frame as render
    from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, render_frame, render_frame_dense

    fused = "origins" in inspect.signature(gridtrace.gridtrace).parameters

    def grid(o, d, words, dims, layout):
        g = BitGrid(words=words, dims=tuple(dims), layout=Layout(layout))
        if fused:
            return g, (o, d)
        dd, st, _, active = ops_trace._ray_setup(g.dims, 1, o, d)
        pad = ops_trace._edge_pad(st.to(torch.int32), ops_trace._dims(g.dims, torch.int32, o.device), dd)
        return g, (st, dd, active.to(torch.int32), pad)

    def alone(fn, table):
        def make(args, kw):
            g, rays = grid(*args)
            t = table(g)
            kw = dict(kw, dims=g.dims, layout=g.layout)
            return (lambda: fn(*rays, t, **kw)), (lambda out: (out[0] != 0, out[3]))
        return make

    def call(fn):
        def make(args, kw):
            g, _ = grid(*args)
            return (lambda: fn(g, args[0], args[1], kw["max_steps"])), (lambda out: out)
        return make

    def frames(args, kw):
        words, dims, layout, origin, euler = args
        g = BitGrid(words=words, dims=tuple(dims), layout=Layout(layout))
        cfg = RenderConfig(width=kw["width"], height=kw["height"], checkerboard=True)
        env = Environment.default(origin.device)
        fb = make_framebuffer(cfg, origin.device)

        def run():
            for i in range(1, 9):
                render_frame_dense(g, fb, origin, euler + 1e-5 * i, env, i, cfg)
            return (fb,)
        return run, (lambda out: out)

    def plain(fn):
        return lambda args, kw: ((lambda: fn(*args, **kw)), (lambda out: out))

    def ray_setup(args, kw):
        cfg = RenderConfig(width=kw["width"], height=kw["height"], checkerboard=True, tile_order=True)
        return (lambda: primary_rays(cfg, *args, 1)), (lambda out: out)

    def k1_call(args, kw):
        bm, lt, o, d = args
        return (lambda: trace_brickmap_hbm(bm, lt, o, d, kw["max_steps"], use_macro=kw["use_macro"])), (lambda out: out)

    def raytrace(args, kw):
        from voxelengine_tpu_torch.engine.raytracer import VoxelRaytracer3D

        bm, lt, o, d = args
        rt = VoxelRaytracer3D()
        rt.upload_world_lines(bm, lt)
        fields = ("valid", "hit_point", "normal", "distance", "voxel_index", "steps")
        return (lambda: rt.raytrace(o, d, kw["max_steps"])), (lambda out: [getattr(out, k) for k in fields])

    def k4_call(args, kw):
        bm, o, d = args
        return (lambda: trace_brickmap_no_table(bm, o, d, kw["max_steps"])), (lambda out: out)

    def bench_cfg(kw):
        shading = {}
        if kw.get("shaded"):
            shading = dict(shadow_rays=True, ao_samples=4, reflections=True)
        elif "kind" in kw:
            shading = {"shadow": dict(shadow_rays=True), "reflection": dict(reflections=True),
                       "ao": dict(ao_samples=4)}[kw["kind"]]
        return RenderConfig(width=kw["width"], height=kw["height"], checkerboard=True, tile_order=True,
                            trace_use_macro=False, **shading)

    def primary(args, cfg):
        """The frame's rays and their primary trace (K1, or K4 without a
        line table), made once."""
        bm, lt, origin, euler = args
        o, d, px, py, py_r = primary_rays(cfg, origin, euler, 1)
        out = (trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=False) if lt is not None
               else trace_brickmap_no_table(bm, o, d, cfg.max_steps))
        return o, d, px, py, py_r, out

    def secondary_digest(res):  # shadow (hit, steps), reflection (hit, position, normal), or the AO factor
        shadow, reflection, ao = res
        return tuple(shadow or ()) + tuple((reflection or ())[:3]) + ((ao,) if ao is not None else ())

    def secondary_stage(args, kw):
        """One kind of the shaded frame's secondary traces: the tree's
        ``_secondary_inputs`` (one secondary launch, or the eager rays
        around the rays entry's walks)."""
        bm, lt = args[:2]
        cfg = bench_cfg(kw)
        env = Environment.default(args[2].device)
        o, d, px, py, _, out = primary(args, cfg)
        return (lambda: render._secondary_inputs(bm, lt, out, d, px, py, env, 1, cfg)), secondary_digest

    def secondary_walks(args, kw):
        """The same kind's eager rays (made once) through K1's rays entry:
        the walks alone."""
        bm, lt = args[:2]
        cfg = bench_cfg(kw)
        env = Environment.default(args[2].device)
        o, d, px, py, _, out = primary(args, cfg)
        walks = []
        render._secondary_inputs(bm, lt, out, d, px, py, env, 1, cfg,
                                 secondary=lambda a, b, ms: walks.append((a.contiguous(), b.contiguous(), ms))
                                 or trace_brickmap_hbm(bm, lt, a, b, ms, use_macro=False))
        # the walks' results field by field, so that AO's samples digest the same
        # as one batch or as one walk a sample
        return (lambda: [trace_brickmap_hbm(bm, lt, a, b, ms, use_macro=False) for a, b, ms in walks]), (
            lambda out_: tuple(torch.cat(f) for f in zip(*out_)))

    def shade_entry(args, kw):
        """The frame's shading alone, the shading kernel's ``shade`` entry
        (color and write, no composite)."""
        bm, lt, origin, euler = args
        cfg = bench_cfg(kw)
        env = Environment.default(origin.device)
        o, d, px, py, py_r, out = primary(args, cfg)
        return (lambda: render.shade_traced(bm, out, o, d, px, py, py_r, origin, env, 1, cfg, lt)), (lambda r: r)

    def shade_stage(args, kw):
        """The frame's shading and composite after its primary trace: the
        shading kernel's composite entry in a tree that has it, else the
        eager shading and composite."""
        bm, lt, origin, euler = args
        cfg = bench_cfg(kw)
        env = Environment.default(origin.device)
        fb = make_framebuffer(cfg, origin.device)
        o, d, px, py, py_r = primary_rays(cfg, origin, euler, 1)
        trace = (bm, trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=False), o, d, px, py, py_r, origin,
                 env, 1, cfg, lt)
        if hasattr(render, "shade_and_composite"):
            return (lambda: render.shade_and_composite(fb, *trace)), (lambda out: (out,))
        return (lambda: render.composite_frame(fb, *render.shade_traced(*trace), cfg, 1)), (lambda out: (out,))

    def bench_frames(args, kw):
        bm, lt, origin, euler = args
        cfg = bench_cfg(kw)
        env = Environment.default(origin.device)
        fb = make_framebuffer(cfg, origin.device)

        def run():
            for i in range(1, 9):
                render_frame(bm, fb, origin, euler + 1e-5 * i, env, i, cfg, lt=lt)
            return (fb,)
        return run, (lambda out: out)

    def turned_rays(args, kw):
        """K1's rays entry on each yaw's primary rays (made once): 8 launches
        a call."""
        bm, lt, origin, eulers = args
        cfg = bench_cfg(kw)
        rays = [primary_rays(cfg, origin, e, 1)[:2] for e in eulers]
        return (lambda: [trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=False) for o, d in rays]), (
            lambda out: tuple(torch.cat(f) for f in zip(*out)))

    def turned_secondary(args, kw):
        """One kind's secondary stage on each yaw's primary trace (made once):
        8 launches of K1's secondary entry a call (the eager rays around the
        rays entry in a tree without it)."""
        bm, lt, origin, eulers = args
        cfg = bench_cfg(kw)
        env = Environment.default(origin.device)
        yaws = [primary((bm, lt, origin, e), cfg) for e in eulers]

        def run():
            return [render._secondary_inputs(bm, lt, out, d, px, py, env, 1, cfg) for _, d, px, py, _, out in yaws]
        return run, (lambda res: tuple(torch.cat(f) for f in zip(*(secondary_digest(r) for r in res))))

    def k5_call(args, kw):
        bm, lt, o, d = args
        return (lambda: ops_bigtrace.trace_brickmap_hbm_rr(bm, lt, o, d, kw["max_steps"])), (lambda out: out)

    def sharded_frame(args, kw):
        """Rank ``kw['rank']``'s frame of a pixel-sharded layout on its own
        (a frame makes no collective call): the tree's render_frame_sharded
        or render_frame_cyclic."""
        from voxelengine_tpu_torch.parallel import sharded
        from voxelengine_tpu_torch.parallel.mesh import Mesh

        bm, lt, origin, euler = args
        cfg = bench_cfg(kw)
        env = Environment.default(origin.device)
        mesh = Mesh(None, kw["rank"], kw["ranks"], "rows", origin.device)
        rows = kw["layout"] == "rows"
        fb = (sharded.make_framebuffer_rows if rows else sharded.make_framebuffer_cyclic)(cfg, mesh)
        render = sharded.render_frame_sharded if rows else sharded.render_frame_cyclic
        return (lambda: (render(bm, fb, origin, euler, env, 2, cfg, mesh, lt),)), (lambda out: out)

    def dest_composite(args, kw):
        """The band's shading and composite alone in the shading kernel's
        composite entry, the band its destination (a tree that has it), its
        rays and trace made once."""
        from voxelengine_tpu_torch.kernels import shade as shade_kernel
        from voxelengine_tpu_torch.parallel import sharded
        from voxelengine_tpu_torch.parallel.mesh import Mesh

        if not hasattr(sharded, "band_dest"):
            return None
        bm, lt, origin, euler = args
        cfg = bench_cfg(kw)
        env = Environment.default(origin.device)
        mesh = Mesh(None, kw["rank"], kw["ranks"], "rows", origin.device)
        px, py_r = sharded.band_pixels(cfg, mesh, origin.device)
        o, d, py = sharded._rays_for_pixels(cfg, origin, euler, 2, px, py_r, cfg.ortho_size)
        out = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=False)
        fb = sharded.make_framebuffer_rows(cfg, mesh)
        dest = sharded.band_dest(cfg, mesh)
        return (lambda: (shade_kernel.shade_composite(fb, out, o, d, px, py, py_r, origin, env, cfg, dest=dest),)), (
            lambda r: r)

    def secondary_kernels(args, kw):
        """A shaded frame's secondary rays for a caller's tracer (a tree that
        has ``kernels/secondary.py``): the three kinds' build launches, or
        AO's reduce launch on K1's results for its built rays (made once)."""
        try:
            from voxelengine_tpu_torch.kernels import secondary as sk
            from voxelengine_tpu_torch.ops.secondary import frame_kinds, walk_steps
        except ImportError:
            return None
        bm, lt = args[:2]
        cfg = bench_cfg(kw)
        env = Environment.default(args[2].device)
        o, d, px, py, _, out = primary(args, cfg)
        inputs = dict(light=env.light_direction, dirs=d, px=px, py=py, width=cfg.width, frame_number=1,
                      ao_samples=cfg.ao_samples)
        kinds = frame_kinds(cfg)

        def builds():
            return [sk.secondary_build(k, out.position, out.normal, **inputs) for k in kinds]
        if kw["part"] == "build":
            return builds, (lambda r: tuple(t for pair in r for t in pair))
        rays = sk.secondary_build("ao", out.position, out.normal, **inputs)
        res = trace_brickmap_hbm(bm, lt, *rays, walk_steps("ao", cfg), use_macro=False)
        hit, pos = res.hit.contiguous(), res.position.contiguous()

        def reduces():
            return (sk.secondary_reduce(out.position, hit, pos, ao_samples=cfg.ao_samples),)
        return reduces, (lambda r: r)

    def slab_rays(args, kw):
        meta, bricks, o, d = args
        n = o.shape[0]
        # the batch-wide outputs, written again alike by each launch
        outs = (torch.zeros((n,), dtype=torch.int32, device=o.device), torch.zeros((n, 3), device=o.device),
                torch.zeros((n, 3), device=o.device), torch.zeros((n,), dtype=torch.int32, device=o.device))

        def run():
            return outs, bmtrace.bmtrace_slab_rays(meta, bricks, o, d, outs, **kw)

        def digested(out):  # the results, and the paused rays' rows in batch order
            outs, (rows, idx, counts) = out
            k = int(counts[1])
            order = torch.argsort(idx[:k])
            return outs + (counts, idx[:k][order], rows[:k][order])
        return run, digested

    return {
        "bigtrace_rays": plain(bigtrace.bigtrace_rays), "bmtrace_rays": plain(bmtrace.bmtrace_rays),
        "rrtrace_rays": plain(rrtrace.rrtrace_rays), "bmtrace_compact_rays": plain(bmtrace.bmtrace_compact_rays),
        "grid": alone(gridtrace.gridtrace, lambda g: g.words),
        "grid_limbs": alone(gridtrace.gridtrace_limbs, lambda g: ops_grid.words_to_limb_rows(g.words)),
        "grid_call": call(ops_grid.trace_grid_vpu), "grid_limbs_call": call(ops_grid.trace_grid_mxu),
        "dense_frames": frames, "ray_setup": ray_setup, "k1_call": k1_call, "k4_call": k4_call, "raytrace": raytrace,
        "shade_stage": shade_stage, "bench_frames": bench_frames, "shade_entry": shade_entry,
        "secondary_stage": secondary_stage, "secondary_walks": secondary_walks, "k5_call": k5_call,
        "sharded_frame": sharded_frame, "slab_rays": slab_rays, "dest_composite": dest_composite,
        "secondary_kernels": secondary_kernels, "turned_rays": turned_rays, "turned_secondary": turned_secondary,
    }


def own_profiling():
    """This checkout's ``voxelengine_tpu_torch/utils/profiling.py``, loaded
    from its file under a name of its own, so that a worker whose tree (an
    earlier one, first on ``sys.path``) lacks ``kernel_profile`` still has
    it."""
    spec = importlib.util.spec_from_file_location(
        "_kernel_ab_profiling", ROOT / "voxelengine_tpu_torch" / "utils" / "profiling.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def worker(tree: Path, data: Path, defines: str) -> None:
    """Time every case of ``data`` with ``tree``'s ``voxelengine_tpu_torch``,
    its CUDA libraries built with the extra nvcc ``defines``; print one
    JSON line."""
    profiling = own_profiling()  # before the tree goes first on sys.path

    sys.path.insert(0, str(tree))
    import torch

    import voxelengine_tpu_torch as pkg
    from voxelengine_tpu_torch.kernels import bmtrace, build, gridtrace

    build.NVCC_FLAGS = build.NVCC_FLAGS + tuple(defines.split())
    fns = tree_functions(torch)
    cases = torch.load(data, weights_only=False)
    own_limit = getattr(bmtrace, "SMEM_META_LIMIT", None)
    own_k3_limit = getattr(gridtrace, "SMEM_WORDS_LIMIT", None)
    ms, digest, kernels, dev_ms = {}, {}, {}, {}
    for name, (kind, args, kw) in cases.items():
        kw = dict(kw)
        limit = kw.pop("_smem_limit", None)
        k3_limit = kw.pop("_k3_limit", None)
        if (limit is not None and own_limit is None) or (k3_limit is not None and own_k3_limit is None):
            continue  # a tree whose K4 or K3 has one instantiation
        if own_limit is not None:
            bmtrace.SMEM_META_LIMIT = own_limit if limit is None else limit
        if own_k3_limit is not None:
            gridtrace.SMEM_WORDS_LIMIT = own_k3_limit if k3_limit is None else k3_limit
        made = fns[kind](args, kw)
        if made is None:
            continue  # a case this tree's wrappers do not have
        fn, digested = made
        outs = fn()  # the build, at first use
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in digested(outs):
            h.update(t.cpu().numpy().tobytes())
        digest[name] = h.hexdigest()[:16]
        # kernels and device time a call (a frame: a run of 8 frames / 8)
        frames = kind in FRAME_KINDS
        calls = REPEATS if not frames else 1
        names, dev = profiling.kernel_profile(fn, calls)
        per = calls * (8 if frames else 1)
        kernels[name], dev_ms[name] = (None, None) if names is None else (len(names) / per, sum(dev) / per)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARM_S:
            for _ in range(10 if not frames else 1):
                fn()
            torch.cuda.synchronize()
        reps = REPEATS if not frames else 1
        windows = []
        for _ in range(WINDOWS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            windows.append(start.elapsed_time(end) / (reps if not frames else 8))
        ms[name] = sorted(windows)[WINDOWS // 2]
    print(json.dumps({"tree": str(Path(pkg.__file__).resolve().parent.parent), "defines": defines, "ms": ms,
                      "digest": digest, "kernels": kernels, "dev_ms": dev_ms}), flush=True)


def zs_rank(mesh, cache: str, key: str, dims, size, camera, frames: int) -> dict:
    """One rank of ``--zsharded`` (the tree first on ``sys.path``): the
    bench world from ``cache``, its ``make_zsharded_hbm`` row, then ``frames
    + 1`` shaded ``render_frame_zsharded`` frames through K1's replicated
    walk; the host wall time of each after the first, from a barrier to the
    end of its work on the card."""
    import torch
    import torch.distributed as dist

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.io.checkpoint import generate_or_load
    from voxelengine_tpu_torch.parallel import distributed as D
    from voxelengine_tpu_torch.render.frame import make_framebuffer

    def not_cached():
        raise RuntimeError("the bench world is not in the cache")

    dev = mesh.device
    zw = D.make_zsharded_hbm(generate_or_load(cache, key, not_cached, device=dev), mesh.size, mesh.rank)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)  # the frames' peak, not the world load's
    cfg = RenderConfig(width=size[0], height=size[1], checkerboard=True, tile_order=True, shadow_rays=True,
                       ao_samples=4, reflections=True)
    origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)
    euler = torch.tensor(camera, device=dev)
    env = Environment.default(dev)
    fb = make_framebuffer(cfg, dev)
    times = []
    for i in range(frames + 1):
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        D.render_frame_zsharded(None, fb, origin, euler + 1e-5 * i, env, i, cfg, mesh, zw=zw)
        torch.cuda.synchronize(dev)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return {"rank": mesh.rank, "ms": times, "checksum": float(fb.double().sum()),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def zs_worker(tree: Path, cache: str, key: str) -> None:
    """Time the z-sharded frame with ``tree``'s package on ``ZS_RANKS``
    ranks; print one JSON line."""
    sys.path.insert(0, str(tree))
    import voxelengine_tpu_torch as pkg
    from voxelengine_tpu_torch.parallel.mesh import run_ranks

    import chip_smoke as cs

    dims, W, H = cs.WORLDS["full"]
    res = run_ranks(zs_rank, ZS_RANKS, "gloo", "cuda", cache, key, dims, (W, H), cs.CAMERAS[0], ZS_FRAMES,
                    timeout=900, workdir=str(ROOT / "_checkout"))
    print(json.dumps({"tree": str(Path(pkg.__file__).resolve().parent.parent), "ranks": res}), flush=True)


def zsharded(builds) -> None:
    """``--zsharded``: the bench world built once into a cache under
    ``_checkout``, then each tree's ranks in turns (module doc)."""
    import tempfile

    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    cache = tempfile.mkdtemp(prefix="zs_cache_", dir=ROOT / "_checkout")
    try:
        dims = cs.WORLDS["full"][0]
        bm, lt, _, key = cs.bench_world(dev, dims, cache, {})
        del bm, lt
        torch.cuda.empty_cache()
        trees = [t for t, _ in builds]
        order = trees + trees[::-1] if len(trees) > 1 else trees
        runs = []
        for tree in order:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--zs-worker", str(tree), cache,
                                   key], cwd=tree, capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                say(f"z-sharded worker for {tree} failed:\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
                continue
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(run)
            ms = [sorted(r["ms"])[len(r["ms"]) // 2] for r in run["ranks"]]
            say(f"z-sharded shaded frame ({ZS_RANKS} ranks sharing one card over gloo, not a scale-out figure), "
                f"{tree}: median ms a frame per rank {[round(x, 1) for x in ms]} (each rank's {ZS_FRAMES} frames: "
                f"{[[round(x, 1) for x in r['ms']] for r in run['ranks']]}), checksum "
                f"{run['ranks'][0]['checksum']:.6f}, peak max_memory_allocated per rank "
                f"{[r['peak_bytes'] for r in run['ranks']]} B")
        if len({round(r["ranks"][0]["checksum"], 3) for r in runs}) > 1:
            say("z-sharded shaded frame: the trees' frames DIFFER")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    say(f"card: {cs.card_line()}")


def run_worker(tree: Path, defines: str, data: Path) -> dict:
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(tree), str(data),
                           f"--defines={defines}"], cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        say(f"worker for {tree} {defines} failed:\n{proc.stdout}{proc.stderr}")
        return None
    line = proc.stdout.strip().splitlines()[-1]
    say(line)
    return json.loads(line)


def sass_summary(sass: str):
    """One line per kernel function of a ``cuobjdump -sass`` dump: its
    instructions, and in its main loop (the longest backward branch) the
    instructions, table loads (LDG, LDS, generic LD), local-memory spill
    accesses (LDL, STL), IEEE division checks (FCHK) and indirect branches
    (BRX, a jump table)."""
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        ins = [(int(a, 16), op.strip()) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        loops = [(int(m.group(1), 16), a) for a, op in ins
                 if (m := re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", op)) and int(m.group(1), 16) < a]
        lo, hi = max(loops, key=lambda t: t[1] - t[0], default=(0, -1))
        body = [op for a, op in ins if lo <= a <= hi]

        def count(*ops):
            return sum(1 for op in body if re.search(r"(^|\s)(" + "|".join(ops) + r")[.\s]", op + " "))

        yield (f"{name[:110]}: {len(ins)} instructions; main loop {len(body)} "
               f"(loads {count('LDG', 'LDS', 'LD')}, spill accesses {count('LDL', 'STL')}, FCHK {count('FCHK')}, "
               f"BRX {count('BRX')})")


def sass_functions(sass: str) -> dict:
    """``{kernel function: its instructions}`` of a ``cuobjdump -sass`` dump,
    the anonymous namespace's per-file tag taken out of the names (it
    differs between trees) so that the same kernel of two trees pairs up."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "_ZN_anon_",
                      part.split("\n", 1)[0].strip())
        out[name] = tuple(re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part))
    return out


def ptxas_lines(tree: Path):
    for log in sorted((tree / "voxelengine_tpu_torch" / "kernels" / "_build").glob("lib*.log")):
        flags = " ".join(f for f in log.read_text().split(None, 40)[:40] if f.startswith("-D"))
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                yield f"{log.stem.split('_')[0]} {flags}: {line.strip()}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, action="append", default=[],
                    help="root of an earlier checkout to time in turns with this one; repeatable")
    ap.add_argument("--quick", action="store_true", help="leave out the 1024^3 demo frame")
    ap.add_argument("--sass", type=Path, help="directory for cuobjdump -sass of each tree's kernel libraries")
    ap.add_argument("--refills", default="32,16,8,4,1", help="K5's refills to time, comma-separated")
    ap.add_argument("--only", help="a regex: time only the cases whose names match it")
    ap.add_argument("--variant", action="append", default=[],
                    help="extra nvcc flags of one more build of this checkout (--variant='-maxrregcount=72'); "
                         "repeatable")
    ap.add_argument("--zsharded", action="store_true",
                    help="time only the z-sharded shaded bench frame on 4 ranks sharing the card, trees in turns")
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--zs-worker", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--defines", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(Path(args.worker[0]), Path(args.worker[1]), args.defines)
    if args.zs_worker:
        return zs_worker(Path(args.zs_worker[0]), args.zs_worker[1], args.zs_worker[2])

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    say(f"card: {cs.card_line()}")
    builds = [(b.resolve(), "") for b in args.before] + [(ROOT, "")] + [(ROOT, v) for v in args.variant]
    if args.zsharded:
        return zsharded(builds)
    data = ROOT / "_checkout" / "kernel_ab_inputs.pt"
    data.parent.mkdir(exist_ok=True)
    torch.save(make_inputs(dev, args.quick, [int(r) for r in args.refills.split(",")], args.only), data)
    order = builds + builds[::-1] if len(builds) > 1 else builds
    runs = [run_worker(t, v, data) for t, v in order]
    order, runs = [b for b, r in zip(order, runs) if r], [r for r in runs if r]
    sass_of = {}
    for tree in dict.fromkeys(t for t, _ in builds):
        say(f"ptxas, {tree}:")
        for line in ptxas_lines(tree):
            say(f"  {line}")
        if args.sass:
            args.sass.mkdir(parents=True, exist_ok=True)
            for lib in sorted((tree / "voxelengine_tpu_torch" / "kernels" / "_build").glob("lib*.so")):
                if lib.name.split("_")[0][3:] in SASS_LIBRARIES:
                    out = args.sass / f"{'after' if tree == ROOT else tree.name}_{lib.stem}.sass"
                    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
                    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True)
                    out.write_text(sass.stdout + sass.stderr)
                    sass_of.setdefault(tree, {}).update(sass_functions(sass.stdout))
                    flags = [f for f in lib.with_suffix(".log").read_text().split()[:40] if f.startswith("-D")]
                    say(f"  SASS of {lib.name} {' '.join(flags)} -> {out}")
                    for line in sass_summary(sass.stdout):
                        say(f"    {line}")
    if args.before and args.sass:
        before, after = sass_of.get(args.before[0].resolve(), {}), sass_of.get(ROOT, {})
        same = sorted(k for k in before.keys() & after.keys() if before[k] == after[k])
        differ = sorted(k for k in before.keys() & after.keys() if before[k] != after[k])
        say(f"SASS of {args.before[0]} against this checkout: {len(same)} kernel functions identical "
            f"instruction for instruction: {same}; differ: {differ}; only in this checkout: "
            f"{sorted(after.keys() - before.keys())}; only there: {sorted(before.keys() - after.keys())}")
    names = dict.fromkeys(k for r in runs for k in r["ms"])
    say("case: " + " | ".join(f"{t}{' ' + v if v else ''}" for t, v in order))
    for name in names:
        have = [r for r in runs if name in r["ms"]]
        say(f"{name}: " + " | ".join(f"{r['ms'][name]:.4f} ms" if name in r["ms"] else "-" for r in runs)
            + ("" if len({r["digest"][name] for r in have}) == 1 else "  OUTPUTS DIFFER"))
    for name in dict.fromkeys(k for r in runs for k in r.get("dev_ms", {})):
        say(f"device time (torch.profiler), {name}: "
            + " | ".join(f"{r['dev_ms'][name]:.4f} ms" if r.get("dev_ms", {}).get(name) else "-" for r in runs))
    for name in dict.fromkeys(k for r in runs for k in r.get("kernels", {})):
        if name.startswith(("K1 bench", "K2", "K3", "K4 random", "K4-compact bench", "dense", "bench", "app query")):
            say(f"CUDA kernels launched, {name}: "
                + " | ".join(str(r.get("kernels", {}).get(name, "-")) for r in runs))
    say(f"card: {cs.card_line()}")
    data.unlink()


if __name__ == "__main__":
    main()
