#!/usr/bin/env python3
"""Drive the PyTorch port's render paths once on an NVIDIA GPU.

    python3 chip_smoke.py               # demo config: 1024^3 terrain, 1280x720
    python3 chip_smoke.py --world full  # 8192x512x8192 terrain at 1920x1080

Phases, one stdout line each (plus the kernels' build logs):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every CUDA kernel (K1-K4) from ``voxelengine_tpu_torch/csrc``,
   one nvcc per source, all started together;
3. noise: worldgen noise on the card against ``native/golden_noise.json``;
4. kernel vs plain: K1 against the plain torch trace on a 128x64x128
   terrain built on the card and on a random world whose chunk grid is not
   a multiple of 8 (hits, steps, normals bit-equal; positions equal on hits),
   and a small frame rendered through K1 against the plain path;
5. main path: build the terrain world, its line table and brick lines, and
   render a warm-up frame plus 8 chained checkerboard frames through
   ``render_frame(..., lt=lt)``; then the exactness gate (K1 against the
   plain trace on the full frame of rays, 0 diffs allowed);
6. times: K1 and the plain trace on that frame's rays, with CUDA events;
7. dense kernels vs plain: K2 and K3 against the plain ``trace_grid`` on a
   random 32^3 grid in each layout, and a 96x64 ``render_frame_dense``
   frame through K2 against the plain path;
8. dense path at the JAX package's config-2 size (``apps/bench_configs.py``):
   a 64^3 terrain from ``generate_world``, its 1024x1024 ray batch through
   K2 (``trace_grid_vpu``), K3 (``trace_grid_mxu``) and the plain trace,
   then a warm-up plus 8 chained 1280x720 checkerboard
   ``render_frame_dense`` frames and the exactness gate on the last frame;
9. on-chip brickmap: K4 (``trace_brickmap_mxu``) against the plain trace on
   1,048,576 rays over a 128^3 terrain at factor 8 and on a small
   TILED_MORTON world; times.

Each kernel's path (phase 5 for K1, the frames of phase 8 for K2, the
phase-8 batch for K3, the phase-9 batch for K4) runs with the launch counts
set to 0 just before it and read just after; launches made to compare or
time a kernel are not counted.  Then one JSON line describing each kernel
(its time, its plain version's, and its bound: the larger of its bytes
(rays in and out plus the table words its hits need) over the card's
memory rate and its float operations over its float32 rate), the card
line again, and last ``{"ok": true, "device": {...}}``.
Any failure raises (exit code != 0) before the last line.  Needs one CUDA
device; there is no CPU fallback.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
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
# every kernel reads start, dir, pad (12 B each) and active (4 B) and writes
# flags, steps (4 B each), position and normal (12 B each) per ray
RAY_BYTES = 72
# float ops of one DDA step: the axis pick (3 compares), the two entry
# coordinates off the stepped axis (2 mul + 2 add), the tMax add; ray setup
# and the coarse level's box test are not counted
OPS_PER_STEP = 8
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
    """Mean device time of ``fn()`` over ``repeats`` runs, by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def bound(rays: int, table_bytes: int, steps_sum: int):
    """``(bound_ms, bound_by)``: the larger of the bytes the trace must move
    (rays in and out, and the ``table_bytes`` its hits need, see
    :func:`hit_table_bytes`) over the memory rate and its DDA float
    operations over the float32 rate."""
    bytes_ms = (rays * RAY_BYTES + table_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = steps_sum * OPS_PER_STEP / F32_OPS_PER_S * 1e3
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


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, rays, table_bytes, steps_sum):
    """One kernel's record for the ``kernels`` JSON line."""
    bound_ms, bound_by = bound(rays, table_bytes, steps_sum)
    return {
        "name": name, "route": "cuda", "source": f"voxelengine_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no PyTorch call computes a DDA traversal
        "rays": rays, "steps_sum": steps_sum, "table_bytes": table_bytes,
    }


def phase_build():
    from voxelengine_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.KERNEL_SOURCES)) as pool:  # one nvcc per source, all started together
        list(pool.map(build.load_kernel, build.KERNEL_SOURCES))
    libs = {name: build.kernel_library(name) for name in build.KERNEL_SOURCES}  # built: only hashes
    say(f"build: {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc per source, in parallel)")
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say(f"build:   {name}: {line.strip()}")


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
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines, trace_brickmap_hbm
    from voxelengine_tpu_torch.ops.trace import trace_brickmap
    from voxelengine_tpu_torch.render.frame import make_framebuffer, render_frame

    worlds = {
        "terrain 128x64x128 f32": (build_brickmap_terrain_compact((128, 64, 128), 32, device=dev), 1.5, 512),
        "random 72x40x88 f8 (grid 9x5x11)": (random_brickmap((72, 40, 88), 8, 0.02, 5, dev), 3.0, 256),
    }
    for i, (name, (bm, spread, max_steps)) in enumerate(worlds.items()):
        o, d = random_rays(bm.world_dims, 65536, spread, 100 + i, dev)
        lt = materialize_brick_lines(bm, make_line_table(bm))
        got = trace_brickmap_hbm(bm, lt, o, d, max_steps)
        want = trace_brickmap(bm, o, d, max_steps)
        diffs = compare(got, want)
        say(f"kernel vs plain (tolerance: bit-equal): {name}, {o.shape[0]} rays, hits {int(want.hit.sum())}: "
            f"hit diffs {diffs[0]}, steps diffs {diffs[1]}, normal diffs {diffs[2]}, position diffs {diffs[3]}")
        if any(diffs[:4]):
            raise SystemExit(f"K1 disagrees with the plain trace on {name}")

    bm, _, _ = worlds["terrain 128x64x128 f32"]
    lt = materialize_brick_lines(bm, make_line_table(bm))
    cfg = RenderConfig(width=160, height=96, checkerboard=True, tile_order=True, max_steps=512)
    env = Environment.default(dev)
    origin = torch.tensor([64.0, 60.0, 64.0], device=dev)
    euler = torch.tensor([-0.3, 0.75, 0.0], device=dev)
    a = render_frame(bm, make_framebuffer(cfg, dev), origin, euler, env, 1, cfg, lt=lt)
    b = render_frame(bm, make_framebuffer(cfg, dev), origin, euler, env, 1, cfg)
    n = int((a != b).any(dim=-1).sum())
    say(f"kernel vs plain: 160x96 frame through K1 vs plain trace: {n} pixel diffs")
    if n:
        raise SystemExit("a frame rendered through K1 differs from the plain path")


def phase_main_path(dev, world: str):
    import torch

    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.kernels import bigtrace
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines, trace_brickmap_hbm
    from voxelengine_tpu_torch.ops.trace import trace_brickmap
    from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, render_frame

    dims, W, H = WORLDS[world]
    t0 = time.perf_counter()
    bm = build_brickmap_terrain_compact(dims, 32, device=dev)
    torch.cuda.synchronize()
    t_world = time.perf_counter() - t0
    t0 = time.perf_counter()
    lt = materialize_brick_lines(bm, make_line_table(bm))
    torch.cuda.synchronize()
    t_lt = time.perf_counter() - t0
    say(f"main path: world {dims[0]}x{dims[1]}x{dims[2]} f32 built in {t_world:.1f} s "
        f"({bm.bricks.shape[0]} bricks, {bm.bricks.numel() * 4 / 1e9:.3f} GB); "
        f"line table + brick lines {t_lt:.2f} s ({lt.num_regions} regions)")

    cfg = RenderConfig(width=W, height=H, checkerboard=True, tile_order=True)
    env = Environment.default(dev)
    origin = torch.tensor([dims[0] / 2, 380.0, dims[2] / 2], device=dev)  # bench.py:191-192
    euler = torch.tensor([-0.25, 0.75, 0.0], device=dev)
    fb = make_framebuffer(cfg, dev)
    rays_per_frame = W * H // 2

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

    # exactness gate: K1 against the plain trace on the full frame of rays
    o, d, _, _, _ = primary_rays(cfg, origin, euler + 1e-5 * FRAMES, FRAMES)
    got = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps)
    want = trace_brickmap(bm, o, d, cfg.max_steps)
    diffs = compare(got, want)
    hit_frac = float(want.hit.float().mean())
    say(f"main path: exactness gate (tolerance: bit-equal), {o.shape[0]} rays: "
        f"hit diffs {diffs[0]}, steps diffs {diffs[1]}, "
        f"normal diffs {diffs[2]}, position diffs {diffs[3]}")
    if any(diffs[:4]):
        raise SystemExit("exactness gate failed: K1 disagrees with the plain trace on the frame")
    if not 0.0 < hit_frac < 1.0:
        raise SystemExit(f"implausible hit fraction {hit_frac}")
    say(f"main path: {W}x{H} checkerboard tile_order, {FRAMES} chained frames: "
        f"{frame_ms:.3f} ms/frame, {rays_per_frame / frame_ms / 1e3:.3f} Mrays/s primary, "
        f"hit fraction {hit_frac:.4f}, K1 launches {launches}, "
        f"framebuffer checksum {float(fb.double().sum()):.6f}")

    # times: K1 alone (ray setup excluded) and the plain trace, same rays
    from voxelengine_tpu_torch.ops.trace import _edge_pad, _ray_setup

    dd, start_c, _, active = _ray_setup(bm.grid_dims, 32, o, d)
    pad = _edge_pad(start_c.to(torch.int32), torch.tensor(bm.grid_dims, dtype=torch.int32, device=dev), dd)
    args = (start_c.contiguous(), dd.contiguous(), active.to(torch.int32), pad.contiguous(),
            lt.region_lines, lt.brick_lines)
    kw = dict(grid_dims=bm.grid_dims, region_dims=lt.region_dims, factor=32,
              wpb=bm.words_per_brick, max_steps=cfg.max_steps, brick_layout=bm.brick_layout)
    k_ms = cuda_ms(lambda: bigtrace.bigtrace(*args, **kw), repeats=10)
    p_ms = cuda_ms(lambda: trace_brickmap(bm, o, d, cfg.max_steps), repeats=1)
    card = card_line()
    steps_sum = int(got.steps.sum())
    say(f"times: K1 {k_ms:.3f} ms, plain trace {p_ms:.3f} ms, {o.shape[0]} rays "
        f"({o.shape[0] / k_ms / 1e3:.3f} vs {o.shape[0] / p_ms / 1e3:.3f} Mrays/s), "
        f"sum(steps) {steps_sum}, on {card}")
    return kernel_entry(
        "bigtrace", "bigtrace.cu", "voxelengine_tpu/ops/pallas_bigtrace.py:1348", launches, diffs[4], k_ms, p_ms,
        o.shape[0], hit_table_bytes(want, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick), steps_sum,
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
    color, write = shade_traced(out, origins, dirs, px, py, py_r, origin, env, cfg)
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
    from voxelengine_tpu_torch.kernels import gridtrace
    from voxelengine_tpu_torch.ops.gridtrace import trace_grid_mxu, trace_grid_vpu, words_to_limb_rows
    from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup, trace_grid
    from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, render_frame_dense
    from voxelengine_tpu_torch.worldgen.terrain import generate_world

    t0 = time.perf_counter()
    g = generate_world((64, 64, 64), octaves=8, device=dev)
    torch.cuda.synchronize()
    say(f"dense path: world 64x64x64 (octaves 8) in {time.perf_counter() - t0:.2f} s, "
        f"{int(g.count())} solid voxels, {g.words.numel() * 4} bytes of words")

    # the config-2 batch: K3's path (trace_grid_mxu), K2 and the plain trace
    o, d = config2_rays(dev)
    gridtrace.launches = gridtrace.limb_launches = 0
    k3 = trace_grid_mxu(g, o, d)
    torch.cuda.synchronize()
    k3_launches = gridtrace.limb_launches
    if k3_launches != 1:
        raise SystemExit(f"trace_grid_mxu launched K3 {k3_launches} times, not once")
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

    # times on the config-2 batch: the kernels alone (ray setup excluded)
    dd, st, _, active = _ray_setup(g.dims, 1, o, d)
    pad = _edge_pad(st.to(torch.int32), _dims(g.dims, torch.int32, dev), dd)
    args = (st, dd, active.to(torch.int32), pad)
    kw = dict(dims=g.dims, layout=g.layout, max_steps=2048)
    limbs = words_to_limb_rows(g.words)
    k2_ms = cuda_ms(lambda: gridtrace.gridtrace(*args, g.words, **kw), repeats=10)
    k3_ms = cuda_ms(lambda: gridtrace.gridtrace_limbs(*args, limbs, **kw), repeats=10)
    p_ms = cuda_ms(lambda: trace_grid(g, o, d), repeats=1)
    steps_sum = int(want.steps.sum())
    say(f"times: K2 {k2_ms:.3f} ms, K3 {k3_ms:.3f} ms, plain trace_grid {p_ms:.3f} ms, {o.shape[0]} rays, "
        f"sum(steps) {steps_sum}, on {card_line()}")
    n, table_bytes = o.shape[0], hit_table_bytes(want, g.dims, g.layout)
    return [
        kernel_entry("gridtrace", "gridtrace.cu", "voxelengine_tpu/ops/pallas_trace.py:329", k2_launches,
                     err["K2"], k2_ms, p_ms, n, table_bytes, steps_sum),
        kernel_entry("gridtrace_limbs", "gridtrace.cu", "voxelengine_tpu/ops/pallas_trace.py:93", k3_launches,
                     err["K3"], k3_ms, p_ms, n, table_bytes, steps_sum),
    ]


def phase_bmtrace(dev):
    """Phase 9: K4 at its documented scope (128^3 at factor 8) and on a
    TILED_MORTON world; returns its record."""
    import torch

    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.brickmap import build_brickmap
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.kernels import bmtrace
    from voxelengine_tpu_torch.ops.trace import _dims, _edge_pad, _ray_setup, trace_brickmap
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_mxu
    from voxelengine_tpu_torch.worldgen.terrain import generate_world

    t0 = time.perf_counter()
    bm = build_brickmap(generate_world((128, 128, 128), octaves=8, device=dev), 8)
    torch.cuda.synchronize()
    say(f"on-chip brickmap: world 128^3 f8 (octaves 8, dense slots, {bm.coarse_layout.name}/"
        f"{bm.brick_layout.name}) built in {time.perf_counter() - t0:.2f} s, "
        f"{int(((bm.meta >> 30) & 1).sum())} of {bm.num_chunks} chunks occupied")
    o, d = random_rays(bm.world_dims, 1 << 20, 2.0, 109, dev)
    bmtrace.launches = 0
    got = trace_brickmap_mxu(bm, o, d)
    torch.cuda.synchronize()
    launches = bmtrace.launches
    if launches != 1:
        raise SystemExit(f"trace_brickmap_mxu launched K4 {launches} times, not once")
    want = trace_brickmap(bm, o, d)
    diffs = compare(got, want)
    err = diffs[4]
    check_diffs("on-chip brickmap: K4 vs plain, 128^3 f8", diffs, o.shape[0], int(want.hit.sum()))

    dense = random_grid((64, 64, 64), 0.008, 11, dev)
    mbm = build_brickmap(BitGrid.from_dense(dense), 8, coarse_layout=Layout.TILED_MORTON,
                         brick_layout=Layout.TILED_MORTON)
    mo, md = random_rays(mbm.world_dims, 65536, 1.9, 111, dev)
    mwant = trace_brickmap(mbm, mo, md, 256)
    diffs = compare(trace_brickmap_mxu(mbm, mo, md, 256), mwant)
    err = max(err, diffs[4])
    check_diffs("on-chip brickmap: K4 vs plain, random 64^3 f8 TILED_MORTON/TILED_MORTON", diffs, mo.shape[0],
                int(mwant.hit.sum()))

    dd, start_c, _, active = _ray_setup(bm.grid_dims, bm.factor, o, d)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, dev), dd)
    args = (start_c, dd, active.to(torch.int32), pad, bm.meta, bm.bricks)
    kw = dict(grid_dims=bm.grid_dims, factor=bm.factor, max_steps=2048,
              coarse_layout=bm.coarse_layout, brick_layout=bm.brick_layout)
    k_ms = cuda_ms(lambda: bmtrace.bmtrace(*args, **kw), repeats=10)
    p_ms = cuda_ms(lambda: trace_brickmap(bm, o, d), repeats=1)
    steps_sum = int(want.steps.sum())
    say(f"times: K4 {k_ms:.3f} ms, plain trace_brickmap {p_ms:.3f} ms, {o.shape[0]} rays, "
        f"sum(steps) {steps_sum}, on {card_line()}")
    return kernel_entry("bmtrace", "bmtrace.cu", "voxelengine_tpu/ops/pallas_trace2.py:39", launches, err, k_ms,
                        p_ms, o.shape[0],
                        hit_table_bytes(want, bm.world_dims, bm.brick_layout, bm.factor, bm.words_per_brick),
                        steps_sum)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", choices=sorted(WORLDS), default="demo",
                    help="demo: 1024^3 at 1280x720 (default); full: 8192x512x8192 at 1920x1080")
    args = ap.parse_args(argv)

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
    kernels = [phase_main_path(dev, args.world)]
    err = phase_dense_vs_plain(dev)
    kernels += phase_dense_path(dev, err)
    kernels.append(phase_bmtrace(dev))
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise SystemExit(f"kernels never launched on their path: {idle}")
    say(json.dumps({"kernels": kernels}))
    say(f"card: {card_line()}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
