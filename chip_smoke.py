#!/usr/bin/env python3
"""Drive the PyTorch port's main render path once on an NVIDIA GPU.

    python3 chip_smoke.py               # demo config: 1024^3 terrain, 1280x720
    python3 chip_smoke.py --world full  # 8192x512x8192 terrain at 1920x1080

Phases, one stdout line each (plus the kernel's build log):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA traversal kernel (K1) from ``voxelengine_tpu_torch/csrc``;
3. noise: worldgen noise on the card against ``native/golden_noise.json``;
4. kernel vs plain: K1 against the plain torch trace on a 128x64x128
   terrain built on the card and on a random world whose chunk grid is not
   a multiple of 8 (hits, steps, normals bit-equal; positions equal on hits),
   and a small frame rendered through K1 against the plain path;
5. main path: build the terrain world, its line table and brick lines, and
   render a warm-up frame plus 8 chained checkerboard frames through
   ``render_frame(..., lt=lt)``; then the exactness gate (K1 against the
   plain trace on the full frame of rays, 0 diffs allowed);
6. times: K1 and the plain trace on that frame's rays, with CUDA events.

Then one JSON line describing each kernel, the card line again, and last
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0)
before the last line.  Needs one CUDA device; there is no CPU fallback.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAMES = 8  # timed chained frames after the warm-up
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


def phase_build():
    from voxelengine_tpu_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.bigtrace_library()
    build.load_bigtrace()
    say(f"build: K1 {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say(f"build:   ptxas {line.strip()}")


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
    say(f"times: K1 {k_ms:.3f} ms, plain trace {p_ms:.3f} ms, {o.shape[0]} rays "
        f"({o.shape[0] / k_ms / 1e3:.3f} vs {o.shape[0] / p_ms / 1e3:.3f} Mrays/s) on {card}")
    return dict(launches=launches, max_abs_err=diffs[4], ms=k_ms, plain_ms=p_ms)


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
    k1 = phase_main_path(dev, args.world)
    say(json.dumps({"kernels": [{
        "name": "bigtrace",
        "route": "cuda",
        "source": "voxelengine_tpu_torch/csrc/bigtrace.cu",
        "replaces": "voxelengine_tpu/ops/pallas_bigtrace.py:1348",
        **k1,
    }]}))
    say(f"card: {card_line()}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
