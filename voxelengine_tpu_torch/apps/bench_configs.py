"""Run the BASELINE configs on the PyTorch port and print one line each.

Counterpart of the JAX package's ``apps/bench_configs.py``:

  1. oracle hit-trace parity  (the port's numpy oracle copy; K4 on the card)
  2. 64^3 dense grid, 1024x1024 depth rays (K2, ``trace_grid_vpu``)
  3. 512^3 brickmap @720p     (W1 world, ``render_frame`` with the line table: K1)
  4. 8k x 512 x 8k @1080p     (``--full``: the port's bench harness,
                              ``python -m voxelengine_tpu_torch.bench``)
  5. interactive edits        (``edit_voxels`` + re-trace through K1)

    python -m voxelengine_tpu_torch.apps.bench_configs

Times are CUDA events around the timed work, after an untimed warm-up
(``utils/profiling.py::device_ms``); each line names the card.  Without a CUDA device the script exits non-zero
(each config takes its sizes and device as arguments, so the tests run
config 1 small on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from voxelengine_tpu_torch.utils.profiling import device_ms

def config1(n: int = 100, device=None) -> str:
    """Hits of ``trace_brickmap_no_table`` (K4 for card rays) against the
    scalar oracle on ``n`` random rays over a random 32^3 world at factor 8."""
    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.brickmap import build_brickmap
    from voxelengine_tpu_torch.oracle import reference as R
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table

    device = device or torch.device("cuda")
    rng = np.random.default_rng(1234)
    dense = rng.random((32, 32, 32)) < 0.02
    dense[:, 0:4, :] = rng.random((32, 4, 32)) < 0.5
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense).to(device)), 8)
    coarse, cdims, brick, cbounds = R.make_brickmap_callbacks(dense, 8)
    r2 = np.random.default_rng(5678)
    origins = (r2.random((n, 3)) * 64 - 16).astype(np.float32)
    t = (r2.random((n, 3)) * 32).astype(np.float32)
    d = ((t - origins) / np.linalg.norm(t - origins, axis=1, keepdims=True)).astype(np.float32)
    out = trace_brickmap_no_table(bm, torch.from_numpy(origins).to(device), torch.from_numpy(d).to(device))
    hits = out.hit.cpu().numpy()
    mism = sum(hits[i] != R.raytrace_brickmap(coarse, cdims, brick, cbounds, 8, origins[i], d[i]).hit
               for i in range(n))
    return f"oracle parity: {n - mism}/{n} rays exact"


def config2(size: int = 64, width: int = 1024, height: int = 1024, reps: int = 20, device=None) -> str:
    """K2 (``trace_grid_vpu``) on a ``size``^3 terrain's ``width x height``
    depth rays, a distinct origin shift each repetition."""
    from voxelengine_tpu_torch.ops.gridtrace import trace_grid_vpu
    from voxelengine_tpu_torch.worldgen.terrain import generate_world

    device = device or torch.device("cuda")
    g = generate_world((size, size, size), octaves=8, device=device)
    u, v = np.meshgrid((np.arange(width) + 0.5) / width, (np.arange(height) + 0.5) / height)
    o = np.stack([np.full(u.size, size / 2), np.full(u.size, 90.0), np.full(u.size, -40.0)], -1)
    d = np.stack([(u.reshape(-1) - 0.5) * 1.2, -np.ones(u.size) * 0.9, np.ones(u.size)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t = torch.from_numpy(o.astype(np.float32)).to(device)
    d_t = torch.from_numpy(d.astype(np.float32)).to(device)
    _, ms = device_ms(lambda k: trace_grid_vpu(g, o_t + 1e-4 * k, d_t), reps, device)
    n = width * height
    return f"{size}^3 depth {width}x{height} (K2): {ms:.3f} ms/batch ({n / ms / 1000:.1f} Mrays/s)"


def config3(size: int = 512, width: int = 1280, height: int = 720, reps: int = 6, device=None) -> str:
    """Chained checkerboard frames of a ``size``^3 terrain (8 octaves) through
    ``render_frame`` with the line table (K1), the macro levels by the
    memoized probe."""
    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain
    from voxelengine_tpu_torch.io.checkpoint import memo_json
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table
    from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, probe_use_macro, render_frame

    device = device or torch.device("cuda")
    bm = build_brickmap_terrain((size, size, size), 32, octaves=8, device=device)
    lt = make_line_table(bm)
    cfg = RenderConfig(width=width, height=height, checkerboard=True, tile_order=True)
    env = Environment.default(device)
    o = torch.tensor([size / 2, 300.0, size / 2], dtype=torch.float32, device=device)
    e0 = torch.tensor([-0.35, 0.75, 0.0], dtype=torch.float32, device=device)
    po, pd, *_ = primary_rays(cfg, o, e0, 0)
    mk = (f"config3_{size}_o8_macroprobe_torch_v1_{cfg.width}x{cfg.height}_ms{cfg.max_steps}"
          f"_cam{'_'.join(str(float(v)) for v in o.tolist())}_e{'_'.join(str(float(v)) for v in e0.tolist())}")
    cfg = dataclasses.replace(cfg, trace_use_macro=bool(memo_json(
        ".world_cache", mk, lambda: probe_use_macro(bm, lt, po, pd, cfg))))
    fb = make_framebuffer(cfg, device)
    render_frame(bm, fb, o, e0, env, 0, cfg, lt)  # warm-up
    _, ms = device_ms(lambda k: render_frame(bm, fb, o, e0 + 1e-5 * (k + 1), env, k + 1, cfg, lt), reps, device)
    rays = cfg.width * cfg.height // 2
    return (f"{size}^3 @{height}p shaded checkerboard (K1, macro {'on' if cfg.trace_use_macro else 'off'}): "
            f"{ms:.2f} ms/frame ({1000 / ms:.1f} FPS, {rays / ms / 1000:.2f} Mrays/s)")


def config5(size: int = 256, edits: int = 64, rays: int = 1024, reps: int = 4, device=None) -> str:
    """``edit_voxels`` of ``edits`` voxels then a re-trace of ``rays`` rays
    through ``rt.raytrace`` (K1 with the macro levels off), distinct edits
    each round."""
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain
    from voxelengine_tpu_torch.engine.raytracer import VoxelRaytracer3D

    device = device or torch.device("cuda")
    rt = VoxelRaytracer3D()  # line table: O(edits) apply_edits_hbm
    rt.upload_world(build_brickmap_terrain((size, size, size), 32, octaves=8, device=device))
    o = torch.tensor([[size / 2, size * 200 / 256, size / 2]], dtype=torch.float32, device=device).repeat(rays, 1)
    d = torch.tensor([[0.2, -1.0, 0.1]], dtype=torch.float32, device=device).repeat(rays, 1)
    xs = torch.arange(edits, device=device) + size // 4
    ones = torch.ones((edits,), dtype=torch.int64, device=device)

    def interact(k):  # at size 256 the JAX config's voxels: x 64 + k .., y 150, z 128 + k
        rt.edit_voxels(xs + k, ones * (size * 150 // 256), ones * (size // 2 + k), True)
        return rt.raytrace(o, d)

    _, ms = device_ms(interact, reps, device)
    return f"edit {edits} voxels + re-trace {rays} rays (apply_edits_hbm + K1): {ms:.3f} ms/interaction"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="also run config 4: the bench harness (python -m voxelengine_tpu_torch.bench)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_configs: no CUDA device (torch.cuda.is_available() is false); the configs time the "
                         "card and have no CPU fallback")
    card = torch.cuda.get_device_name(0)
    print(f"devices: {torch.cuda.device_count()} x {card}\n")
    for fn in (config1, config2, config3, config5):
        t0 = time.perf_counter()
        line = fn()
        print(f"[{fn.__name__}] {line}  (setup+run {time.perf_counter() - t0:.1f}s, {card})", flush=True)
    if args.full:  # config 4 in its own process, as the JAX configs run bench.py
        return subprocess.run([sys.executable, "-m", "voxelengine_tpu_torch.bench"]).returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
