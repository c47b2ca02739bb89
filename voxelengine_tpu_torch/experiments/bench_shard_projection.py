"""The N-card sharded bench frame, projected from one card.

Counterpart of ``experiments/bench_shard_projection.py``.  The pixel-
sharded frames (``parallel/sharded.py``) hold the whole world on every
rank and do no communication inside a frame, so an N-card frame takes

    frame_N = max_i (K1 time of shard i) + rest_N

where ``rest_N`` is the rest of one shard's frame: its ray setup, shading
and composite.  Every term is measured here in one process on one card,
without a process group (each rank's pixels come from
``band_pixels`` / ``cyclic_pixels`` on a :class:`~voxelengine_tpu_torch.
parallel.mesh.Mesh` that names the rank and the size only), for N in
``--ns`` under both layouts:

  rows    row bands (``render_frame_sharded``), rank r owning rows
          ``[r H / N, (r + 1) H / N)``
  cyclic  pixel blocks dealt round-robin (``render_frame_cyclic``)

K1 alone on each shard's own rays (its rays entry, the launch that the
sharded frames make), by CUDA events over ``--repeats`` launches; ``rest_N`` is rank 0's whole shard
frame (chained frames by CUDA events) less its K1 time.  Printed: each
layout's K1 time a rank, its max/mean imbalance and frame_N, beside N = 1
(``render_frame`` and K1 on the whole frame); a layout the sharded frames
refuse for an N (1080p's 540 pre-remap rows in 8 bands) is named so.

    python -m voxelengine_tpu_torch.experiments.bench_shard_projection [--ns 2 4 8] [--repeats 10]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from voxelengine_tpu_torch.experiments.scene import Scene, bench_scene, ms_timer
from voxelengine_tpu_torch.kernels import bigtrace
from voxelengine_tpu_torch.ops.bigtrace import _kernel_tables
from voxelengine_tpu_torch.parallel import sharded
from voxelengine_tpu_torch.parallel.mesh import Mesh
from voxelengine_tpu_torch.render.frame import block_geometry, make_framebuffer, primary_rays, render_frame

LAYOUTS = ("rows", "cyclic")
FRAME_NUMBER = 1


def shard_rays(scene: Scene, layout: str, n: int, rank: int):
    """Rank ``rank`` of ``n``'s primary rays ``(origins, dirs)`` under
    ``layout`` for frame :data:`FRAME_NUMBER`, halo rows included."""
    cfg, dev = scene.cfg, scene.device
    mesh = Mesh(None, rank, n, "rows", dev)
    pixels = sharded.band_pixels if layout == "rows" else sharded.cyclic_pixels
    px, py_r = pixels(cfg, mesh, dev)
    o, d, _ = sharded._rays_for_pixels(cfg, scene.origin, scene.euler, FRAME_NUMBER, px, py_r, cfg.ortho_size)
    return o, d


def k1_ms(scene: Scene, o, d, repeats: int) -> float:
    """K1 alone on the rays ``o``, ``d``: its rays entry (the ray setup,
    the walk and the fix-up in one launch), mean ms over ``repeats``
    launches after one untimed launch.  Rays on the CPU time the plain walk
    instead (tests)."""
    bm, lt, cfg = scene.bm, scene.lt, scene.cfg
    timed = ms_timer(scene.device)
    if not o.is_cuda:
        from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm

        return timed(lambda: trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=cfg.trace_use_macro))
    tables, kw = _kernel_tables(bm, lt, cfg.max_steps, cfg.trace_use_macro)

    def launch():
        bigtrace.bigtrace_rays(o, d, *tables, **kw)

    launch()
    return timed(lambda: [launch() for _ in range(repeats)]) / repeats


def frame_ms(scene: Scene, layout: str, n: int, frames: int) -> float:
    """ms a frame of rank 0's whole shard frame (``n`` = 1: ``render_frame``),
    chained frames with the bench drift, after one untimed frame."""
    bm, lt, cfg, origin, euler, env, dev = scene
    drift = torch.tensor(1e-5, dtype=torch.float32, device=dev)
    mesh = Mesh(None, 0, n, "rows", dev)
    if n == 1:
        fb = make_framebuffer(cfg, dev)

        def frame(i):
            render_frame(bm, fb, origin, euler + drift * i, env, i, cfg, lt)
    else:
        make = sharded.make_framebuffer_rows if layout == "rows" else sharded.make_framebuffer_cyclic
        render = sharded.render_frame_sharded if layout == "rows" else sharded.render_frame_cyclic
        fb = make(cfg, mesh)

        def frame(i):
            render(bm, fb, origin, euler + drift * i, env, i, cfg, mesh, lt)
    frame(0)
    return ms_timer(dev)(lambda: [frame(i) for i in range(1, frames + 1)]) / frames


def refusal(cfg, layout: str, n: int):
    """Why ``layout`` cannot deal ``cfg``'s frame to ``n`` ranks (the
    sharded frames refuse it), or None: row bands need ``n`` to divide the
    height and the pre-remap rows (1080p's 540 rows do not divide 8), the
    cyclic deal the pixel blocks."""
    if layout == "rows":
        rows = cfg.height // 2 if cfg.checkerboard else cfg.height
        return None if cfg.height % n == 0 and rows % n == 0 else f"{rows} pre-remap rows do not divide {n} ranks"
    nb = block_geometry(cfg)[2]
    return None if nb % n == 0 else f"{nb} pixel blocks do not divide {n} ranks"


def project(scene: Scene, ns=(2, 4, 8), repeats: int = 10, frames: int = 8) -> dict:
    """``{"1": {...}, "rows": {N: {...}}, "cyclic": {N: {...}}}``: K1 a
    rank, the rest of a shard's frame, frame_N and the imbalance, or
    ``{"refused": why}`` where the layout cannot deal the frame to N."""
    o, d = primary_rays(scene.cfg, scene.origin, scene.euler, FRAME_NUMBER)[:2]
    k1 = k1_ms(scene, o, d, repeats)
    full = frame_ms(scene, "rows", 1, frames)
    out = {"1": {"k1_ms": [k1], "rest_ms": full - k1, "frame_ms": full, "rays": [int(o.shape[0])]}}
    for layout in LAYOUTS:
        out[layout] = {}
        for n in ns:
            why = refusal(scene.cfg, layout, n)
            if why:
                out[layout][n] = {"refused": why}
                continue
            rays = [shard_rays(scene, layout, n, r) for r in range(n)]
            ks = [k1_ms(scene, ro, rd, repeats) for ro, rd in rays]
            rest = frame_ms(scene, layout, n, frames) - ks[0]
            out[layout][n] = {
                "k1_ms": ks, "rays": [int(ro.shape[0]) for ro, _ in rays], "rest_ms": rest,
                "frame_ms": max(ks) + rest, "imbalance": max(ks) / float(np.mean(ks)),
            }
    return out


def main(argv=None) -> int:
    from voxelengine_tpu_torch.bench import device_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", default="full", choices=("small", "full"))
    ap.add_argument("--ns", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--cache-dir", default=".world_cache")
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_args(argv)
    scene = bench_scene(a.world, a.device, a.cache_dir)
    card = device_line(scene.device)
    res = project(scene, tuple(a.ns), a.repeats, a.frames)
    one = res["1"]
    print(f"N=1: K1 {one['k1_ms'][0]} ms, rest {one['rest_ms']} ms, frame {one['frame_ms']} ms, on {card}")
    for layout in LAYOUTS:
        for n, r in res[layout].items():
            if "refused" in r:
                print(f"N={n} {layout}: not measured, {r['refused']}", flush=True)
                continue
            print(f"N={n} {layout}: K1 a rank {' '.join(str(k) for k in r['k1_ms'])} ms; imbalance (max/mean) "
                  f"{r['imbalance']}; rest of a shard's frame {r['rest_ms']} ms; projected frame_N "
                  f"{r['frame_ms']} ms, on {card}", flush=True)
    print(json.dumps({"world": a.world, "device": card, "projection": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
