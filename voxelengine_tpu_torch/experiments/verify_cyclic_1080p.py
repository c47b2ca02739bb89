"""Byte-exactness of the block-cyclic frame at the production geometry.

Counterpart of ``experiments/verify_cyclic_1080p.py``: 8 ranks (gloo,
sharing the card unless there are 8) render 1920x1080 checkerboard frames
through ``parallel/sharded.py::render_frame_cyclic`` (32x30-pixel blocks,
a 60x18 grid of 1,080 blocks dealt round-robin, 135 a rank), and the
image ``cyclic_to_image`` reassembles on rank 0 is compared byte for byte
with the single-device ``render_frame`` of the same frame, on both
checkerboard parities (frame 0's ``+2`` remap needs each block's halo
row).  The world is the script's 512^3 terrain at factor 32 with 8 octaves,
built by W1 on the card, saved once and loaded by every rank; every frame
traces through its line table (K1 on the card).

    python -m voxelengine_tpu_torch.experiments.verify_cyclic_1080p [--ranks 8]

Prints one JSON line: the block geometry, the byte diffs of each parity
(0 is the pass), each rank's K1 launches; exits 1 on a diff.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from voxelengine_tpu_torch.config import Environment, RenderConfig

WORLD = (512, 512, 512)
FACTOR, OCTAVES = 32, 8
ORIGIN, EULER = (256.0, 300.0, 256.0), (-0.5, 0.75, 0.0)
RANKS = 8
GEOMETRY_1080P = (32, 30, 1080)  # block width, block height, blocks at 1920x1080
PARITIES = (0, 1)


def _world_and_lines(path: str, device):
    from voxelengine_tpu_torch.io.checkpoint import load_world
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines

    bm = load_world(path, device)
    return bm, materialize_brick_lines(bm, make_line_table(bm))


def rank_frames(mesh, world_path: str, width: int, height: int) -> dict:
    """One rank: the cyclic frames of both parities, gathered; rank 0
    returns them as images (``cyclic_to_image``)."""
    from voxelengine_tpu_torch.kernels import bigtrace
    from voxelengine_tpu_torch.parallel import sharded

    dev = mesh.device
    bm, lt = _world_and_lines(world_path, dev)
    cfg = RenderConfig(width=width, height=height, checkerboard=True)
    origin, euler = torch.tensor(ORIGIN, device=dev), torch.tensor(EULER, device=dev)
    env = Environment.default(dev)
    fb = sharded.make_framebuffer_cyclic(cfg, mesh)
    before, images = bigtrace.launches, []
    for i in PARITIES:
        sharded.render_frame_cyclic(bm, fb, origin, euler, env, i, cfg, mesh, lt)
        full = sharded.gather_rows(fb, mesh)
        if mesh.rank == 0:
            images.append(sharded.cyclic_to_image(full, cfg))
    return {"rank": mesh.rank, "k1_launches": bigtrace.launches - before, "blocks": int(fb.shape[1]),
            "images": images}


def run(device=None, ranks: int = RANKS, backend: str = "gloo", dims=WORLD, octaves: int = OCTAVES,
        width: int = 1920, height: int = 1080, workdir=None, timeout: float = 900.0) -> dict:
    """Build and save the world, render the single-device reference frames,
    then the ranks' frames; returns the JSON record (``byte_diffs`` a
    parity).  ``device`` defaults to the card."""
    from voxelengine_tpu_torch.bench import _resolve_device
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu_torch.io.checkpoint import save_world
    from voxelengine_tpu_torch.parallel.mesh import run_ranks
    from voxelengine_tpu_torch.render.frame import block_geometry, make_framebuffer, render_frame

    dev = _resolve_device(device)
    cfg = RenderConfig(width=width, height=height, checkerboard=True)
    geometry = block_geometry(cfg)
    if (width, height) == (1920, 1080) and tuple(geometry) != GEOMETRY_1080P:
        raise SystemExit(f"block geometry {geometry} at 1920x1080, not {GEOMETRY_1080P}")
    tmp = tempfile.mkdtemp(prefix="cyclic_1080p_", dir=workdir)
    try:
        t0 = time.perf_counter()
        path = str(Path(tmp) / "world.npz")
        save_world(path, build_brickmap_terrain_compact(dims, FACTOR, octaves=octaves, device=dev))
        t_world = time.perf_counter() - t0
        bm, lt = _world_and_lines(path, dev)
        origin, euler = torch.tensor(ORIGIN, device=dev), torch.tensor(EULER, device=dev)
        fb, refs = make_framebuffer(cfg, dev), []
        for i in PARITIES:
            render_frame(bm, fb, origin, euler, Environment.default(dev), i, cfg, lt=lt)
            refs.append(fb.cpu().numpy().copy())
        del bm, lt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = run_ranks(rank_frames, ranks, backend, str(dev.type), path, width, height, timeout=timeout,
                        workdir=tmp)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    images = res[0]["images"]
    diffs = [int((a.view(np.uint8) != b.view(np.uint8)).sum()) for a, b in zip(images, refs)]
    return {
        "check": "cyclic_1080p_byte_exact", "ok": not any(diffs), "width": width, "height": height,
        "geometry": list(geometry), "ranks": ranks, "blocks_per_rank": [r["blocks"] for r in res],
        "byte_diffs": diffs, "nonzero": [float((r.sum(-1) > 0).mean()) for r in refs],
        "k1_launches": [r["k1_launches"] for r in res], "world_s": t_world, "ranks_s": t_ranks,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=RANKS)
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_args(argv)
    rec = run(a.device, a.ranks)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
