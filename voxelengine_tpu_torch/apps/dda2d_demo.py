"""2D DDA prototype / visual debugger on the PyTorch port.

Counterpart of the JAX package's ``apps/dda2d_demo.py`` (the reference's
``DDATestCpp`` app): a 2D world, a fan of radial rays traced through the
two-level 2D brickmap (1M rays a frame at the reference's scale,
``DDATestCpp.cpp:21,443-452``; on the card through K1, see
:mod:`voxelengine_tpu_torch.ops.dda2d`), drawn into a PPM: chunks (gray),
tight bounds (purple), rays (blue), hit normals (green), hit points (red);
and the average step count (``DDATestCpp.cpp:618-625``).

    python -m voxelengine_tpu_torch.apps.dda2d_demo [--world 512] [--rays 1000000] [--device cuda]

The trace is timed after one untimed warm-up call: with CUDA events on the
card, with the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from voxelengine_tpu_torch.config import default_device
from voxelengine_tpu_torch.core.brickmap import unpack_meta
from voxelengine_tpu_torch.ops.bigtrace import make_line_table
from voxelengine_tpu_torch.ops.dda2d import brickmap2d_from_dense, radial_rays, trace_brickmap_2d
from voxelengine_tpu_torch.ops.noise import perlin_noise
from voxelengine_tpu_torch.utils.profiling import device_ms


def make_world(W: int, device) -> torch.Tensor:
    """The demo's procedural 2D world, ``bool[W, W]`` on ``device`` (the
    reference loads ``voxel_buffer.txt``; this generates): perlin noise
    above 0.25, with the centre cleared."""
    ys, xs = np.mgrid[0:W, 0:W]
    pos = np.stack([xs * 0.02, ys * 0.02, np.zeros_like(xs, np.float64)], -1).astype(np.float32)
    dense = perlin_noise(torch.from_numpy(pos).to(device), 1.0, 7) > 0.25
    dense[W // 2 - 20 : W // 2 + 20, W // 2 - 20 : W // 2 + 20] = False  # clear center
    return dense


def draw(dense: np.ndarray, bm, origins, rays, out, n_rays: int) -> np.ndarray:
    """The PPM picture, ``uint8[W, W, 3]``: chunks, tight bounds, a subsample
    of the rays, hit points and hit normals (``DDATestCpp.cpp:540-600``)."""
    W = dense.shape[0]
    hits = out.hit.cpu().numpy()
    position = out.position.cpu().numpy()
    img = np.zeros((W, W, 3), np.uint8)
    img[dense] = (90, 90, 90)
    occ, bmin, bmax = (v.cpu().numpy() for v in unpack_meta(bm.meta))
    gx, gy, _ = bm.grid_dims
    f = bm.factor
    for ci in range(occ.shape[0]):
        if not occ[ci]:
            continue
        cx, cy = ci % gx, (ci // gx) % gy
        x0, y0 = cx * f + bmin[ci][0], cy * f + bmin[ci][1]
        x1, y1 = cx * f + bmax[ci][0], cy * f + bmax[ci][1]
        img[y0 : y1 + 1, [x0, x1]] = (160, 60, 160)
        img[[y0, y1], x0 : x1 + 1] = (160, 60, 160)
    # ray segments (blue polylines origin -> hit or border, DDATestCpp.cpp:563-578),
    # a subsample rasterized by parametric sampling
    draw_idx = np.linspace(0, n_rays - 1, min(n_rays, 256)).astype(int)
    seg_o, seg_d = origins[draw_idx], rays[draw_idx]
    seg_hit, seg_end = hits[draw_idx], position[draw_idx]
    # unhit rays draw to the world border: first positive t leaving [0, W]^2
    with np.errstate(divide="ignore", invalid="ignore"):
        tb = np.stack([
            (np.where(seg_d[:, 0] > 0, W, 0.0) - seg_o[:, 0]) / seg_d[:, 0],
            (np.where(seg_d[:, 1] > 0, W, 0.0) - seg_o[:, 1]) / seg_d[:, 1],
        ], -1)
    t_end = np.where(
        seg_hit,
        np.linalg.norm(seg_end[:, :2] - seg_o[:, :2], axis=-1),
        np.nanmin(np.where(tb > 0, tb, np.nan), axis=-1),
    )
    # axis-parallel rays can leave +/-inf in tb: clamp to the frame diagonal
    t_end = np.clip(np.nan_to_num(t_end, nan=float(W), posinf=float(W), neginf=0.0), 0.0, 2.0 * W)
    smp = np.linspace(0.0, 1.0, 2 * W)[None, :, None]
    line = seg_o[:, None, :2] + seg_d[:, None, :2] * (t_end[:, None, None] * smp)
    lx = np.clip(line[..., 0].astype(int), 0, W - 1).ravel()
    ly = np.clip(line[..., 1].astype(int), 0, W - 1).ravel()
    img[ly, lx] = (70, 110, 255)
    pts = position[hits]
    px = np.clip(pts[:, 0].astype(int), 0, W - 1)
    py = np.clip(pts[:, 1].astype(int), 0, W - 1)
    img[py, px] = (255, 60, 60)
    nrm = -out.normal.cpu().numpy()[hits]
    ex = np.clip((pts[:, 0] + nrm[:, 0] * 3).astype(int), 0, W - 1)
    ey = np.clip((pts[:, 1] + nrm[:, 1] * 3).astype(int), 0, W - 1)
    img[ey, ex] = (60, 220, 60)
    return img


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=512)
    ap.add_argument("--factor", type=int, default=8)  # DDATestCpp.cpp:324
    ap.add_argument("--rays", type=int, default=1000000)  # DDATestCpp.cpp:21
    ap.add_argument("--out", default="frames/dda2d.ppm")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()

    W = args.world
    dense = make_world(W, device)
    bm = brickmap2d_from_dense(dense, args.factor)
    lt = make_line_table(bm) if device.type == "cuda" else None
    origins, rays = radial_rays((W / 2.0, W / 2.0), args.rays)
    o_t, r_t = torch.from_numpy(origins).to(device), torch.from_numpy(rays).to(device)
    out, ms = device_ms(lambda _: trace_brickmap_2d(bm, o_t, r_t, lt=lt), device=device)
    print(f"{args.rays} rays in {ms:.1f} ms ({args.rays / ms / 1000:.2f} Mrays/s)")
    print(f"average steps: {out.steps.double().mean().item():.2f}")  # DDATestCpp.cpp:618-625

    img = draw(dense.cpu().numpy(), bm, origins, rays, out, args.rays)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as fobj:
        fobj.write(f"P6\n{W} {W}\n255\n".encode() + img.tobytes())
    print(f"wrote {args.out}; hit rate {out.hit.double().mean().item():.3f}")
    return out


if __name__ == "__main__":
    main()
