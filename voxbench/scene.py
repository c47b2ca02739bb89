"""Inputs the benchmark makes from a cell's traffic file and the seed: the
camera of every frame or call, the query rays, and the samples the check
compares.

Camera paths (``traffic["camera"]["path"]``):

* ``orbit``: a fixed position; pitch fixed; the yaw turns once every
  ``frames_per_turn`` frames from a start the seed sets.
* ``fly``: the upstream app's headless fly-through (``apps/voxel_app.py``
  of the port: "w" every frame, "right" when the frame index is a multiple
  of 3, ``speed`` voxels a "w", 0.04 rad a "right", moving along the
  look direction as the app does), from ``start`` and ``euler``, begun
  again every ``frames_per_turn`` frames; the seed sets where on it the run
  starts.

Either way every seed gives the same set of views in another order.  The
path is computed on the host in float32, as the app moves its camera.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TURN = 0.04  # rad a "right" (apps/voxel_app.py)


def _look(euler: np.ndarray) -> np.ndarray:
    """The app's movement direction: the negated forward of the basis."""
    pitch, yaw = euler[0], euler[1]
    return -np.array([np.cos(pitch) * np.sin(yaw), -np.sin(pitch), np.cos(pitch) * np.cos(yaw)], np.float32)


def camera_table(camera: dict, seed: int):
    """``(positions f32[P, 3], eulers f32[P, 3], phase)``: one period of the
    path and the index the run starts at."""
    n = int(camera["frames_per_turn"])
    rng = np.random.default_rng(seed)
    if camera["path"] == "orbit":
        yaw0 = rng.uniform(0.0, 2.0 * math.pi)
        k = np.arange(n)
        eul = np.stack([np.full(n, camera["pitch"]), yaw0 + 2.0 * math.pi * k / n, np.zeros(n)], axis=1)
        pos = np.tile(np.asarray(camera["position"], np.float64), (n, 1))
        return pos.astype(np.float32), eul.astype(np.float32), 0
    if camera["path"] == "fly":
        cam = np.asarray(camera["start"], np.float32).copy()
        e = np.asarray(camera["euler"], np.float32).copy()
        pos, eul = [], []
        for i in range(n):
            pos.append(cam.copy())
            eul.append(e.copy())
            cam = (cam + _look(e) * np.float32(camera["speed"])).astype(np.float32)
            if i % 3 == 0:
                e[1] = np.float32(e[1] - np.float32(TURN))
        return np.array(pos, np.float32), np.array(eul, np.float32), int(rng.integers(n))
    raise ValueError(f"unknown camera path {camera['path']!r}")


def query_pool(query: dict, seed: int, device) -> tuple:
    """``(offsets f32[K, N, 3], dirs f32[K, N, 3])``: ``K = batches`` batches
    of ``N = rays`` rays, origins' offsets uniform in a cube of side ``box``
    around the camera, directions uniform on the sphere, made on the
    device from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    k, n, box = int(query["batches"]), int(query["rays"]), float(query["box"])
    offsets = (torch.rand((k, n, 3), generator=g, device=device) - 0.5) * box
    dirs = torch.randn((k, n, 3), generator=g, device=device)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    return offsets, dirs


def sample_frames(seed: int, count: int, first: int, last: int) -> list:
    """``count`` distinct step indices in ``[first, last)``, drawn from the
    seed (fewer where the range is shorter)."""
    rng = np.random.default_rng([seed, 1])
    span = max(last - first, 0)
    return sorted(int(v) + first for v in rng.choice(span, size=min(count, span), replace=False))


def frame_pixels(seed: int, frame_number: int, count: int, width: int, height: int, checkerboard: bool):
    """``(px, py)``: ``count`` distinct pixels that frame ``frame_number``
    writes, drawn from the seed: with the checkerboard, row ``y = 2 y' +
    (x even) + (frame even)`` of pre-remap row ``y'`` (the overflow row
    dropped)."""
    g = torch.Generator()
    g.manual_seed((seed * 1000003 + frame_number) % (1 << 63))
    rows = height // 2 if checkerboard else height
    pick = torch.randperm(rows * width, generator=g)
    px, pyr = pick % width, pick // width
    py = pyr * 2 + (px % 2 == 0).long() + int(frame_number % 2 == 0) if checkerboard else pyr
    keep = py < height
    return px[keep][:count], py[keep][:count]


def query_samples(seed: int, call: int, count: int, rays: int) -> torch.Tensor:
    """``count`` distinct ray indices of call ``call``, drawn from the seed."""
    g = torch.Generator()
    g.manual_seed((seed * 1000033 + call) % (1 << 63))
    return torch.randperm(rays, generator=g)[:count]
