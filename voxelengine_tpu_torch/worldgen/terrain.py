"""Procedural terrain: counterpart of :mod:`voxelengine_tpu.worldgen.terrain`.

The reference's rule exactly (``VoxelWorldBuilder.cu:17-34``):
``t = repeaterPerlin(pos * 0.005, 1.0, seed, octaves, 2.0, 0.5) * 1000``,
clamped at 0, and a voxel is solid iff ``y <= t``.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.ops.noise import repeater_perlin

DEFAULT_SEED = 0x71889283  # VoxelWorldBuilder.cu:6
DEFAULT_SCALE = 0.005  # VoxelWorldBuilder.cu:10
DEFAULT_OCTAVES = 32  # VoxelWorldBuilder.cu:6


def terrain_density(x, y, z, seed: int = DEFAULT_SEED, octaves: int = DEFAULT_OCTAVES):
    """Height threshold ``t`` at integer voxel coords (tensors broadcast
    together): ``max(repeaterPerlin((x,y,z)*0.005, ...) * 1000, 0)``."""
    xs, ys, zs = torch.broadcast_tensors(
        x.to(torch.float32) * DEFAULT_SCALE,
        y.to(torch.float32) * DEFAULT_SCALE,
        z.to(torch.float32) * DEFAULT_SCALE,
    )
    pos = torch.stack([xs, ys, zs], dim=-1)
    t = repeater_perlin(pos, 1.0, seed, octaves, 2.0, 0.5) * 1000.0
    return torch.clamp_min(t, 0.0)


def solid_at(x, y, z, seed: int = DEFAULT_SEED, octaves: int = DEFAULT_OCTAVES):
    """Occupancy at voxel coords: solid iff ``y <= t``
    (``VoxelWorldBuilder.cu:27-34``)."""
    t = terrain_density(x, y, z, seed, octaves)
    return ~(y.to(torch.float32) > t)
