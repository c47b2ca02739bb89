"""Procedural terrain: counterpart of :mod:`voxelengine_tpu.worldgen.terrain`.

The reference's rule exactly (``VoxelWorldBuilder.cu:17-34``):
``t = repeaterPerlin(pos * 0.005, 1.0, seed, octaves, 2.0, 0.5) * 1000``,
clamped at 0, and a voxel is solid iff ``y <= t``.  :func:`generate_world`
makes a dense world as a packed :class:`~voxelengine_tpu_torch.core.bitgrid.
BitGrid` on the device, slab by slab.
"""

from __future__ import annotations

from typing import Tuple

import torch

from voxelengine_tpu_torch.config import default_device
from voxelengine_tpu_torch.core.bitgrid import BitGrid, layout_order_bits, pack_bits
from voxelengine_tpu_torch.core.layout import Layout
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


def _gen_slab(z0: int, dims: Tuple[int, int, int], seed: int, octaves: int, device) -> torch.Tensor:
    """One z-slab of dense occupancy, ``bool[slab_z, Y, X]``."""
    xdim, ydim, slab_z = dims
    z = z0 + torch.arange(slab_z, device=device)[:, None, None]
    y = torch.arange(ydim, device=device)[None, :, None]
    x = torch.arange(xdim, device=device)[None, None, :]
    return solid_at(x, y, z, seed, octaves)


def generate_world(
    dims: Tuple[int, int, int],
    seed: int = DEFAULT_SEED,
    octaves: int = DEFAULT_OCTAVES,
    layout: Layout = Layout.TILED_LINEAR,
    slab_z: int = 64,
    device=default_device(),
) -> BitGrid:
    """A dense terrain world as a packed :class:`BitGrid` on ``device``
    (``CreateVoxels``, ``VoxelWorldBuilder.cuh:12-32``).

    Every layout's bit order is z-tile-outermost, so a slab whose height is
    tile-aligned packs to a contiguous, word-aligned run of the words: each
    slab is packed as it is made and the dense world never exists.  Other
    slab shapes fall back to packing the whole dense world, as the JAX
    version does.
    """
    xdim, ydim, zdim = dims
    slab_z = min(slab_z, zdim)
    if zdim % slab_z:
        raise ValueError(f"zdim {zdim} must be divisible by slab_z {slab_z}")
    slabs = (_gen_slab(z0, (xdim, ydim, slab_z), seed, octaves, device) for z0 in range(0, zdim, slab_z))
    tile_ok = slab_z % 8 == 0 if layout is not Layout.LINEAR else True
    if slab_z == zdim or (xdim * ydim * slab_z) % 32 or not tile_ok:
        return BitGrid.from_dense(torch.cat(list(slabs)), layout)
    words = [pack_bits(layout_order_bits(slab, layout)) for slab in slabs]
    return BitGrid(torch.cat(words), (xdim, ydim, zdim), layout)
