"""Memory-layout / swizzle functions for voxel sample indices.

Counterpart of ``voxelengine_tpu/core/layout.py`` (the reference's
``GetSampleIndex``, ``VolumeRaytracer.cuh:25-171``).  Three layouts:

* ``TILED_LINEAR`` — 8^3 tiles, linear within tile and across tiles
  (the reference's active mode, ``VolumeRaytracer.cuh:111-131``).
* ``TILED_MORTON`` — 8^3 tiles, Morton order within a tile
  (``VolumeRaytracer.cuh:41-106``).
* ``LINEAR`` — plain x-fastest linear (``VolumeRaytracer.cuh:135``).

The functions use only ``+ - * // % & | << >>``, so they take Python ints,
numpy arrays or integer torch tensors alike.  Dimensions must be multiples
of 8 for the tiled modes, exactly like the reference.
"""

from __future__ import annotations

import enum

TILE = 8
TILE3 = TILE * TILE * TILE  # 512


class Layout(enum.Enum):
    LINEAR = 0
    TILED_LINEAR = 1
    TILED_MORTON = 2


def _part1by2(x):
    """Spread the low 3 bits of x so they occupy every third bit
    (``Part1By2``, ``VolumeRaytracer.cuh:25-32``)."""
    x = x & 0x7
    x = (x | (x << 8)) & 0x00000F00F
    x = (x | (x << 4)) & 0x000C30C3
    x = (x | (x << 2)) & 0x00249249
    return x


def _compact1by2(x):
    """Inverse of :func:`_part1by2` (``VolumeRaytracer.cuh:89-96``)."""
    x = x & 0x00249249
    x = (x ^ (x >> 2)) & 0x000C30C3
    x = (x ^ (x >> 4)) & 0x00000F00F
    x = (x ^ (x >> 8)) & 0x0000000FF
    return x


def _morton3d_8(x, y, z):
    """Morton index within an 8^3 tile (``VolumeRaytracer.cuh:34-39``)."""
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def sample_index(x, y, z, width, height, layout: Layout = Layout.TILED_LINEAR):
    """Voxel (x, y, z) -> linear bit index within a packed grid
    (``GetSampleIndex``, ``VolumeRaytracer.cuh:107-137``).  ``width`` and
    ``height`` are the grid's X and Y dimensions."""
    if layout is Layout.LINEAR:
        return x + y * width + z * width * height

    tx, ty, tz = x // TILE, y // TILE, z // TILE
    lx, ly, lz = x % TILE, y % TILE, z % TILE
    tiles_x = width // TILE
    tiles_y = height // TILE
    tile_index = tx + ty * tiles_x + tz * tiles_x * tiles_y

    if layout is Layout.TILED_LINEAR:
        fine = lx + ly * TILE + lz * TILE * TILE
    else:  # TILED_MORTON
        fine = _morton3d_8(lx, ly, lz)
    return tile_index * TILE3 + fine


def position_from_sample_index(index, width, height, layout: Layout = Layout.TILED_LINEAR):
    """Linear bit index -> voxel (x, y, z)
    (``GetPositionFromSampleIndex``, ``VolumeRaytracer.cuh:138-171``)."""
    if layout is Layout.LINEAR:
        x = index % width
        y = (index // width) % height
        z = index // (width * height)
        return x, y, z

    tiles_x = width // TILE
    tiles_y = height // TILE
    tile_index = index // TILE3
    fine = index % TILE3
    tx = tile_index % tiles_x
    ty = (tile_index // tiles_x) % tiles_y
    tz = tile_index // (tiles_x * tiles_y)

    if layout is Layout.TILED_LINEAR:
        lx = fine % TILE
        ly = (fine // TILE) % TILE
        lz = fine // (TILE * TILE)
    else:  # TILED_MORTON
        lx = _compact1by2(fine)
        ly = _compact1by2(fine >> 1)
        lz = _compact1by2(fine >> 2)

    return tx * TILE + lx, ty * TILE + ly, tz * TILE + lz
