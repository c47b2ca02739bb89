"""The terrain rule of the upstream world builder, in plain torch.

A voxel ``(x, y, z)`` is solid iff ``y <= max(repeaterPerlin((x, y, z) *
0.005, 1.0, seed, octaves, 2.0, 0.5) * 1000, 0)`` (VoxelEngine's
``VoxelWorldBuilder.cu:17-34`` over ``cuda_noise.cuh:44-71,161-200,
565-629``).  Float math is float32 in the upstream's operation order and
every op its own kernel, so nothing contracts into an FMA; integer hashing
is uint32 carried in int64.  The upstream's ``repeaterPerlin`` ignores its
``seed`` (octave ``i`` hashes with ``(i + 38) * 27389482``), so the world
is the same for every seed.

Written for the benchmark from the upstream's rule; the port's plain
``voxelengine_tpu_torch/worldgen/terrain.py`` over ``ops/noise.py:112-258``
computes the same, and nothing here imports it.
"""

from __future__ import annotations

import numpy as np
import torch

SCALE = 0.005  # VoxelWorldBuilder.cu:10
_M32 = 0xFFFFFFFF
_U32_MAX_F = float(np.float32(4294967295.0))  # rounds to 2^32, as upstream


def _wrap_i32(v: int) -> int:
    v &= _M32
    return v - 0x100000000 if v >= 0x80000000 else v


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """IEEE ``a / b``: CUDA turns ``tensor / number`` into a multiplication
    by the reciprocal, so divide by a tensor."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def hash_u32(seed: torch.Tensor) -> torch.Tensor:
    """The 6-round integer hash (``cuda_noise.cuh:44-54``) of the low 32
    bits of ``seed``; int64 holding the uint32 result."""
    s = seed.to(torch.int64) & _M32
    s = ((s + 0x7ED55D16) + (s << 12)) & _M32
    s = ((s ^ 0xC761C23C) ^ (s >> 19)) & _M32
    s = ((s + 0x165667B1) + (s << 5)) & _M32
    s = ((s + 0xD3A2646C) ^ (s << 9)) & _M32
    s = ((s + 0xFD7046C5) + (s << 3)) & _M32
    s = ((s ^ 0xB55A4F09) ^ (s >> 16)) & _M32
    return s


def random_float(seed: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1] (``cuda_noise.cuh:65-71``)."""
    return _div(hash_u32(seed).to(torch.float32), _U32_MAX_F)


def _f32_to_u32_sat(x: torch.Tensor) -> torch.Tensor:
    """CUDA's ``(unsigned int)f``: truncate, negatives and NaN to 0,
    overflow to UINT_MAX; int64 holding the value."""
    x = torch.where(torch.isnan(x), 0.0, x)
    hi = x >= 4294967296.0
    x = torch.clamp(x, 0.0, 4294967040.0)
    return torch.where(hi, _M32, x.to(torch.int64))


def _grid_hash(x, y, z, fseed: float) -> torch.Tensor:
    """``randomIntGrid`` (``cuda_noise.cuh:115-118``) of float32 corners."""
    s = x * 1723.0 + y * 93241.0 + z * 149812.0 + 3824.0 + fseed
    return hash_u32(_f32_to_u32_sat(s))


def _grad(h: torch.Tensor, x, y, z) -> torch.Tensor:
    """``grad`` (``cuda_noise.cuh:173-195``) with the upstream's aliased
    entries 0xC-0xF onto 0, 9, 1 and 11."""
    i = h & 0xF
    i = torch.where(i == 12, 0, torch.where(i == 13, 9, torch.where(i == 14, 1, torch.where(i == 15, 11, i))))
    b0 = (i & 1).to(torch.float32)
    b1 = ((i >> 1) & 1).to(torch.float32)
    g = i >> 2
    first = torch.where(g == 2, y, x)
    second = torch.where(g == 0, y, z)
    return (1.0 - 2.0 * b0) * first + (1.0 - 2.0 * b1) * second


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lerp(a, b, r):
    return a * (1.0 - r) + b * r


def perlin(pos: torch.Tensor, seed: int) -> torch.Tensor:
    """``perlinNoise`` (``cuda_noise.cuh:565-613``) at scale 1 of float32
    ``pos [..., 3]``."""
    fseed = float(np.float32(np.int32(_wrap_i32(seed))))
    ix, iy, iz = torch.floor(pos[..., 0]), torch.floor(pos[..., 1]), torch.floor(pos[..., 2])
    x, y, z = pos[..., 0] - ix, pos[..., 1] - iy, pos[..., 2] - iz
    u, v, w = _fade(x), _fade(y), _fade(z)

    def corner(ox, oy, oz):
        return _grad(_grid_hash(ix + ox, iy + oy, iz + oz, fseed), x - ox, y - oy, z - oz)

    x00 = _lerp(corner(0.0, 0.0, 0.0), corner(1.0, 0.0, 0.0), u)
    x10 = _lerp(corner(0.0, 1.0, 0.0), corner(1.0, 1.0, 0.0), u)
    x01 = _lerp(corner(0.0, 0.0, 1.0), corner(1.0, 0.0, 1.0), u)
    x11 = _lerp(corner(0.0, 1.0, 1.0), corner(1.0, 1.0, 1.0), u)
    return _lerp(_lerp(x00, x10, v), _lerp(x01, x11, v), w)


def repeater_perlin(pos: torch.Tensor, octaves: int) -> torch.Tensor:
    """``repeaterPerlin(pos, 1.0, seed, octaves, 2.0, 0.5)``
    (``cuda_noise.cuh:615-629``); scale and amplitude carried as float32."""
    acc = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    sc, amp = np.float32(1.0), np.float32(1.0)
    for i in range(octaves):
        acc = acc + perlin(pos * float(sc), (i + 38) * 27389482) * float(amp)
        sc = np.float32(sc * np.float32(2.0))
        amp = np.float32(amp * np.float32(0.5))
    return acc


def solid(cells: torch.Tensor, octaves: int) -> torch.Tensor:
    """Occupancy of the int64 voxel coordinates ``cells [..., 3]``."""
    c = cells.to(torch.float32) * SCALE
    t = torch.clamp_min(repeater_perlin(c, octaves) * 1000.0, 0.0)
    return ~(cells[..., 1].to(torch.float32) > t)


def solid_blocks(cells: torch.Tensor, octaves: int, block: int = 1 << 21) -> torch.Tensor:
    """:func:`solid` of a flat ``[n, 3]`` batch, ``block`` cells at a time
    so that the noise's temporaries stay small."""
    out = torch.empty(cells.shape[0], dtype=torch.bool, device=cells.device)
    for i in range(0, cells.shape[0], block):
        out[i:i + block] = solid(cells[i:i + block], octaves)
    return out
