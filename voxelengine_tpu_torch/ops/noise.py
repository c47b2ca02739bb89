"""Procedural noise: the worldgen subset of :mod:`voxelengine_tpu.ops.noise`.

Same bit-level semantics as the reference's ``cuda_noise`` header:

* integer hashing is uint32 with wraparound (``cuda_noise.cuh:44-54``),
  carried here in int64 tensors masked to 32 bits, because torch has no
  uint32 arithmetic;
* float -> uint/int conversions follow CUDA's saturating ``cvt.rzi``;
* float math is fp32 in the reference's exact operation order.  Every op is
  its own eager kernel, so nothing is contracted into an FMA.

Reference quirks kept on purpose: ``repeater_perlin`` ignores its ``seed``
(octave seeds are ``(i + 38) * 27389482``, wrapping as int32), and ``grad``
aliases hash entries 0xC-0xF onto 0, 9, 1 and 11 (``cuda_noise.cuh:173-195``).
"""

from __future__ import annotations

import numpy as np
import torch

from voxelengine_tpu_torch.core.exact import fdiv

_M32 = 0xFFFFFFFF
_U32_MAX_F = float(np.float32(4294967295.0))  # rounds to 2^32, as in the reference


def _wrap_i32(v: int) -> int:
    """Python int -> wrapped int32 value (C overflow semantics)."""
    v &= _M32
    return v - 0x100000000 if v >= 0x80000000 else v


def f32_to_u32_sat(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 like CUDA ``(unsigned int)f``: truncate toward zero,
    negatives and NaN to 0, overflow to UINT_MAX.  Returns int64 holding
    the uint32 value."""
    x = torch.where(torch.isnan(x), 0.0, x)
    hi = x >= 4294967296.0  # 2^32: exact in f32
    x = torch.clamp(x, 0.0, 4294967040.0)  # largest f32 below 2^32
    return torch.where(hi, _M32, x.to(torch.int64))


def f32_to_i32_sat(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 like CUDA ``(int)f``: truncate toward zero, NaN to 0,
    positive overflow to INT_MAX exactly (``cvt.rzi.s32.f32``)."""
    x = torch.where(torch.isnan(x), 0.0, x)
    hi = x >= 2147483648.0  # 2^31: exact in f32
    x = torch.clamp(x, -2147483648.0, 2147483520.0)  # largest f32 below 2^31
    return torch.where(hi, 2147483647, x.to(torch.int64)).to(torch.int32)


def hash_u32(seed: torch.Tensor) -> torch.Tensor:
    """6-round avalanche integer hash (``cuda_noise.cuh:44-54``).  ``seed``
    is any integer tensor (int32 bit patterns included); returns int64
    holding the uint32 result."""
    s = seed.to(torch.int64) & _M32
    s = ((s + 0x7ED55D16) + (s << 12)) & _M32
    s = ((s ^ 0xC761C23C) ^ (s >> 19)) & _M32
    s = ((s + 0x165667B1) + (s << 5)) & _M32
    s = ((s + 0xD3A2646C) ^ (s << 9)) & _M32
    s = ((s + 0xFD7046C5) + (s << 3)) & _M32
    s = ((s ^ 0xB55A4F09) ^ (s >> 16)) & _M32
    return s


def random_float(seed: torch.Tensor) -> torch.Tensor:
    """Random float in [0, 1] (``cuda_noise.cuh:65-71``)."""
    return fdiv(hash_u32(seed).to(torch.float32), _U32_MAX_F)


def random_int_grid(x, y, z, seed=0.0) -> torch.Tensor:
    """Random uint32 (as int64) for a grid coordinate
    (``cuda_noise.cuh:115-118``); arguments are float32, like the
    reference signature."""
    s = x * 1723.0 + y * 93241.0 + z * 149812.0 + 3824.0 + seed
    return hash_u32(f32_to_u32_sat(s))


def lerp(a, b, ratio):
    """``a*(1-r) + b*r`` in the reference's exact form (``cuda_noise.cuh:161-164``)."""
    return a * (1.0 - ratio) + b * ratio


def fade(t):
    """Perlin's 6t^5-15t^4+10t^3 fade (``cuda_noise.cuh:197-200``)."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def grad(h: torch.Tensor, x, y, z) -> torch.Tensor:
    """Gradient dot product keyed by ``h & 0xF`` (``cuda_noise.cuh:173-195``),
    with the reference's duplicate entries C:(x+y) D:(-y+z) E:(y-x) F:(-y-z)."""
    i = h.to(torch.int64) & 0xF
    i = torch.where(i == 12, 0, torch.where(i == 13, 9, torch.where(i == 14, 1, torch.where(i == 15, 11, i))))
    b0 = (i & 1).to(torch.float32)
    b1 = ((i >> 1) & 1).to(torch.float32)
    g = i >> 2  # 0: (x,y)  1: (x,z)  2: (y,z)
    first = torch.where(g == 2, y, x)
    second = torch.where(g == 0, y, z)
    return (1.0 - 2.0 * b0) * first + (1.0 - 2.0 * b1) * second


def perlin_noise(pos: torch.Tensor, scale: float, seed: int) -> torch.Tensor:
    """Trilinear-faded 8-corner gradient noise (``cuda_noise.cuh:565-613``).

    ``pos`` is ``[..., 3]`` float32; ``seed`` an int32 value, converted to
    float32 like the reference's ``float fseed = (float)seed``."""
    fseed = float(np.float32(np.int32(_wrap_i32(int(seed)))))
    p = pos * float(np.float32(scale))
    ix = torch.floor(p[..., 0])
    iy = torch.floor(p[..., 1])
    iz = torch.floor(p[..., 2])
    x = p[..., 0] - ix
    y = p[..., 1] - iy
    z = p[..., 2] - iz
    u, v, w = fade(x), fade(y), fade(z)

    def corner(ox, oy, oz):
        h = random_int_grid(ix + ox, iy + oy, iz + oz, fseed)
        return grad(h, x - ox, y - oy, z - oz)

    x00 = lerp(corner(0.0, 0.0, 0.0), corner(1.0, 0.0, 0.0), u)
    x10 = lerp(corner(0.0, 1.0, 0.0), corner(1.0, 1.0, 0.0), u)
    x01 = lerp(corner(0.0, 0.0, 1.0), corner(1.0, 0.0, 1.0), u)
    x11 = lerp(corner(0.0, 1.0, 1.0), corner(1.0, 1.0, 1.0), u)
    y0 = lerp(x00, x10, v)
    y1 = lerp(x01, x11, v)
    return lerp(y0, y1, w)


def repeater_perlin(pos: torch.Tensor, scale, seed, n: int, lacunarity, decay) -> torch.Tensor:
    """Perlin fBm (``cuda_noise.cuh:615-629``).  The ``seed`` argument is
    unused: octave ``i`` uses seed ``(i + 38) * 27389482`` (reference quirk).
    The octave scale and amplitude are carried as float32 scalars."""
    acc = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    sc = np.float32(scale)
    amp = np.float32(1.0)
    for i in range(n):
        octave_seed = _wrap_i32((i + 38) * 27389482)
        acc = acc + perlin_noise(pos * float(sc), 1.0, octave_seed) * float(amp)
        sc = np.float32(sc * np.float32(lacunarity))
        amp = np.float32(amp * np.float32(decay))
    return acc
