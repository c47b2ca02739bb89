"""Procedural noise library: counterpart of ``voxelengine_tpu/ops/noise.py``.

Same names, signatures and bit-level semantics as the reference's
``cuda_noise`` header:

* integer hashing is uint32 with wraparound (``cuda_noise.cuh:44-54``),
  carried here in int64 tensors masked to 32 bits, because torch has no
  uint32 arithmetic;
* float -> uint/int conversions follow CUDA's saturating ``cvt.rzi``;
* float math is fp32 in the reference's exact operation order.  Every op is
  its own eager kernel, so nothing is contracted into an FMA.

Divisions go through :func:`~voxelengine_tpu_torch.core.exact.fdiv` (on
CUDA ``tensor / python_number`` multiplies by a reciprocal), and no op that
could contract into an FMA (``torch.lerp``, ``addcmul``) is used.  Seeds are
Python ints (or 0-d integer tensors) and wrap as int32; scales, amplitudes
and other scalars are carried as float32 values.  On the card these are
eager torch, as the JAX package computes them in XLA.

Reference quirks kept on purpose (``cuda_noise.cuh``; the JAX module's
``:18-26``):

* ``repeater_perlin`` ignores its ``seed``: octave seeds are
  ``(i + 38) * 27389482``, wrapping as int32;
* ``grad`` aliases hash entries 0xC-0xF onto 0, 9, 1 and 11;
* ``clamp`` ignores its bounds and clamps to [0, 1];
* ``repeater_perlin_abs`` uses one seed for every octave;
* ``linear_value`` ignores ``scale``; ``turbulence`` leaves ``pos`` as it
  is for an input basis without seeds (its switch's default) and returns 0
  for a DISCRETE or SPOTS output basis.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from voxelengine_tpu_torch.core.exact import fdiv

EPSILON = 1e-9  # cuda_noise.cuh:39
_M32 = 0xFFFFFFFF
_U32_MAX_F = float(np.float32(4294967295.0))  # rounds to 2^32, as in the reference


def _wrap_i32(v: int) -> int:
    """Python int -> wrapped int32 value (C overflow semantics)."""
    v &= _M32
    return v - 0x100000000 if v >= 0x80000000 else v


class Basis(enum.Enum):
    """``basisFunction`` (``cuda_noise.cuh:10-21``)."""

    CHECKER = 0
    DISCRETE = 1
    LINEARVALUE = 2
    FADEDVALUE = 3
    CUBICVALUE = 4
    SIMPLEX = 5
    PERLIN = 6
    WORLEY = 7
    SPOTS = 8


class Shape(enum.Enum):
    """``profileShape`` (``cuda_noise.cuh:23-28``)."""

    STEP = 0
    LINEAR = 1
    QUADRATIC = 2


def _i32(seed) -> int:
    """A seed (Python int or 0-d integer tensor) as a wrapped int32 value."""
    return _wrap_i32(int(seed))


def _f32(v):
    """A tensor as float32, a number as its float32 value."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return float(np.float32(v))


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """An integer tensor wrapped to int32 (C overflow semantics)."""
    v = v.to(torch.int64) & _M32
    return torch.where(v >= 0x80000000, v - 0x100000000, v).to(torch.int32)


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


def saturate(x):
    """CUDA ``__saturatef``: clamp to [0, 1]."""
    return torch.clamp(x, 0.0, 1.0)


def random_int_range(vmin: int, vmax: int, seed: torch.Tensor) -> torch.Tensor:
    """Random int in [min, max] (``cuda_noise.cuh:57-63``).  The reference
    converts the uint hash to a signed int before C's ``%``, so negative
    results are possible; kept (truncated remainder)."""
    base = hash_u32(seed)
    base = torch.where(base >= 0x80000000, base - 0x100000000, base)
    return (torch.fmod(base, 1 + vmax - vmin) + vmin).to(torch.int32)


def _grid_seed(x, y, z, seed):
    return _f32(x) * 1723.0 + _f32(y) * 93241.0 + _f32(z) * 149812.0 + 3824.0 + _f32(seed)


def random_grid(x, y, z, seed=0.0) -> torch.Tensor:
    """Random float in [-1, 1] for an integer grid coordinate
    (``cuda_noise.cuh:109-112``)."""
    return map_to_signed(random_float(f32_to_u32_sat(_grid_seed(x, y, z, seed))))


def random_int_grid(x, y, z, seed=0.0) -> torch.Tensor:
    """Random uint32 (as int64) for a grid coordinate
    (``cuda_noise.cuh:115-118``); arguments are float32, like the
    reference signature."""
    return hash_u32(f32_to_u32_sat(_grid_seed(x, y, z, seed)))


def vector_noise(x, y, z) -> torch.Tensor:
    """Random 3-vector from grid position (``cuda_noise.cuh:121-127``)."""
    x, y, z = _f32(x), _f32(y), _f32(z)
    vx = random_float(f32_to_u32_sat(x * 8231.0 + y * 34612.0 + z * 11836.0 + 19283.0)) * 2.0 - 1.0
    vy = random_float(f32_to_u32_sat(x * 1171.0 + y * 9234.0 + z * 992903.0 + 1466.0)) * 2.0 - 1.0
    return torch.stack([vx, vy, torch.zeros_like(vx)], dim=-1)


def map_to_signed(x):
    """[0,1] -> [-1,1] (``cuda_noise.cuh:83-86``)."""
    return x * 2.0 - 1.0


def map_to_unsigned(x):
    """[-1,1] -> [0,1] (``cuda_noise.cuh:89-92``)."""
    return x * 0.5 + 0.5


def clamp(val, vmin=None, vmax=None):
    """Reference ``clamp``: ignores min/max and clamps to [0, 1]
    (``cuda_noise.cuh:72-80``, kept quirk)."""
    return torch.clamp(val, 0.0, 1.0)


def lerp(a, b, ratio):
    """``a*(1-r) + b*r`` in the reference's exact form (``cuda_noise.cuh:161-164``)."""
    return a * (1.0 - ratio) + b * ratio


def cubic(p0, p1, p2, p3, x):
    """4-point 1D cubic interpolation (``cuda_noise.cuh:167-170``)."""
    return p1 + 0.5 * x * (
        p2 - p0 + x * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3 + x * (3.0 * (p1 - p2) + p3 - p0))
    )


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


# gradMap constant table for simplex noise (cuda_noise.cu:4-7): declared
# [16][3] with only 12 initializers; rows 12-15 are zero.
_GRAD_MAP = (
    (1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0),
    (1, 0, 1), (-1, 0, 1), (1, 0, -1), (-1, 0, -1),
    (0, 1, 1), (0, -1, 1), (0, 1, -1), (0, -1, -1),
    (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0),
)
_F3 = float(np.float32(1.0 / 3.0))
_G3 = float(np.float32(1.0 / 6.0))


def simplex_noise(pos: torch.Tensor, scale, seed) -> torch.Tensor:
    """3D simplex noise (``cuda_noise.cuh:225-317``)."""
    seed = _i32(seed)
    sc = _f32(scale)
    xin, yin, zin = pos[..., 0] * sc, pos[..., 1] * sc, pos[..., 2] * sc
    s = (xin + yin + zin) * _F3
    i = torch.floor(xin + s).to(torch.int64)
    j = torch.floor(yin + s).to(torch.int64)
    k = torch.floor(zin + s).to(torch.int64)
    t = _to_i32(i + j + k).to(torch.float32) * _G3
    x0 = xin - (i.to(torch.float32) - t)
    y0 = yin - (j.to(torch.float32) - t)
    z0 = zin - (k.to(torch.float32) - t)

    # simplex corner selection (cuda_noise.cuh:253-266)
    xy, yz, xz = x0 >= y0, y0 >= z0, x0 >= z0
    c1 = xy & yz
    c2 = xy & ~yz & xz
    c3 = xy & ~yz & ~xz
    c4 = ~xy & ~yz
    c5 = ~xy & yz & ~xz
    c6 = ~xy & yz & xz
    i1, j1, k1 = (c1 | c2).to(torch.int64), (c5 | c6).to(torch.int64), (c3 | c4).to(torch.int64)
    i2 = (c1 | c2 | c3 | c6).to(torch.int64)
    j2 = (c1 | c4 | c5 | c6).to(torch.int64)
    k2 = (c2 | c3 | c4 | c5).to(torch.int64)

    g2, g3 = float(np.float32(2.0) * np.float32(_G3)), float(np.float32(3.0) * np.float32(_G3))
    x1, y1, z1 = x0 - i1.to(torch.float32) + _G3, y0 - j1.to(torch.float32) + _G3, z0 - k1.to(torch.float32) + _G3
    x2, y2, z2 = x0 - i2.to(torch.float32) + g2, y0 - j2.to(torch.float32) + g2, z0 - k2.to(torch.float32) + g2
    x3, y3, z3 = x0 - 1.0 + g3, y0 - 1.0 + g3, z0 - 1.0 + g3

    def perm12(p):  # int32 wrapping sums, hashed as uint32
        return torch.remainder(hash_u32(p), 12)

    def hsum(a, b, c):
        return seed + a * 607495 + b * 359609 + c * 654846

    gmap = torch.tensor(_GRAD_MAP, dtype=torch.float32, device=pos.device)

    def contrib(p, x, y, z):
        t = 0.6 - x * x - y * y - z * z
        g = gmap[perm12(p)]
        val = g[..., 0] * x + g[..., 1] * y + g[..., 2] * z
        t2 = t * t
        return torch.where(t < 0.0, 0.0, t2 * t2 * val)

    n0 = contrib(hsum(i, j, k), x0, y0, z0)
    n1 = contrib(hsum(i + i1, j + j1, k + k1), x1, y1, z1)
    n2 = contrib(hsum(i + i2, j + j2, k + k2), x2, y2, z2)
    n3 = contrib(hsum(i + 1, j + 1, k + 1), x3, y3, z3)
    return 32.0 * (n0 + n1 + n2 + n3)


def _cells(pos: torch.Tensor, scale):
    """Truncated integer cells of ``pos * scale`` (CUDA ``(int)f``)."""
    sc = _f32(scale)
    return tuple(f32_to_i32_sat(pos[..., a] * sc) for a in range(3))


def checker(pos: torch.Tensor, scale, seed) -> torch.Tensor:
    """Checker pattern (``cuda_noise.cuh:319-330``)."""
    ix, iy, iz = _cells(pos, scale)
    par = torch.fmod(_to_i32(ix.to(torch.int64) + iy + iz), 2)
    return torch.where(par == 0, 1.0, -1.0).to(torch.float32)


def discrete_noise(pos: torch.Tensor, scale, seed) -> torch.Tensor:
    """Nearest-neighbor value noise (``cuda_noise.cuh:467-474``)."""
    ix, iy, iz = _cells(pos, scale)
    return random_grid(ix, iy, iz, _i32(seed))


def _value_corners(ix, iy, iz, fseed):
    def off(c, d):
        return c + d if d else c

    return tuple(
        random_grid(off(ix, dx), off(iy, dy), off(iz, dz), fseed)
        for dz, dy, dx in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
    )


def _trilinear(corners, u, v, w):
    a000, a100, a010, a110, a001, a101, a011, a111 = corners
    x00 = lerp(a000, a100, u)
    x10 = lerp(a010, a110, u)
    x01 = lerp(a001, a101, u)
    x11 = lerp(a011, a111, u)
    return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w)


def linear_value(pos: torch.Tensor, scale, seed) -> torch.Tensor:
    """Trilinear value noise (``cuda_noise.cuh:477-507``).  The reference
    ignores ``scale`` here (kept quirk)."""
    fseed = _f32(_i32(seed))
    ix, iy, iz = (c.to(torch.float32) for c in _cells(pos, 1.0))
    u, v, w = pos[..., 0] - ix, pos[..., 1] - iy, pos[..., 2] - iz
    return _trilinear(_value_corners(ix, iy, iz, fseed), u, v, w)


def faded_value(pos: torch.Tensor, scale, seed) -> torch.Tensor:
    """Faded value noise (``cuda_noise.cuh:510-541``)."""
    fseed = _f32(_i32(seed))
    ix, iy, iz = (c.to(torch.float32) for c in _cells(pos, scale))
    u, v, w = fade(pos[..., 0] - ix), fade(pos[..., 1] - iy), fade(pos[..., 2] - iz)
    return fdiv(_trilinear(_value_corners(ix, iy, iz, fseed), u, v, w), 2.0) * 1.0


def tricubic(x, y, z, u, v, w) -> torch.Tensor:
    """Tricubic interpolation of grid randoms (``cuda_noise.cuh:434-464``);
    ``x``, ``y``, ``z`` are int32 cells."""
    def row(yy, zz):
        return cubic(random_grid(x - 1, yy, zz), random_grid(x, yy, zz),
                     random_grid(x + 1, yy, zz), random_grid(x + 2, yy, zz), u)

    ys = []
    for dz in (-1, 0, 1, 2):
        xs = [row(y + dy, z + dz) for dy in (-1, 0, 1, 2)]
        ys.append(cubic(xs[0], xs[1], xs[2], xs[3], v))
    return cubic(ys[0], ys[1], ys[2], ys[3], w)


def cubic_value(pos: torch.Tensor, scale, seed) -> torch.Tensor:
    """Tricubic value noise (``cuda_noise.cuh:544-563``)."""
    pos = pos * _f32(scale)
    ix, iy, iz = _cells(pos, 1.0)
    u = pos[..., 0] - ix.to(torch.float32)
    v = pos[..., 1] - iy.to(torch.float32)
    w = pos[..., 2] - iz.to(torch.float32)
    return tricubic(ix, iy, iz, u, v, w)


def _feature_scan(pos, scale, seed, num_mul_z: float, num_add, max_num: int, min_num: int, jitter, visit):
    """The 27-cell feature-point scan shared by worley and spots
    (``cuda_noise.cuh:340-385,398-428``): ``visit(i, num, du, dv, dw)`` for
    each neighbour cell and candidate point ``i < max_num``.  The cell's
    point count hashes ``fz * num_mul_z``, plus ``num_add`` where given."""
    fseed = _f32(_i32(seed))
    ix, iy, iz = _cells(pos, scale)
    u = pos[..., 0] - ix.to(torch.float32)
    v = pos[..., 1] - iy.to(torch.float32)
    w = pos[..., 2] - iz.to(torch.float32)
    jitter = _f32(jitter)
    half = float(np.float32(jitter) / np.float32(2.0))
    for x in (-1, 0, 1):
        for y in (-1, 0, 1):
            for z in (-1, 0, 1):
                fx = _to_i32(ix.to(torch.int64) + x).to(torch.float32)
                fy = _to_i32(iy.to(torch.int64) + y).to(torch.float32)
                fz = _to_i32(iz.to(torch.int64) + z).to(torch.float32)
                s = fseed + fx * 823746.0 + fy * 12306.0 + fz * num_mul_z
                num = random_int_range(min_num, max_num, f32_to_i32_sat(s if num_add is None else s + num_add))
                for i in range(max_num):
                    ru = random_float(f32_to_u32_sat(fseed + fx * 23784.0 + fy * 9183.0 + fz * 23874.0 * i + 27432.0))
                    rv = random_float(f32_to_u32_sat(fseed + fx * 12743.0 + fy * 45191.0 + fz * 144421.0 * i + 76671.0))
                    rw = random_float(f32_to_u32_sat(fseed + fx * 82734.0 + fy * 900213.0 + fz * 443241.0 * i + 199823.0))
                    du = u - x - (ru * jitter - half)
                    dv = v - y - (rv * jitter - half)
                    dw = w - z - (rw * jitter - half)
                    visit(i, num, du, dv, dw)


def worley_noise(pos: torch.Tensor, scale, seed, size, min_num: int, max_num: int, jitter) -> torch.Tensor:
    """Worley cellular noise (``cuda_noise.cuh:390-431``)."""
    if size < EPSILON:
        return torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    best = [torch.full(pos.shape[:-1], 1000000.0, dtype=torch.float32, device=pos.device)]

    def visit(i, num, du, dv, dw):
        d2 = du * du + dv * dv + dw * dw
        best[0] = torch.where((i < num) & (d2 < best[0]), d2, best[0])

    _feature_scan(pos, scale, seed, 67262.0, None, max_num, min_num, jitter, visit)
    return saturate(best[0]) * 2.0 - 1.0


def spots(pos: torch.Tensor, scale, seed, size, min_num: int, max_num: int, jitter, shape: Shape) -> torch.Tensor:
    """Random spots (``cuda_noise.cuh:332-388``)."""
    if size < EPSILON:
        return torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    size_f = _f32(size)
    val = [torch.full(pos.shape[:-1], -1.0, dtype=torch.float32, device=pos.device)]

    def visit(i, num, du, dv, dw):
        d2 = du * du + dv * dv + dw * dw
        if shape is Shape.STEP:
            cand = torch.where(d2 < size_f, 1.0, -1.0)
        elif shape is Shape.LINEAR:
            cand = 1.0 - fdiv(clamp(torch.abs(du) + torch.abs(dv) + torch.abs(dw)), size_f)
        else:  # QUADRATIC
            cand = 1.0 - fdiv(clamp(d2), size_f)
        val[0] = torch.where(i < num, torch.maximum(val[0], cand), val[0])

    _feature_scan(pos, scale, seed, 823452.0, 3234874.0, max_num, min_num, jitter, visit)
    return val[0]


# ---------------------------------------------------------------------------
# fBm repeaters (cuda_noise.cuh:615-797); octave scale and amplitude are
# carried as float32 scalars, as the JAX loops carry them
# ---------------------------------------------------------------------------


def _octaves(scale, n: int, lacunarity, decay):
    """``(i, scale, amp)`` of each of ``n`` octaves, as float32 scalars."""
    sc, amp = np.float32(scale), np.float32(1.0)
    for i in range(n):
        yield i, float(sc), float(amp)
        sc = np.float32(sc * np.float32(lacunarity))
        amp = np.float32(amp * np.float32(decay))


def _zeros(pos: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    return torch.full(pos.shape[:-1], fill, dtype=torch.float32, device=pos.device)


def repeater_perlin_bounded(pos: torch.Tensor, scale, seed, n: int, lacunarity, decay, threshold) -> torch.Tensor:
    """Bounded Perlin fBm (``cuda_noise.cuh:631-651``)."""
    seed = _i32(seed)
    acc, dead = _zeros(pos, 1.0), torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    thr = _f32(threshold)
    for i, sc, amp in _octaves(scale, n, lacunarity, decay):
        p = perlin_noise(pos * sc, 1.0, seed ^ _wrap_i32((i + 38) * 27389482))
        nxt = acc * (1.0 - saturate(0.5 + 0.5 * p) * amp)
        acc = torch.where(dead, acc, nxt)
        dead = dead | (acc < thr)
    return torch.where(dead, 0.0, acc)


def repeater_perlin_abs(pos: torch.Tensor, scale, seed, n: int, lacunarity, decay) -> torch.Tensor:
    """Absolute-value Perlin fBm (``cuda_noise.cuh:653-669``): the same seed
    for every octave (reference quirk)."""
    acc = _zeros(pos)
    for _, sc, amp in _octaves(scale, n, lacunarity, decay):
        acc = acc + torch.abs(perlin_noise(pos * sc, 1.0, seed)) * amp
    return map_to_signed(acc)


def _repeater_simplex(pos, scale, seed, n, lacunarity, decay, mul: int, add: int, fold):
    seed = _i32(seed)
    acc = _zeros(pos)
    for i, sc, amp in _octaves(scale, n, lacunarity, decay):
        acc = acc + fold(simplex_noise(pos, sc, seed)) * amp * 0.35
        seed = seed ^ _wrap_i32((i + add) * mul)
    return acc


def repeater_simplex(pos: torch.Tensor, scale, seed, n: int, lacunarity, decay) -> torch.Tensor:
    """Simplex fBm (``cuda_noise.cuh:671-687``)."""
    return _repeater_simplex(pos, scale, seed, n, lacunarity, decay, 200394, 672381, lambda v: v)


def repeater_simplex_abs(pos: torch.Tensor, scale, seed, n: int, lacunarity, decay) -> torch.Tensor:
    """Absolute simplex fBm (``cuda_noise.cuh:689-705``)."""
    return map_to_signed(_repeater_simplex(pos, scale, seed, n, lacunarity, decay, 928374, 198273, torch.abs))


def repeater_simplex_bounded(pos: torch.Tensor, scale, seed, n: int, lacunarity, decay, threshold) -> torch.Tensor:
    """Bounded simplex fBm (``cuda_noise.cuh:707-727``)."""
    acc, dead = _zeros(pos, 1.0), torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    offs = torch.tensor([32240.7922, 835622.882, 824.371968], dtype=torch.float32, device=pos.device)
    thr = _f32(threshold)
    for _, sc, amp in _octaves(scale, n, lacunarity, decay):
        val = saturate(simplex_noise(pos * sc + offs, 1.0, seed) * 0.3 + 0.5) * amp
        acc = torch.where(dead, acc, acc - val)
        dead = dead | (acc < thr)
    return torch.where(dead, 0.0, acc)


_BASIS_OFFSETS = {
    Basis.CHECKER: (53872.1923, 58334.4081, 9358.34667),
    Basis.DISCRETE: (7852.53114, 319739.059, 451336.504),
    Basis.LINEARVALUE: (940.748139, 10196.4500, 25650.9789),
    Basis.FADEDVALUE: (7683.26428, 2417.78195, 93889.4897),
    Basis.CUBICVALUE: (6546.80178, 14459.4682, 11616.5811),
    Basis.PERLIN: (1764.66931, 2593.55017, 4813.24412),
    Basis.SIMPLEX: (7442.93020, 8341.06698, 66848.7870),
    Basis.WORLEY: (7619.01285, 57209.0681, 1167.91397),
    Basis.SPOTS: (33836.4116, 2242.51045, 6720.07486),
}


def _basis_eval(basis: Basis, pos: torch.Tensor, scale, seed) -> torch.Tensor:
    """One basis at its repeater defaults (``cuda_noise.cuh:739-771``)."""
    if basis is Basis.WORLEY:
        return worley_noise(pos, scale, seed, 0.1, 4, 4, 1.0)
    if basis is Basis.SPOTS:
        return spots(pos, scale, seed, 0.1, 0, 4, 1.0, Shape.LINEAR)
    fn = {
        Basis.CHECKER: checker, Basis.DISCRETE: discrete_noise, Basis.LINEARVALUE: linear_value,
        Basis.FADEDVALUE: faded_value, Basis.CUBICVALUE: cubic_value, Basis.PERLIN: perlin_noise,
        Basis.SIMPLEX: simplex_noise,
    }.get(basis)
    if fn is None:
        raise ValueError(basis)
    return fn(pos, scale, seed)


def repeater(pos: torch.Tensor, scale, seed, n: int, lacunarity, decay, basis: Basis) -> torch.Tensor:
    """Generic fBm repeater (``cuda_noise.cuh:729-775``)."""
    acc = _zeros(pos)
    offs = torch.tensor(_BASIS_OFFSETS[basis], dtype=torch.float32, device=pos.device)
    for _, sc, amp in _octaves(scale, n, lacunarity, decay):
        acc = acc + _basis_eval(basis, pos * sc + offs, 1.0, seed) * amp
    return acc


def fractal_simplex(pos: torch.Tensor, scale, seed, du, n: int, lacunarity, decay) -> torch.Tensor:
    """Fractal simplex: stops once the feature size is below one pixel
    (``cuda_noise.cuh:777-797``).  ``scale`` and ``du`` are Python floats
    (the octave cutoff is decided on the host); the octave scale and
    amplitude are carried in double, as the JAX function carries them."""
    seed = _i32(seed)
    acc = _zeros(pos)
    offs = torch.tensor([617.437379, 196410.219, 321280.627], dtype=torch.float32, device=pos.device)
    amp, s, rdu = 1.0, float(scale), 1.0 / du
    for i in range(n):
        acc = acc + simplex_noise(pos * _f32(s) + offs, 1.0, _wrap_i32(seed * (i + 1))) * _f32(amp)
        s *= lacunarity
        amp *= decay
        if s > rdu:
            break
    return acc


_TURB_SEEDS = {
    Basis.CHECKER: (0x34FF8885, 0x2D03CBA3, 0x5A76FB1B),
    Basis.LINEARVALUE: (0x5527FDB8, 0x42AF1A2E, 0x1482EE8C),
    Basis.FADEDVALUE: (0x295590FC, 0x30731854, 0x73D2CA4C),
    Basis.CUBICVALUE: (0x663A1F09, 0x429BF56B, 0x37FA6FE9),
    Basis.PERLIN: (0x74827384, 0x10938478, 0x62723883),
    Basis.SIMPLEX: (0x47829472, 0x58273829, 0x10294647),
    Basis.WORLEY: (0x1D96F515, 0x4DF308F0, 0x2B79442A),
}


def _offset_axes(pos: torch.Tensor, offset, seeds) -> torch.Tensor:
    """``pos`` with x, then y, then z moved by ``offset(pos, seed)``; each
    component sees the previously moved ``pos`` (``cuda_noise.cuh:812-840``)."""
    for a, s in enumerate(seeds):
        moved = pos[..., a] + offset(pos, s)
        pos = torch.stack([moved if k == a else pos[..., k] for k in range(3)], dim=-1)
    return pos


def turbulence(pos: torch.Tensor, scale_in, scale_out, seed, strength, in_basis: Basis,
               out_basis: Basis) -> torch.Tensor:
    """Two-pass turbulence (``cuda_noise.cuh:799-860``)."""
    seed = _i32(seed)
    st = _f32(strength)
    seeds = _TURB_SEEDS.get(in_basis)
    if seeds is not None:  # the reference's in-switch default: no offset

        def offset(p, s):
            if in_basis is Basis.WORLEY:
                return worley_noise(p, scale_in, seed ^ s, 1.0, 4, 4, 1.0) * st
            return _basis_eval(in_basis, p, scale_in, seed ^ s) * st

        pos = _offset_axes(pos, offset, seeds)
    # out pass (cuda_noise.cuh:842-859): SIMPLEX and WORLEY use scaleIn
    # (kept quirk); DISCRETE and SPOTS fall past the switch to 0
    if out_basis is Basis.SIMPLEX:
        return simplex_noise(pos, scale_in, seed)
    if out_basis is Basis.WORLEY:
        return worley_noise(pos, scale_in, seed, 1.0, 4, 4, 1.0)
    if out_basis in (Basis.DISCRETE, Basis.SPOTS):
        return _zeros(pos)
    return _basis_eval(out_basis, pos, scale_out, seed)


def repeater_turbulence(pos: torch.Tensor, scale_in, scale_out, seed, strength, n: int, basis_in: Basis,
                        basis_out: Basis) -> torch.Tensor:
    """Repeater-based turbulence (``cuda_noise.cuh:862-869``)."""
    seed = _i32(seed)
    st = _f32(strength)
    pos = _offset_axes(pos, lambda p, s: repeater(p, scale_in, seed ^ s, n, 2.0, 0.5, basis_in) * st,
                       (0x41728394, 0x72837263, 0x26837363))
    return repeater(pos, scale_out, seed ^ 0x3F821DAB, n, 2.0, 0.5, basis_out)
