"""glibc's float32 ``sinf``, ``cosf`` and ``tanf`` in torch ops.

The JAX reference runs on XLA:CPU, whose jitted ``jnp.sin``, ``jnp.cos``
and ``jnp.tan`` compute exactly what glibc's ``sinf``, ``cosf`` and
``tanf`` compute (glibc 2.36, x86-64).  torch's CPU functions (SLEEF)
differ from them in the last bit at about 5% of the angles, and CUDA's
``sinf`` is another algorithm again; a last bit moves a camera's rays.
This module computes glibc's results with torch ops that each round on
their own, as ``core/exact.py`` does, on any device:

* ``sinf`` / ``cosf`` (``sysdeps/ieee754/flt-32/s_sinf.c``, ``s_cosf.c``,
  ``sincosf.h``, ``sincosf_data.c``): the argument goes to float64; below
  pi/4 a polynomial is taken directly (tiny arguments return early); below
  120 ``reduce_fast`` takes n from x * 2/pi and r = x - n * pi/2; above it
  ``reduce_large`` multiplies the mantissa by a 4/pi bit table in integer
  arithmetic.  n & 3 picks the signs and the sine or cosine polynomial,
  which is evaluated in float64 and rounded once to float32.  x86-64 glibc
  runs the build compiled with FMA on a CPU that has it, where the
  compiler fused every ``a + b * c`` of those steps: :func:`fma` computes
  such a step as one rounding.
* ``tanf`` (``s_tanf.c``, ``k_tanf.c``): fdlibm's float arithmetic after
  the same float64 reduction as ``sinf``, with no fused steps.

The reference's camera needs these only for its three Euler angles and
the field of view; ``csrc/camera.cu`` is the card's kernel for the basis,
and this module is its plain version.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.core.exact import fdiv

F32, F64, I64 = torch.float32, torch.float64, torch.int64

_h = float.fromhex
# sincosf_data.c: __sincosf_table[0] (x86-64 has no TOINT_INTRINSICS, so
# 2/pi comes prescaled by 2^24); table[1] negates the cosine polynomial
SIGN = (1.0, -1.0, -1.0, 1.0)
HPI_INV = _h("0x1.45F306DC9C883p+23")
HPI = _h("0x1.921FB54442D18p0")
COS_POLY = (_h("0x1p0"), _h("-0x1.ffffffd0c621cp-2"), _h("0x1.55553e1068f19p-5"),
            _h("-0x1.6c087e89a359dp-10"), _h("0x1.99343027bf8c3p-16"))
SIN_POLY = (_h("-0x1.555545995a603p-3"), _h("0x1.1107605230bc4p-7"), _h("-0x1.994eb3774cf24p-13"))
PI63 = _h("0x1.921FB54442D18p-62")
# 4/pi in bits (sincosf_data.c: __inv_pio4)
INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
    0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
    0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041,
)
# abstop12 thresholds (the top 12 bits of |x| as float32 bits): pi/4, 2^-12, 120, inf
TOP_PIO4, TOP_TINY, TOP_120, TOP_INF = 0x3F4, 0x398, 0x42F, 0x7F8

# k_tanf.c: T[], pio4, pio4lo (float32)
TAN_T = (
    3.3333334327e-01, 1.3333334029e-01, 5.3968254477e-02, 2.1869488060e-02, 8.8632395491e-03,
    3.5920790397e-03, 1.4562094584e-03, 5.8804126456e-04, 2.4646313977e-04, 7.8179444245e-05,
    7.1407252108e-05, -1.8558637748e-05, 2.5907305826e-05,
)
TAN_PIO4, TAN_PIO4LO = 7.8539812565e-01, 3.7748947079e-08

_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for float64


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def fma(a, b, c):
    """``a * b + c`` in float64 with one rounding (the fused step of an
    FMA build), from plain float64 ops: the product is split exactly
    (Dekker), added to ``c`` exactly, and the two tails are summed rounding
    to odd before the last rounding to nearest (Boldo and Melquiond, 2008),
    which makes the last rounding the correct one.  ``a`` is a float64
    tensor, ``b`` and ``c`` tensors or Python floats.  Exact for the
    magnitudes of these functions (no overflow, no subnormal products)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, ev = _two_sum(tl, e)
    odd = torch.nextafter(v, torch.where(ev > 0, torch.inf, -torch.inf).to(F64))
    return th + torch.where((ev != 0) & ((v.view(I64) & 1) == 0), odd, v)


def _top12(bits):
    return (bits >> 20) & 0x7FF


def _reduce_large(bits):
    """``reduce_large``: (r, n) for |x| >= 120 from the float32 bits (int64),
    its 32x96-bit product carried in 32-bit limbs of int64."""
    m32 = 0xFFFFFFFF
    arr = torch.tensor(INV_PIO4, dtype=I64, device=bits.device)
    k = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    xi = ((bits & 0xFFFFFF) | 0x800000) << shift  # < 2^31
    r0 = (xi * arr[k]) & m32  # uint32 product
    r1 = xi * arr[k + 4]  # < 2^63
    r2 = xi * arr[k + 8]
    # (r2 >> 32) | (r0 << 32), then + r1, mod 2^64: (hi, lo) limbs
    lo = (r2 >> 32) + (r1 & m32)
    hi = (r0 + (r1 >> 32) + (lo >> 32)) & m32
    lo = lo & m32
    n = (((hi + (1 << 29)) & m32) >> 30) & 3  # (res0 + 2^61) >> 62
    hi = (hi - (n << 30)) & m32  # res0 -= n << 62
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)  # (int64) res0
    r = (hi.to(F64) * 4294967296.0 + lo.to(F64)) * PI63
    return r, n


def _reduce(y: torch.Tensor, fused: bool = True):
    """The flat float32 ``y``'s reduced argument as ``sinf`` takes it: ``(r, n,
    q)``, r in float64, n the quadrant that picks the polynomial and q the
    one that picks the signs and the table.  Below pi/4 r = y and n = q =
    0; ``reduce_fast`` gives n = q, its r = x - n * pi/2 one fused step
    (two roundings where not ``fused``, as ``tanf`` takes it);
    ``reduce_large`` works on |y| and folds y's sign into q = n + sign."""
    bits = y.view(torch.int32).to(I64) & 0xFFFFFFFF
    top = _top12(bits)
    x = y.to(F64)
    # reduce_fast: n = ((int32_t) (x * 2/pi * 2^24) + 2^23) >> 24
    n = ((x * HPI_INV).clamp(-2.0**31, 2.0**31 - 1).to(I64) + 0x800000) >> 24
    n = torch.where(top < TOP_PIO4, 0, n)
    r = fma(-n.to(F64), HPI, x) if fused else x - n.to(F64) * HPI
    q = n.clone()
    large = (top >= TOP_120).nonzero().squeeze(1)
    if large.numel():
        rl, nl = _reduce_large(bits[large])
        r[large], n[large], q[large] = rl, nl, nl + (bits[large] >> 31)
    return r, n, q


def _polys(r, q):
    """``sinf_poly``'s two polynomials of r, with the signs of ``sign[q &
    3]`` and table ``q & 2`` (which negates the cosine's coefficients), in
    float64, each ``a + b * c`` fused: ``(sine, cosine)``."""
    x = r * torch.tensor(SIGN, dtype=F64, device=r.device)[q & 3]
    x2 = r * r
    c0, c1, c2, c3, c4 = COS_POLY
    s1, s2, s3 = SIN_POLY
    # s = x + x3*s1; return s + x5*(s2 + x2*s3)
    x3 = x * x2
    x5 = x3 * x2
    sin = fma(x5, fma(x2, s3, s2), fma(x3, s1, x))
    # c = (c0 + x2*c1) + x4*c2; return c + x6*(c3 + x2*c4); the sign is
    # exact, so it is taken out of the sums
    x4 = x2 * x2
    x6 = x4 * x2
    cos = fma(x6, fma(x2, c4, c3), fma(x4, c2, fma(x2, c1, c0)))
    return sin, torch.where((q & 2) != 0, -cos, cos)


def sincosf(y: torch.Tensor):
    """glibc's ``(sinf(y), cosf(y))`` of a float32 tensor, on its device:
    the cosine is the sine's reduction with the other polynomial."""
    shape, y = y.shape, y.to(F32).reshape(-1)
    top = _top12(y.view(torch.int32).to(I64) & 0xFFFFFFFF)
    r, n, q = _reduce(y)
    sin, cos = _polys(r, q)
    odd = (n & 1) != 0
    s = torch.where(odd, cos, sin).to(F32)
    c = torch.where(odd, sin, cos).to(F32)
    s = torch.where(top < TOP_TINY, y, s)
    c = torch.where(top < TOP_TINY, torch.ones_like(y), c)
    nan = torch.full_like(y, float("nan"))
    return torch.where(top >= TOP_INF, nan, s).reshape(shape), torch.where(top >= TOP_INF, nan, c).reshape(shape)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf``, elementwise on a float32 tensor."""
    return sincosf(y)[0]


def cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf``, elementwise on a float32 tensor."""
    return sincosf(y)[1]


def _kernel_tanf(x, y, iy):
    """fdlibm's ``__kernel_tanf(x, y, iy)`` in float32: tan(x + y) for
    ``iy`` 1, -1/tan(x + y) for ``iy`` -1, |x + y| <= ~pi/4."""
    one = torch.ones_like(x)
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    neg = hx < 0
    ivy = torch.full_like(x, 1.0) * iy  # (float) iy, as a tensor
    # tiny: x, or -1/x (1/|x| for x == 0 and iy == -1)
    tiny = torch.where(iy == 1, x, torch.where(ix == 0, fdiv(one, x.abs()), fdiv(-one, x)))
    # |x| >= 0.6744: tan(pi/4 - x) from the identity, x and y folded first
    big = ix >= 0x3F2CA140
    xa, ya = torch.where(neg, -x, x), torch.where(neg, -y, y)
    xb = (TAN_PIO4 - xa) + (TAN_PIO4LO - ya)
    sgn = torch.where(neg, -1.0, 1.0).to(F32)
    near = sgn * ivy * (1.0 - (2.0 * ivy) * xb)  # (1 - 2*iy*x) when |x| < 2^-13
    x = torch.where(big, xb, x)
    y = torch.where(big, torch.zeros_like(y), y)
    T = TAN_T
    z = x * x
    w = z * z
    r = T[1] + w * (T[3] + w * (T[5] + w * (T[7] + w * (T[9] + w * T[11]))))
    v = z * (T[2] + w * (T[4] + w * (T[6] + w * (T[8] + w * (T[10] + w * T[12])))))
    s = z * x
    r = y + z * (s * (r + v) + y)
    r = r + T[0] * s
    w = x + r
    res_big = sgn * (ivy - 2.0 * (x - (fdiv(w * w, w + ivy) - r)))
    res_big = torch.where(xb.abs() < 2.0**-13, near, res_big)
    # iy == -1: -1/(x + r) accurately
    zt = (w.view(torch.int32) & -4096).view(F32)
    vt = r - (zt - x)
    a = fdiv(-one, w)
    t = (a.view(torch.int32) & -4096).view(F32)
    res_m1 = t + a * ((1.0 + t * zt) + t * vt)
    out = torch.where(iy == 1, w, res_m1)
    out = torch.where(big, res_big, out)
    return torch.where(ix < 0x39000000, tiny, out)


def tanf(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``tanf``, elementwise on a float32 tensor: ``rem_pio2f``
    (``reduce_fast`` without a fused step below 120, ``reduce_large``
    above, the result split into float32 head and tail), then
    :func:`_kernel_tanf`."""
    shape, y = y.shape, y.to(F32).reshape(-1)
    ix = y.view(torch.int32) & 0x7FFFFFFF
    r, n, q = _reduce(y, fused=False)
    r = torch.where(q != n, -r, r)  # reduce_large of a negative y: -r, n as it is
    y0 = r.to(F32)
    y1 = (r - y0.to(F64)).to(F32)
    small = ix <= 0x3F490FDA
    x0 = torch.where(small, y, y0)
    x1 = torch.where(small, torch.zeros_like(y), y1)
    iy = torch.where(small, 1, 1 - ((n & 1) << 1)).to(torch.int32)
    out = _kernel_tanf(x0, x1, iy)
    return torch.where(ix >= 0x7F800000, torch.full_like(y, float("nan")), out).reshape(shape)
