// Per-ray two-level brickmap DDA, over the line table (K1) or over dense-slot
// tables (K4).
//
// One ray, one plain loop, one DDA event per iteration: the scalar form of
// voxelengine_tpu_torch/ops/trace.py (and of the JAX state machine it
// mirrors, voxelengine_tpu/ops/trace.py::_run_loop).  Coarse steps read the
// packed meta word of the current chunk; a descend starts a fine DDA at the
// chunk's tight-AABB entry; fine steps read brick words; an ascend resumes
// the coarse walk with one normal step.  Tie-breaks, edge pads and the
// degenerate start hit follow VolumeRaytracer.cu:176-525.
//
// Every function here is __host__ __device__: nvcc builds it into the
// Hopper kernels (bigtrace.cu, bmtrace.cu) and a C++ compiler builds it
// into a host library for the CPU tests (dda_host.cpp).  Both builds must
// keep every float operation separately rounded: nvcc --fmad=false, g++
// -ffp-contract=off, no fast-math, IEEE division.
//
// trace_ray is one DDA body for both table forms; a fetch policy maps a
// clamped chunk to a cell handle and reads its meta word, its brick slot
// and a brick word:
//   LineTableFetch (K1 and K5, the line-table contract of make_line_table):
//     region r = (cx>>3) + RX*((cy>>3) + RY*(cz>>3)),
//     local    = (cx&7) + ((cy&7)<<3) + ((cz&7)<<6),
//     meta word  at region_lines[r*1024 + local],
//     brick slot at region_lines[r*1024 + 512 + local] (-1 -> 0),
//     brick word at brick_lines[slot*wpb + (bit>>5)];
//     and the macro occupancy levels (below);
//   DenseSlotFetch (K4, pallas_trace2.py:78-90,130-132,201):
//     chunk index ci = sample_index(cx, cy, cz) in the coarse layout,
//     meta word at meta[ci], brick slot ci, brick word at bricks[ci*wpb + (bit>>5)].
//
// Two compile-time flags, so that the production build keeps its
// instruction stream:
//   MACRO: the L1/L2/L3 macro skip levels of
//     voxelengine_tpu/ops/pallas_bigtrace.py::_trace_inner (use_macro=True,
//     :830-879, :1055-1139, :1194-1200).  A coarse step in an empty region
//     (L1 bit of macro[r>>5]) leaves the whole empty span at once: the
//     region (8 chunks), or the 4x1x4-region super-region (32 chunks in x/z)
//     when its L2 bit is clear too, or the 16x1x16-region block (128 chunks)
//     when its L3 bit is clear too; y spans stay one region.  The span is
//     clamped to the grid, the coarse cell is re-seeded across its exit face
//     and tMax recomputed from it, and the budget is charged the L1 chunk
//     distance.  The expressions are _trace_inner's, so results are its bits
//     (they can differ by an ulp from the chunk-by-chunk walk, whose tMax
//     accumulates instead of being re-seeded).
//   DIAG: _trace_inner's diag counters (:1256-1286), per ray, in its order
//     (DiagIndex), plus the ray's loop iterations.  One iteration here is
//     one DDA event; the TPU kernel needs a separate "pend" iteration to
//     fetch a chunk's slot word and retires some fine-step pairs in one
//     iteration ("step2").  The counters are the TPU's all the same: a
//     descend counts pend and desc, and a fine step that _trace_inner
//     would pair with the next (:1016-1051) counts fstep and step2, its
//     partner nothing.  stall and adjstall come from the TPU's VMEM line
//     cache (a ray waiting for a DMA) and are 0 here: every load is served.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define VX_HD __host__ __device__ __forceinline__
#else
#define VX_HD inline
#endif

namespace vx {

// Layout enum values of voxelengine_tpu_torch.core.layout.Layout.
enum BrickLayout { LAYOUT_LINEAR = 0, LAYOUT_TILED_LINEAR = 1, LAYOUT_TILED_MORTON = 2 };

struct TraceParams {
  int gx, gy, gz;    // chunk grid
  int factor;        // voxels per chunk edge
  int max_steps;     // step budget
  int brick_layout;  // BrickLayout
  int iter_limit;    // iteration cap; a ray still active there reports max_steps
};

struct TraceResult {
  int flags;  // hit | hit_imm << 1
  float px, py, pz;
  float nx, ny, nz;
  int steps;
};

// Diag counters, in _trace_inner's order (pallas_bigtrace.py:1670-1671),
// then the iteration count.
enum DiagIndex {
  D_STALL, D_MSKIP, D_CADV, D_PEND, D_DESC, D_FSTEP, D_STEP2, D_ASC, D_XRUN, D_ADJSTALL,
  D_ITERS, D_COUNT
};

// Macro word budgets (make_line_table): L2 words at macro2[0:32], L3 at [32:36].
constexpr int MACRO2_WORDS = 32, MACRO3_WORDS = 4;

VX_HD int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
VX_HD int mini(int a, int b) { return a < b ? a : b; }
VX_HD int absi(int a) { return a < 0 ? -a : a; }

VX_HD int part1by2(int x) {
  x &= 0x7;
  x = (x | (x << 8)) & 0x0000F00F;
  x = (x | (x << 4)) & 0x000C30C3;
  x = (x | (x << 2)) & 0x00249249;
  return x;
}

// Bit index of an in-range (x, y, z) in a w x h x . grid of the given
// layout (core/layout.py::sample_index; tiled layouts need w, h % 8 == 0).
VX_HD int sample_index(int x, int y, int z, int w, int h, int layout) {
  if (layout == LAYOUT_LINEAR) return x + y * w + z * (w * h);
  const int tx = w >> 3, ty = h >> 3;
  const int tile = (x >> 3) + (y >> 3) * tx + (z >> 3) * (tx * ty);
  if (layout == LAYOUT_TILED_MORTON)
    return tile * 512 + (part1by2(x & 7) | (part1by2(y & 7) << 1) | (part1by2(z & 7) << 2));
  return tile * 512 + (x & 7) + ((y & 7) << 3) + ((z & 7) << 6);
}

// K1's and K5's tables: region lines, brick lines and the macro levels.
struct LineTableFetch {
  const int* region_lines;
  const int* brick_lines;
  const int* macro;   // L1: bit r&31 of word r>>5 is region r's occupancy
  const int* macro2;  // L2 then L3 words (MACRO2_WORDS + MACRO3_WORDS)
  int rx, ry, rz;     // region grid, ceil(g / 8)
  int wpb;            // words per brick
  VX_HD long long cell(int cx, int cy, int cz) const {
    return (long long)((cx >> 3) + rx * ((cy >> 3) + ry * (cz >> 3))) * 1024 +
           ((cx & 7) + ((cy & 7) << 3) + ((cz & 7) << 6));
  }
  VX_HD int meta(long long c) const { return region_lines[c]; }
  VX_HD int slot(long long c) const {
    const int s = region_lines[c + 512];
    return s > 0 ? s : 0;
  }
  VX_HD int word(int slot, int w) const { return brick_lines[(long long)slot * wpb + w]; }
  // L1 occupancy of region (rgx, rgy, rgz)
  VX_HD bool region_occ(int rgx, int rgy, int rgz) const {
    const int r = rgx + rx * (rgy + ry * rgz);
    return (macro[r >> 5] >> (r & 31)) & 1;
  }
  // Occupancy of the (1 << sh) x 1 x (1 << sh)-region group holding region
  // (rgx, rgy, rgz), from the `budget` words at macro2[base]: L2 is
  // (sh 2, base 0, MACRO2_WORDS), L3 (sh 4, base MACRO2_WORDS, MACRO3_WORDS).
  // Words past the world's own count read as all occupied, as _trace_inner's
  // select chain (-1 init, :855-872) reads them.
  VX_HD bool group_occ(int rgx, int rgy, int rgz, int sh, int base, int budget) const {
    const int gxn = (rx + (1 << sh) - 1) >> sh;
    const int g = (rgx >> sh) + gxn * (rgy + ry * (rgz >> sh));
    const int ng = gxn * ry * ((rz + (1 << sh) - 1) >> sh);
    const int nw = mini(budget, (ng + 31) >> 5);
    const int w = (g >> 5) < nw ? macro2[base + (g >> 5)] : -1;
    return (w >> (g & 31)) & 1;
  }
};

// K4's tables: meta and bricks of a dense-slot brickmap, by chunk index.
struct DenseSlotFetch {
  const int* meta_words;
  const int* bricks;
  int gx, gy;         // chunk grid (x, y)
  int coarse_layout;  // BrickLayout of the chunk index
  int wpb;            // words per brick
  VX_HD long long cell(int cx, int cy, int cz) const {
    return sample_index(cx, cy, cz, gx, gy, coarse_layout);
  }
  VX_HD int meta(long long c) const { return meta_words[c]; }
  VX_HD int slot(long long c) const { return (int)c; }
  VX_HD int word(int slot, int w) const { return bricks[(long long)slot * wpb + w]; }
};

// Advance axis with the reference's tie-break: x if strictly smallest,
// else y if ty <= tx && ty < tz, else z (VolumeRaytracer.cu:293-313).
VX_HD int axis_pick(float tx, float ty, float tz) {
  if (tx < ty && tx < tz) return 0;
  if (ty <= tx && ty < tz) return 1;
  return 2;
}

VX_HD float fmin2(float a, float b) { return b < a ? b : a; }
VX_HD float fmax2(float a, float b) { return b > a ? b : a; }

// tMax initialization (VolumeRaytracer.cu:203-205).
VX_HD float init_tmax(int cell, int step, float start, float d) {
  return d != 0.0f ? ((float)(cell + (step > 0 ? 1 : 0)) - start) / d : INFINITY;
}

// One coarse Amanatides-Woo step; returns the crossing time.
VX_HD float coarse_advance(int& cx, int& cy, int& cz, float& tx, float& ty, float& tz,
                           int sx, int sy, int sz, float dtx, float dty, float dtz) {
  const int a = axis_pick(tx, ty, tz);
  if (a == 0) { const float t = tx; cx += sx; tx = tx + dtx; return t; }
  if (a == 1) { const float t = ty; cy += sy; ty = ty + dty; return t; }
  const float t = tz; cz += sz; tz = tz + dtz; return t;
}


// _trace_inner's macro skip (:1064-1139, :1194-1200) from the clamped cell
// (clx, cly, clz), whose region is empty: the span is the region, or its
// empty L2 super-region, or its empty L3 block; the coarse cell moves to
// the first cell across the span's exit face (on the other axes: floor of
// the exit point, clamped into the span), tMax is re-seeded there and
// `tc` is the exit time.  Returns the L1 chunk distance moved.
VX_HD int macro_skip(const TraceParams& P, const LineTableFetch& F, int clx, int cly, int clz,
                     int& ccx, int& ccy, int& ccz, float& ctx, float& cty, float& ctz, float& tc,
                     float sx, float sy, float sz, float dx, float dy, float dz,
                     int stx, int sty, int stz) {
  const int rgx = clx >> 3, rgy = cly >> 3, rgz = clz >> 3;
  const bool skip2 = !F.group_occ(rgx, rgy, rgz, 2, 0, MACRO2_WORDS);
  const bool skip3 = skip2 && !F.group_occ(rgx, rgy, rgz, 4, MACRO2_WORDS, MACRO3_WORDS);
  // span corner and far faces (8, 32 or 128 chunks in x/z, 8 in y), from
  // the clamped cell and clamped to the grid
  const int sh = skip3 ? 7 : (skip2 ? 5 : 3);
  const int lox = (clx >> sh) << sh, loy = rgy << 3, loz = (clz >> sh) << sh;
  const int hix = mini(lox + (1 << sh), P.gx), hiy = mini(loy + 8, P.gy),
            hiz = mini(loz + (1 << sh), P.gz);
  const float rtx = dx != 0.0f ? ((float)(stx > 0 ? hix : lox) - sx) / dx : INFINITY;
  const float rty = dy != 0.0f ? ((float)(sty > 0 ? hiy : loy) - sy) / dy : INFINITY;
  const float rtz = dz != 0.0f ? ((float)(stz > 0 ? hiz : loz) - sz) / dz : INFINITY;
  const int a = axis_pick(rtx, rty, rtz);
  tc = a == 0 ? rtx : (a == 1 ? rty : rtz);
  const float mx = sx + tc * dx, my = sy + tc * dy, mz = sz + tc * dz;
  const int skx = a == 0 ? (stx > 0 ? hix : lox - 1)
                         : clampi((int)mx - (mx < 0.0f ? 1 : 0), lox, hix - 1);
  const int sky = a == 1 ? (sty > 0 ? hiy : loy - 1)
                         : clampi((int)my - (my < 0.0f ? 1 : 0), loy, hiy - 1);
  const int skz = a == 2 ? (stz > 0 ? hiz : loz - 1)
                         : clampi((int)mz - (mz < 0.0f ? 1 : 0), loz, hiz - 1);
  const int l1 = absi(skx - ccx) + absi(sky - ccy) + absi(skz - ccz);
  ccx = skx; ccy = sky; ccz = skz;
  ctx = init_tmax(ccx, stx, sx, dx);
  cty = init_tmax(ccy, sty, sy, dy);
  ctz = init_tmax(ccz, stz, sz, dz);
  return l1;
}

// Would _trace_inner retire the step after this fine step in the same
// iteration (double_step, :1016-1051)?  (fcx, fcy, fcz), (ftx, fty, ftz)
// are the state after this step, `bit` and `word` the bit and brick word
// of the cell it left: the next cell must be in range, covered by the same
// word, empty, and its exit must stay inside the brick.
VX_HD bool fine_pair(int f, int layout, int fcx, int fcy, int fcz, int fpadx, int fpady,
                     int fpadz, float ftx, float fty, float ftz, int bit, int word, float fsx,
                     float fsy, float fsz, float dx, float dy, float dz, int stx, int sty,
                     int stz) {
  if (fcx < 0 || fcx >= f + fpadx || fcy < 0 || fcy >= f + fpady || fcz < 0 || fcz >= f + fpadz)
    return false;
  const int bit1 = sample_index(clampi(fcx, 0, f - 1), clampi(fcy, 0, f - 1),
                                clampi(fcz, 0, f - 1), f, f, layout);
  if ((bit1 >> 5) != (bit >> 5) || ((word >> (bit1 & 31)) & 1)) return false;
  const int a = axis_pick(ftx, fty, ftz);
  const float tc = a == 0 ? ftx : (a == 1 ? fty : ftz);
  const float ff = (float)f;
  const float ix = a == 0 ? (float)(fcx + (stx > 0 ? 1 : 0)) : fsx + tc * dx;
  const float iy = a == 1 ? (float)(fcy + (sty > 0 ? 1 : 0)) : fsy + tc * dy;
  const float iz = a == 2 ? (float)(fcz + (stz > 0 ? 1 : 0)) : fsz + tc * dz;
  return !(ix < 0.0f || ix > ff || iy < 0.0f || iy > ff || iz < 0.0f || iz > ff);
}

// Trace one ray.  (sx, sy, sz) is the world-clipped start in chunk units,
// (dx, dy, dz) the normalized direction, (padx, pady, padz) the coarse
// edge pad; all three come from the wrapper's ray setup.  MACRO and DIAG
// as in the header; with DIAG, the D_COUNT counters are added to diag[].
template <bool MACRO = false, bool DIAG = false, class Fetch>
VX_HD TraceResult trace_ray(const TraceParams& P, const Fetch& F,
                            float sx, float sy, float sz, float dx, float dy, float dz,
                            int active, int padx, int pady, int padz, int* diag = nullptr) {
  TraceResult r = {0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
  if (!active) return r;
  const int f = P.factor;
  const float ff = (float)f;
  const float flt_eps = 1.1920929e-07f;  // FLT_EPSILON, ops/aabb.py
  const int stx = dx > 0.0f ? 1 : -1, sty = dy > 0.0f ? 1 : -1, stz = dz > 0.0f ? 1 : -1;
  const float tdx = dx != 0.0f ? fabsf(1.0f / dx) : INFINITY;
  const float tdy = dy != 0.0f ? fabsf(1.0f / dy) : INFINITY;
  const float tdz = dz != 0.0f ? fabsf(1.0f / dz) : INFINITY;
  // ray_aabb's reciprocals: a zero component becomes FLT_EPSILON
  const float ivx = 1.0f / (dx == 0.0f ? flt_eps : dx);
  const float ivy = 1.0f / (dy == 0.0f ? flt_eps : dy);
  const float ivz = 1.0f / (dz == 0.0f ? flt_eps : dz);

  int ccx = (int)sx, ccy = (int)sy, ccz = (int)sz;  // trunc toward zero
  float ctx = init_tmax(ccx, stx, sx, dx);
  float cty = init_tmax(ccy, sty, sy, dy);
  float ctz = init_tmax(ccz, stz, sz, dz);
  float centry = 0.0f;

  bool in_fine = false, hit = false, imm = false, hit_imm = false;
  bool paired = false;  // DIAG: this fine step is the partner of a counted pair
  int steps = 0;
  int fcx = 0, fcy = 0, fcz = 0, fpadx = 0, fpady = 0, fpadz = 0, fsteps = 0, slot = 0;
  float ftx = 0.0f, fty = 0.0f, ftz = 0.0f;
  float fsx = 0.0f, fsy = 0.0f, fsz = 0.0f;
  float fpx = 0.0f, fpy = 0.0f, fpz = 0.0f;
  float cnx = 0.0f, cny = 0.0f, cnz = 0.0f;
  float fnx = 0.0f, fny = 0.0f, fnz = 0.0f;

  for (int it = 0; active && it < P.iter_limit; ++it) {
    if constexpr (DIAG) ++diag[D_ITERS];
    bool cadv = false;  // coarse advance this event (coarse miss of the box, or ascend)
    if (!in_fine) {
      const bool in_range = ccx >= 0 && ccx < P.gx + padx && ccy >= 0 && ccy < P.gy + pady &&
                            ccz >= 0 && ccz < P.gz + padz;
      if (!in_range) { active = 0; break; }  // left the world: miss
      const int clx = clampi(ccx, 0, P.gx - 1), cly = clampi(ccy, 0, P.gy - 1),
                clz = clampi(ccz, 0, P.gz - 1);
      bool skipped = false;
      if constexpr (MACRO) {
        if (!F.region_occ(clx >> 3, cly >> 3, clz >> 3)) {
          const int l1 = macro_skip(P, F, clx, cly, clz, ccx, ccy, ccz, ctx, cty, ctz, centry,
                                    sx, sy, sz, dx, dy, dz, stx, sty, stz);
          steps = mini(steps + l1, P.max_steps);
          skipped = true;
          if constexpr (DIAG) ++diag[D_MSKIP];
        }
      }
      if (!skipped) {
        const long long c = F.cell(clx, cly, clz);
        const int meta = F.meta(c);
        bool descend = false;
        if ((meta >> 30) & 1) {
          // ray vs the chunk's tight AABB (ops/aabb.py::ray_aabb)
          const float bx0 = (float)clx + (float)(meta & 31) / ff;
          const float by0 = (float)cly + (float)((meta >> 5) & 31) / ff;
          const float bz0 = (float)clz + (float)((meta >> 10) & 31) / ff;
          const float bx1 = (float)clx + ((float)((meta >> 15) & 31) + 1.0f) / ff;
          const float by1 = (float)cly + ((float)((meta >> 20) & 31) + 1.0f) / ff;
          const float bz1 = (float)clz + ((float)((meta >> 25) & 31) + 1.0f) / ff;
          const float lx = (bx0 - sx) * ivx, hx = (bx1 - sx) * ivx;
          const float ly = (by0 - sy) * ivy, hy = (by1 - sy) * ivy;
          const float lz = (bz0 - sz) * ivz, hz = (bz1 - sz) * ivz;
          const float t1x = fmin2(lx, hx), t1y = fmin2(ly, hy), t1z = fmin2(lz, hz);
          const float t2x = fmax2(lx, hx), t2y = fmax2(ly, hy), t2z = fmax2(lz, hz);
          const float btmin = fmax2(fmax2(t1x, t1y), t1z);
          const float btmax = fmin2(fmin2(t2x, t2y), t2z);
          if (btmax >= fmax2(btmin, 0.0f)) {
            // descend: fine DDA from the box entry, or from the current
            // position when already inside the box
            descend = true;
            imm = steps == 0 && btmin <= 0.0f;
            float ex, ey, ez;
            if (btmin > 0.0f) {
              ex = sx + btmin * dx; ey = sy + btmin * dy; ez = sz + btmin * dz;
            } else {
              ex = sx + dx * centry; ey = sy + dy * centry; ez = sz + dz * centry;
            }
            fsx = (ex - (float)clx) * ff;
            fsy = (ey - (float)cly) * ff;
            fsz = (ez - (float)clz) * ff;
            fcx = (int)fsx; fcy = (int)fsy; fcz = (int)fsz;
            ftx = init_tmax(fcx, stx, fsx, dx);
            fty = init_tmax(fcy, sty, fsy, dy);
            ftz = init_tmax(fcz, stz, fsz, dz);
            const bool on_edge = fcx == f || fcy == f || fcz == f;
            fpadx = on_edge && dx < 0.0f; fpady = on_edge && dy < 0.0f; fpadz = on_edge && dz < 0.0f;
            fpx = fsx; fpy = fsy; fpz = fsz;
            fsteps = 0;
            const bool is_x = btmin == t1x;
            const bool is_y = !is_x && btmin == t1y;
            cnx = is_x ? (ivx < 0.0f ? -1.0f : 1.0f) : 0.0f;
            cny = is_y ? (ivy < 0.0f ? -1.0f : 1.0f) : 0.0f;
            cnz = (is_x || is_y) ? 0.0f : (ivz < 0.0f ? -1.0f : 1.0f);
            slot = F.slot(c);
            in_fine = true;
          }
        }
        cadv = !descend;
        if constexpr (DIAG) {
          if (descend) { ++diag[D_PEND]; ++diag[D_DESC]; } else { ++diag[D_CADV]; }
        }
      }
    } else {
      const bool in_range_f = fcx >= 0 && fcx < f + fpadx && fcy >= 0 && fcy < f + fpady &&
                              fcz >= 0 && fcz < f + fpadz;
      bool ascend = !in_range_f;
      if (in_range_f) {
        const int bit = sample_index(clampi(fcx, 0, f - 1), clampi(fcy, 0, f - 1),
                                     clampi(fcz, 0, f - 1), f, f, P.brick_layout);
        const int word = F.word(slot, bit >> 5);
        if ((word >> (bit & 31)) & 1) {
          // hit: position = fine entry + chunk offset (VolumeRaytracer.cu:427-429),
          // normal of the last crossing (VolumeRaytracer.cu:495-503)
          hit = true;
          r.px = fpx + (float)(ccx * f);
          r.py = fpy + (float)(ccy * f);
          r.pz = fpz + (float)(ccz * f);
          if (fsteps == 0) { r.nx = cnx; r.ny = cny; r.nz = cnz; }
          else { r.nx = fnx; r.ny = fny; r.nz = fnz; }
          hit_imm = hit_imm || (fsteps == 0 && imm);
          active = 0;
          break;
        }
        const int a = axis_pick(ftx, fty, ftz);
        const float tc = a == 0 ? ftx : (a == 1 ? fty : ftz);
        const float ix = a == 0 ? (float)(fcx + (stx > 0 ? 1 : 0)) : fsx + tc * dx;
        const float iy = a == 1 ? (float)(fcy + (sty > 0 ? 1 : 0)) : fsy + tc * dy;
        const float iz = a == 2 ? (float)(fcz + (stz > 0 ? 1 : 0)) : fsz + tc * dz;
        if (ix < 0.0f || ix > ff || iy < 0.0f || iy > ff || iz < 0.0f || iz > ff) {
          ascend = true;
        } else {
          if (a == 0) { fcx += stx; ftx = ftx + tdx; }
          else if (a == 1) { fcy += sty; fty = fty + tdy; }
          else { fcz += stz; ftz = ftz + tdz; }
          fpx = ix; fpy = iy; fpz = iz;
          fnx = a == 0 ? (float)stx : 0.0f;
          fny = a == 1 ? (float)sty : 0.0f;
          fnz = a == 2 ? (float)stz : 0.0f;
          ++fsteps;
          ++steps;
          if constexpr (DIAG) {
            if (paired) {
              paired = false;  // counted with its first step
            } else {
              ++diag[D_FSTEP];
              if (a == 0 && word == 0) ++diag[D_XRUN];
              paired = fine_pair(f, P.brick_layout, fcx, fcy, fcz, fpadx, fpady, fpadz, ftx, fty,
                                 ftz, bit, word, fsx, fsy, fsz, dx, dy, dz, stx, sty, stz);
              if (paired) ++diag[D_STEP2];
            }
          }
        }
      }
      if (ascend) in_fine = false;
      cadv = ascend;
      if constexpr (DIAG) {
        if (ascend) ++diag[D_ASC];
      }
    }
    if (cadv) {
      centry = coarse_advance(ccx, ccy, ccz, ctx, cty, ctz, stx, sty, stz, tdx, tdy, tdz);
      ++steps;
    }
    if (steps >= P.max_steps) active = 0;
  }
  r.flags = (hit ? 1 : 0) | (hit_imm ? 2 : 0);
  // a ray cut by the iteration cap reports the full budget, never a fake
  // low-steps miss (pallas_bigtrace.py:1507-1512)
  r.steps = active ? P.max_steps : steps;
  return r;
}

}  // namespace vx
