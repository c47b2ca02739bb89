// Per-ray two-level brickmap DDA, over the line table (K1, K5) or over
// dense-slot tables (K4).
//
// One ray, one loop, one DDA event per iteration: the scalar form of
// voxelengine_tpu_torch/ops/trace.py (and of the JAX state machine it
// mirrors, voxelengine_tpu/ops/trace.py::_run_loop).  Coarse steps read the
// packed meta word of the current chunk; a descend starts a fine DDA at the
// chunk's tight-AABB entry; fine steps read brick words; an ascend resumes
// the coarse walk with one normal step.  Tie-breaks, edge pads and the
// degenerate start hit follow VolumeRaytracer.cu:176-525.
//
// What bounds the loop on an H100 (PERF.md): the latency of one long
// dependent chain per iteration (address, one 4-byte load that L1 or L2
// serves, bit test, advance) and the instructions on it, not memory.  The
// first loop took ~140-155 SM-cycles per warp-iteration on the demo frame
// while its schedulers issued on at most ~40% of their slots; its coarse
// and fine phases ran on separate paths (89 and ~150 instructions), the box
// test inlined 6 IEEE divisions, and 80 registers held 24 warps an SM.
// This loop:
//   - one convergent iteration: the cell of the current level is in range,
//     its table word is addressed (meta word at the coarse level, brick word
//     at the fine) and read by ONE load, ONE bit is tested, and ONE advance
//     (axis pick, cell step, tMax add) serves both levels, which step by the
//     same tDelta.  The coarse cell and tMax are parked while a fine walk
//     runs in their registers, so only descend and ascend move state;
//     descend, hit, ascend, leave, the fine entry-point test and the macro
//     skip are short branches.  (One cell index shared by both levels was
//     tried and measured 0-6% slower on K1's and K5's rays: each level
//     computes its own.)
//   - divisions: IEEE division stays where the divisor is not a power of
//     two; the box test's 6 divisions by the factor become multiplications
//     by its exact reciprocal when the factor is a power of two (bit-equal);
//     tDelta reuses the ray_aabb reciprocal (the same division).
//   - live state: a fine walk keeps no position or normal, only the axis
//     and crossing time of its last step (the hit rebuilds both with the
//     same expressions); edge pads are bit masks; 64 registers (32 warps an
//     SM) in the kernels' production builds.
//   - tables are read through the read-only path (__ldg) on the card.
// Measured against the first loop (PERF.md): 20% faster on the demo
// frame, 28% on K4's random rays, 8% with macro skips on the sparse world,
// and 7% slower where every step is a coarse step through empty chunks (K1
// with the macro levels off on the sparse world, off any path).  Of the
// gain, the step as selects (no three-way branch) is about 13 points.
//
// Every function here is __host__ __device__: nvcc builds it into the
// Hopper kernels (bigtrace.cu, bmtrace.cu, rrtrace.cu) and a C++ compiler
// builds it into a host library for the CPU tests (dda_host.cpp).  Both
// builds must keep every float operation separately rounded: nvcc
// --fmad=false, g++ -ffp-contract=off, no fast-math, IEEE division.
//
// The loop is resumable: RayState holds its live variables, ray_init starts
// a ray, ray_iterate runs one iteration, ray_result reads the result, and
// trace_ray runs the three back to back (K1, K4).  K5 keeps one RayState a
// lane and refills a lane as soon as its ray ends.  ray_result rebuilds a
// hit's position and normal after the loop, which keeps that code out of
// the loop (K1 and K4 measured 3-9% faster for it; PERF.md).
//
// trace_ray is one DDA body for both table forms; a fetch policy maps a
// clamped chunk to a cell handle, reads a meta word or a brick word with one
// load, and reads a chunk's brick slot:
//   LineTableFetch (K1 and K5, the line-table contract of make_line_table):
//     region r = (cx>>3) + RX*((cy>>3) + RY*(cz>>3)),
//     local    = (cx&7) + ((cy&7)<<3) + ((cz&7)<<6),
//     meta word  at region_lines[r*1024 + local],
//     brick slot at region_lines[r*1024 + 512 + local] (-1 -> 0),
//     brick word at brick_lines[slot*wpb + (bit>>5)];
//     and the macro occupancy levels (below);
//   DenseSlotFetch (K4, pallas_trace2.py:78-90,130-132,201):
//     chunk index ci = sample_index(cx, cy, cz) in the coarse layout,
//     meta word at meta[ci], brick slot ci, brick word at bricks[ci*wpb + (bit>>5)];
//     with SHARED_META the meta words are a copy in the block's shared memory;
//   CompactFetch (K4's compact instantiation; ops/trace.py:275-278, XLA):
//     DenseSlotFetch with the brick slot read from brick_idx[ci] (-1 -> 0).
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

// A table word read through the read-only data path on the card.  Global
// memory only: a shared-memory word is read with a plain load.
VX_HD int ldg(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

VX_HD int part1by2(int x) {
  x &= 0x7;
  x = (x | (x << 8)) & 0x0000F00F;
  x = (x | (x << 4)) & 0x000C30C3;
  x = (x | (x << 2)) & 0x00249249;
  return x;
}

// Bit index of an in-range (x, y, z) in a w x h x . grid of the given
// layout (core/layout.py::sample_index; tiled layouts need w, h % 8 == 0).
// The layout is a template parameter where the caller fixes it at launch
// (K2, K3), a runtime argument where it is a table's (K1, K4, K5).
template <int LAYOUT>
VX_HD int sample_index_t(int x, int y, int z, int w, int h) {
  if constexpr (LAYOUT == LAYOUT_LINEAR) {
    return x + y * w + z * (w * h);
  } else {
    const int tx = w >> 3, ty = h >> 3;
    const int tile = (x >> 3) + (y >> 3) * tx + (z >> 3) * (tx * ty);
    if constexpr (LAYOUT == LAYOUT_TILED_MORTON)
      return tile * 512 + (part1by2(x & 7) | (part1by2(y & 7) << 1) | (part1by2(z & 7) << 2));
    return tile * 512 + (x & 7) + ((y & 7) << 3) + ((z & 7) << 6);
  }
}

VX_HD int sample_index(int x, int y, int z, int w, int h, int layout) {
  if (layout == LAYOUT_LINEAR) return sample_index_t<LAYOUT_LINEAR>(x, y, z, w, h);
  if (layout == LAYOUT_TILED_MORTON) return sample_index_t<LAYOUT_TILED_MORTON>(x, y, z, w, h);
  return sample_index_t<LAYOUT_TILED_LINEAR>(x, y, z, w, h);
}

// K1's and K5's tables: region lines, brick lines and the macro levels.
// The wrapper keeps every region-line and brick-line index below 2^31.
struct LineTableFetch {
  const int* region_lines;
  const int* brick_lines;
  const int* macro;   // L1: bit r&31 of word r>>5 is region r's occupancy
  const int* macro2;  // L2 then L3 words (MACRO2_WORDS + MACRO3_WORDS)
  int rx, ry, rz;     // region grid, ceil(g / 8)
  int wpb;            // words per brick
  VX_HD int cell(int cx, int cy, int cz) const {
    return ((cx >> 3) + rx * ((cy >> 3) + ry * (cz >> 3))) * 1024 +
           ((cx & 7) + ((cy & 7) << 3) + ((cz & 7) << 6));
  }
  // meta word i (coarse level) or brick word i (fine): one load
  VX_HD int load(bool fine, int i) const { return ldg((fine ? brick_lines : region_lines) + i); }
  // index of the first brick word of cell c's chunk
  VX_HD int brick_base(int c) const {
    const int s = ldg(region_lines + c + 512);
    return (s > 0 ? s : 0) * wpb;
  }
  // L1 occupancy of region (rgx, rgy, rgz)
  VX_HD bool region_occ(int rgx, int rgy, int rgz) const {
    const int r = rgx + rx * (rgy + ry * rgz);
    return (ldg(macro + (r >> 5)) >> (r & 31)) & 1;
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
    const int w = (g >> 5) < nw ? ldg(macro2 + base + (g >> 5)) : -1;
    return (w >> (g & 31)) & 1;
  }
};

// K4's tables: meta and bricks of a dense-slot brickmap, by chunk index
// (the wrapper keeps num_chunks * wpb below 2^31).  With SHARED_META,
// meta_words points at the block's shared-memory copy.
template <bool SHARED_META = false>
struct DenseSlotFetch {
  static constexpr bool SHARED = SHARED_META;
  const int* meta_words;
  const int* bricks;
  int gx, gy;         // chunk grid (x, y)
  int coarse_layout;  // BrickLayout of the chunk index
  int wpb;            // words per brick
  VX_HD int cell(int cx, int cy, int cz) const {
    return sample_index(cx, cy, cz, gx, gy, coarse_layout);
  }
  VX_HD int load(bool fine, int i) const {
    if constexpr (SHARED_META) return fine ? ldg(bricks + i) : meta_words[i];
    return ldg((fine ? bricks : meta_words) + i);
  }
  VX_HD int brick_base(int c) const { return c * wpb; }
};

// K4's tables for a compact brickmap: meta by chunk index as above, the
// chunk's brick slot from brick_idx (the wrapper keeps num_bricks * wpb below
// 2^31).  Only a descend reads brick_idx, one dependent load before the
// brick words.  Empty chunks hold -1, which the walk reaches only through an
// occupied meta word; it reads as slot 0 all the same, as the XLA walk
// clamps it, so no read leaves the table.
template <bool SHARED_META = false>
struct CompactFetch : DenseSlotFetch<SHARED_META> {
  const int* brick_idx;
  VX_HD int brick_base(int c) const {
    const int s = ldg(brick_idx + c);
    return (s > 0 ? s : 0) * this->wpb;
  }
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
VX_HD float pick3(int a, float x, float y, float z) { return a == 0 ? x : (a == 1 ? y : z); }
VX_HD int pick3i(int a, int x, int y, int z) { return a == 0 ? x : (a == 1 ? y : z); }

// tMax initialization (VolumeRaytracer.cu:203-205).
VX_HD float init_tmax(int cell, int step, float start, float d) {
  return d != 0.0f ? ((float)(cell + (step > 0 ? 1 : 0)) - start) / d : INFINITY;
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
  tc = pick3(a, rtx, rty, rtz);
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
  const float tc = pick3(a, ftx, fty, ftz);
  const float ff = (float)f;
  const float ix = a == 0 ? (float)(fcx + (stx > 0 ? 1 : 0)) : fsx + tc * dx;
  const float iy = a == 1 ? (float)(fcy + (sty > 0 ? 1 : 0)) : fsy + tc * dy;
  const float iz = a == 2 ? (float)(fcz + (stz > 0 ? 1 : 0)) : fsz + tc * dz;
  return !(ix < 0.0f || ix > ff || iy < 0.0f || iy > ff || iz < 0.0f || iz > ff);
}

// One ray's walk, resumable: the loop's live state (RayState), its start
// (ray_init), one iteration of the loop (ray_iterate) and the result
// (ray_result).  trace_ray runs them back to back; K5 keeps 32 states a warp
// and refills a lane with a new ray as soon as its ray ends.
//
// The normal of a hit (RayState::nrm): the axis of the fine walk's last
// step, or with NRM_BOX, before its first step, the box-entry face's axis,
// and NRM_IMM when the descend started inside the box at the ray's start.
constexpr int NRM_BOX = 4, NRM_IMM = 8;

struct RayState {
  // the ray: start in chunk units, direction, ray_aabb's reciprocals (a
  // zero component becomes FLT_EPSILON), tDelta and the coarse edge pad
  // mask (x 1, y 2, z 4)
  float sx, sy, sz, dx, dy, dz;
  float ivx, ivy, ivz, tdx, tdy, tdz;
  int cpad;
  // the current level's cell and tMax: the coarse walk's, or while `fine`
  // the fine walk's, with the coarse ones parked in (ccx.., ctx..)
  int cx, cy, cz;
  float tx, ty, tz;
  // crossing time of the last advance: the coarse entry time at the coarse
  // level, the last fine step's at the fine (the coarse one is not needed
  // in a fine walk: the ascend advances the coarse walk and sets it anew)
  float tlast;
  int ccx, ccy, ccz;
  float ctx, cty, ctz;
  bool fine;
  bool paired;  // DIAG: this fine step is the partner of a counted pair
  bool hit;
  int steps;
  int bbase;  // the fine walk's brick: index of its first word
  int fpad;   // fine edge pad mask
  int nrm;    // the hit normal's axis and flags (NRM_BOX, NRM_IMM)
  float fsx, fsy, fsz;  // fine walk start, brick units
  int it;     // loop iterations so far
};

// Start the walk of one ray.  (sx, sy, sz) is the world-clipped start in
// chunk units, (dx, dy, dz) the normalized direction, (padx, pady, padz) the
// coarse edge pad (0 or 1 each); all three come from the ray setup.  Returns
// false for an inactive ray, whose result is all zeros (no walk).
VX_HD bool ray_init(RayState& S, float sx, float sy, float sz, float dx, float dy, float dz,
                    int active, int padx, int pady, int padz) {
  if (!active) return false;
  const float flt_eps = 1.1920929e-07f;  // FLT_EPSILON, ops/aabb.py
  S.sx = sx; S.sy = sy; S.sz = sz;
  S.dx = dx; S.dy = dy; S.dz = dz;
  S.ivx = 1.0f / (dx == 0.0f ? flt_eps : dx);
  S.ivy = 1.0f / (dy == 0.0f ? flt_eps : dy);
  S.ivz = 1.0f / (dz == 0.0f ? flt_eps : dz);
  // tDelta |1 / d|: the same division where d != 0
  S.tdx = dx != 0.0f ? fabsf(S.ivx) : INFINITY;
  S.tdy = dy != 0.0f ? fabsf(S.ivy) : INFINITY;
  S.tdz = dz != 0.0f ? fabsf(S.ivz) : INFINITY;
  S.cpad = (padx ? 1 : 0) | (pady ? 2 : 0) | (padz ? 4 : 0);
  S.cx = (int)sx; S.cy = (int)sy; S.cz = (int)sz;  // trunc toward zero
  S.tx = init_tmax(S.cx, dx > 0.0f ? 1 : -1, sx, dx);
  S.ty = init_tmax(S.cy, dy > 0.0f ? 1 : -1, sy, dy);
  S.tz = init_tmax(S.cz, dz > 0.0f ? 1 : -1, sz, dz);
  S.tlast = 0.0f;
  S.ccx = S.ccy = S.ccz = 0;
  S.ctx = S.cty = S.ctz = 0.0f;
  S.fine = S.paired = S.hit = false;
  S.steps = S.bbase = S.fpad = S.nrm = 0;
  S.fsx = S.fsy = S.fsz = 0.0f;
  S.it = 0;
  return true;
}

// One iteration of the walk: one DDA event (a coarse step, a macro skip, a
// descend, a fine step, an ascend with its coarse step, a hit or leaving the
// world).  Returns true when the ray is done: a hit, a miss, the step budget
// spent, or the iteration cap reached (before this iteration).  MACRO and
// DIAG as in the header; with DIAG, the counters are added to diag[].
template <bool MACRO = false, bool DIAG = false, class Fetch>
VX_HD bool ray_iterate(const TraceParams& P, const Fetch& F, RayState& S, int* diag = nullptr) {
  if (S.it >= P.iter_limit) return true;
  const int f = P.factor;
  const float ff = (float)f;
  // x / ff == x * (1 / ff) bit for bit when ff is a power of two
  const bool pow2 = (f & (f - 1)) == 0;
  const float inv_ff = 1.0f / ff;
  const float sx = S.sx, sy = S.sy, sz = S.sz, dx = S.dx, dy = S.dy, dz = S.dz;
  const int stx = dx > 0.0f ? 1 : -1, sty = dy > 0.0f ? 1 : -1, stz = dz > 0.0f ? 1 : -1;
  if constexpr (DIAG) ++diag[D_ITERS];
  // 1. the current cell in range of its level (grid or brick, with pads)
  int hx, hy, hz, pm;
  if (S.fine) { hx = hy = hz = f; pm = S.fpad; } else { hx = P.gx; hy = P.gy; hz = P.gz; pm = S.cpad; }
  // 0 <= c < h + pad, as one unsigned compare an axis
  const bool in_range = (unsigned)S.cx < (unsigned)(hx + (pm & 1)) &&
                        (unsigned)S.cy < (unsigned)(hy + ((pm >> 1) & 1)) &&
                        (unsigned)S.cz < (unsigned)(hz + (pm >> 2));
  if (!in_range && !S.fine) return true;  // left the world: miss
  bool advance = true, ascend = !in_range;
  int word = 0, bit = 0;
  if (in_range) {
    const int lx = clampi(S.cx, 0, hx - 1), ly = clampi(S.cy, 0, hy - 1), lz = clampi(S.cz, 0, hz - 1);
    bool skipped = false;
    if constexpr (MACRO) {
      if (!S.fine && !F.region_occ(lx >> 3, ly >> 3, lz >> 3)) {
        const int l1 = macro_skip(P, F, lx, ly, lz, S.cx, S.cy, S.cz, S.tx, S.ty, S.tz, S.tlast,
                                  sx, sy, sz, dx, dy, dz, stx, sty, stz);
        S.steps = mini(S.steps + l1, P.max_steps);
        skipped = true;
        advance = false;
        if constexpr (DIAG) ++diag[D_MSKIP];
      }
    }
    if (!skipped) {
      // 2. one table word, one bit: the chunk's meta word (occupancy bit
      // 30) or the brick word holding the fine cell's bit
      int wi, sh;  // index of the word, and of the bit in it
      if (S.fine) {
        bit = sample_index(lx, ly, lz, f, f, P.brick_layout);
        wi = S.bbase + (bit >> 5);
        sh = bit & 31;
      } else {
        wi = F.cell(lx, ly, lz);
        sh = 30;
      }
      word = F.load(S.fine, wi);
      if ((word >> sh) & 1) {
        if (S.fine) {
          S.hit = true;  // ray_result rebuilds position and normal
          return true;
        }
        // ray vs the chunk's tight AABB (ops/aabb.py::ray_aabb)
        const float x0 = (float)(word & 31), y0 = (float)((word >> 5) & 31),
                    z0 = (float)((word >> 10) & 31);
        const float x1 = (float)((word >> 15) & 31) + 1.0f, y1 = (float)((word >> 20) & 31) + 1.0f,
                    z1 = (float)((word >> 25) & 31) + 1.0f;
        // the box corners in chunk units: one branch for all six scalings
        float ox0, oy0, oz0, ox1, oy1, oz1;
        if (pow2) {
          ox0 = x0 * inv_ff; oy0 = y0 * inv_ff; oz0 = z0 * inv_ff;
          ox1 = x1 * inv_ff; oy1 = y1 * inv_ff; oz1 = z1 * inv_ff;
        } else {
          ox0 = x0 / ff; oy0 = y0 / ff; oz0 = z0 / ff;
          ox1 = x1 / ff; oy1 = y1 / ff; oz1 = z1 / ff;
        }
        const float bx0 = (float)lx + ox0, by0 = (float)ly + oy0, bz0 = (float)lz + oz0;
        const float bx1 = (float)lx + ox1, by1 = (float)ly + oy1, bz1 = (float)lz + oz1;
        const float ax = (bx0 - sx) * S.ivx, bx = (bx1 - sx) * S.ivx;
        const float ay = (by0 - sy) * S.ivy, by = (by1 - sy) * S.ivy;
        const float az = (bz0 - sz) * S.ivz, bz = (bz1 - sz) * S.ivz;
        const float t1x = fmin2(ax, bx), t1y = fmin2(ay, by), t1z = fmin2(az, bz);
        const float btmin = fmax2(fmax2(t1x, t1y), t1z);
        const float btmax = fmin2(fmin2(fmax2(ax, bx), fmax2(ay, by)), fmax2(az, bz));
        if (btmax >= fmax2(btmin, 0.0f)) {
          // descend: park the coarse walk, start a fine DDA at the box
          // entry, or at the current position when already inside the box
          S.nrm = (btmin == t1x ? 0 : (btmin == t1y ? 1 : 2)) | NRM_BOX |
                  (S.steps == 0 && btmin <= 0.0f ? NRM_IMM : 0);
          float ex, ey, ez;
          if (btmin > 0.0f) {
            ex = sx + btmin * dx; ey = sy + btmin * dy; ez = sz + btmin * dz;
          } else {
            ex = sx + dx * S.tlast; ey = sy + dy * S.tlast; ez = sz + dz * S.tlast;
          }
          S.fsx = (ex - (float)lx) * ff;
          S.fsy = (ey - (float)ly) * ff;
          S.fsz = (ez - (float)lz) * ff;
          S.bbase = F.brick_base(wi);
          S.ccx = S.cx; S.ccy = S.cy; S.ccz = S.cz;
          S.ctx = S.tx; S.cty = S.ty; S.ctz = S.tz;
          S.cx = (int)S.fsx; S.cy = (int)S.fsy; S.cz = (int)S.fsz;
          S.tx = init_tmax(S.cx, stx, S.fsx, dx);
          S.ty = init_tmax(S.cy, sty, S.fsy, dy);
          S.tz = init_tmax(S.cz, stz, S.fsz, dz);
          const bool on_edge = S.cx == f || S.cy == f || S.cz == f;
          S.fpad = on_edge ? (dx < 0.0f ? 1 : 0) | (dy < 0.0f ? 2 : 0) | (dz < 0.0f ? 4 : 0) : 0;
          S.fine = true;
          advance = false;
          if constexpr (DIAG) { ++diag[D_PEND]; ++diag[D_DESC]; }
        }
      }
      if constexpr (DIAG) {
        if (!S.fine) ++diag[D_CADV];
      }
    }
  }
  if (advance) {
    // 3. one advance for both levels: the axis, and at the fine level the
    // crossing's entry point, which must stay inside the brick
    int a = axis_pick(S.tx, S.ty, S.tz);
    float tc = pick3(a, S.tx, S.ty, S.tz);
    if (S.fine && !ascend) {
      const float ix = a == 0 ? (float)(S.cx + (stx > 0 ? 1 : 0)) : S.fsx + tc * dx;
      const float iy = a == 1 ? (float)(S.cy + (sty > 0 ? 1 : 0)) : S.fsy + tc * dy;
      const float iz = a == 2 ? (float)(S.cz + (stz > 0 ? 1 : 0)) : S.fsz + tc * dz;
      ascend = ix < 0.0f || ix > ff || iy < 0.0f || iy > ff || iz < 0.0f || iz > ff;
      S.nrm = a;
    }
    if (ascend) {
      // back to the parked coarse walk, which takes this iteration's step
      S.cx = S.ccx; S.cy = S.ccy; S.cz = S.ccz;
      S.tx = S.ctx; S.ty = S.cty; S.tz = S.ctz;
      S.fine = false;
      a = axis_pick(S.tx, S.ty, S.tz);
      tc = pick3(a, S.tx, S.ty, S.tz);
      if constexpr (DIAG) ++diag[D_ASC];
    }
    // the step as selects, not a three-way branch: the same sums, and no
    // per-axis copies of the cell and tMax for the loop to merge
    S.cx += a == 0 ? stx : 0;
    S.cy += a == 1 ? sty : 0;
    S.cz += a == 2 ? stz : 0;
    S.tx = a == 0 ? S.tx + S.tdx : S.tx;
    S.ty = a == 1 ? S.ty + S.tdy : S.ty;
    S.tz = a == 2 ? S.tz + S.tdz : S.tz;
    S.tlast = tc;
    ++S.steps;
    if constexpr (DIAG) {
      if (S.fine) {
        if (S.paired) {
          S.paired = false;  // counted with its first step
        } else {
          ++diag[D_FSTEP];
          if (a == 0 && word == 0) ++diag[D_XRUN];
          S.paired = fine_pair(f, P.brick_layout, S.cx, S.cy, S.cz, S.fpad & 1, (S.fpad >> 1) & 1,
                               S.fpad >> 2, S.tx, S.ty, S.tz, bit, word, S.fsx, S.fsy, S.fsz, dx, dy,
                               dz, stx, sty, stz);
          if (S.paired) ++diag[D_STEP2];
        }
      }
    }
  }
  if (S.steps >= P.max_steps) return true;
  ++S.it;
  return false;
}

// The result of a finished walk.  A hit reports the fine entry point plus
// the chunk offset (VolumeRaytracer.cu:427-429) and the normal of the last
// crossing (VolumeRaytracer.cu:495-503): the box-entry face before the first
// fine step, else the last step's.  A ray cut by the iteration cap reports
// the full budget, never a fake low-steps miss (pallas_bigtrace.py:1507-1512).
VX_HD TraceResult ray_result(const TraceParams& P, const RayState& S) {
  TraceResult r = {0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
  if (S.hit) {
    const int a = S.nrm & 3;
    float px = S.fsx, py = S.fsy, pz = S.fsz;
    if (S.nrm & NRM_BOX) {
      r.nx = a == 0 ? (S.ivx < 0.0f ? -1.0f : 1.0f) : 0.0f;
      r.ny = a == 1 ? (S.ivy < 0.0f ? -1.0f : 1.0f) : 0.0f;
      r.nz = a == 2 ? (S.ivz < 0.0f ? -1.0f : 1.0f) : 0.0f;
    } else {
      // the entry point of the last step: the crossed face on its axis,
      // start + tlast * d on the others
      const int stx = S.dx > 0.0f ? 1 : -1, sty = S.dy > 0.0f ? 1 : -1, stz = S.dz > 0.0f ? 1 : -1;
      px = a == 0 ? (float)(stx > 0 ? S.cx : S.cx + 1) : S.fsx + S.tlast * S.dx;
      py = a == 1 ? (float)(sty > 0 ? S.cy : S.cy + 1) : S.fsy + S.tlast * S.dy;
      pz = a == 2 ? (float)(stz > 0 ? S.cz : S.cz + 1) : S.fsz + S.tlast * S.dz;
      r.nx = a == 0 ? (float)stx : 0.0f;
      r.ny = a == 1 ? (float)sty : 0.0f;
      r.nz = a == 2 ? (float)stz : 0.0f;
    }
    r.px = px + (float)(S.ccx * P.factor);
    r.py = py + (float)(S.ccy * P.factor);
    r.pz = pz + (float)(S.ccz * P.factor);
    r.flags = 1 | (S.nrm & NRM_IMM ? 2 : 0);
  }
  r.steps = S.it < P.iter_limit ? S.steps : P.max_steps;
  return r;
}

// Trace one ray: ray_init, ray_iterate until done, ray_result (K1, K4 and
// the host entries).  Arguments as ray_init's; with DIAG, the D_COUNT
// counters are added to diag[].
template <bool MACRO = false, bool DIAG = false, class Fetch>
VX_HD TraceResult trace_ray(const TraceParams& P, const Fetch& F,
                            float sx, float sy, float sz, float dx, float dy, float dz,
                            int active, int padx, int pady, int padz, int* diag = nullptr) {
  RayState S;
  if (!ray_init(S, sx, sy, sz, dx, dy, dz, active, padx, pady, padz)) {
    const TraceResult none = {0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
    return none;
  }
  while (!ray_iterate<MACRO, DIAG>(P, F, S, diag)) {
  }
  return ray_result(P, S);
}

}  // namespace vx
