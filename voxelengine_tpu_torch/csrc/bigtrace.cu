// Line-table brickmap traversal for Hopper (sm_90a): K1.
//
// Replaces voxelengine_tpu/ops/pallas_bigtrace.py::_bigtrace_kernel, the TPU
// kernel of trace_brickmap_hbm, and computes the same function: per ray,
// the two-level brickmap DDA over the line table (meta and slot words in
// region lines, brick words in brick lines), with flags = hit | hit_imm << 1
// and steps = max_steps for a ray still active at the iteration cap.  With
// use_macro it takes the TPU kernel's L1/L2/L3 macro skips over empty
// regions (dda.cuh, MACRO); with a diag buffer it is the TPU kernel's
// measurement build (return_iters / return_phases): the 10 phase counters
// per ray, and the iteration count of the ray's warp, the loop count of its
// longest lane, where the TPU reports its tile's lockstep iterations
// (pallas_bigtrace.py:1514).  Four instantiations, (macro, diag) each on or
// off; the production ones (diag off) keep their instruction streams.
//
// Two entries over one kernel template, by the form of the rays
// (ray_setup.cuh): vx_bigtrace_rays takes origins and raw directions and
// computes trace_brickmap_hbm's card branch whole, the ray setup before the
// walk and the hit_imm fix-up after it (ray_setup.cuh::trace_ray_full); it
// is the frame path's K1, one launch a trace where the eager setup and
// fix-up took ~69 more kernels and ~0.46 ms of device time on the bench
// frame on an H100 (PERF.md).  vx_bigtrace takes the prepared rays of that
// setup (start, direction, active, pad) and leaves the fix-up to its
// caller: the walk alone, which kernel_ab.py times.  Each has the four
// (macro, diag) instantiations.
//
// Design: one thread per ray, in the order the caller gives (render_frame's
// tile_order: 32x32-pixel blocks, so neighbouring threads walk neighbouring
// chunks and share L1 lines), the loop of dda.cuh::trace_ray, tables read
// through the read-only path.  None of the TPU kernel's machinery is
// carried over: no line cache, no voted DMA, no select-chain fetch, no
// deferred descend, no lockstep tile.
//
// Least time: the bytes of the rays (40 B in, 32 B out per ray) plus the
// table bytes the rays touch (at least the region entry and the brick word
// of each distinct hit) against the DDA work, one event per iteration.
// What bounds it on this card (PERF.md): the latency of each
// iteration's dependent chain and the instructions on it, and the warps'
// divergence, not memory.  The first build took ~140-155 SM-cycles per
// warp-iteration on the demo frame (its schedulers issuing on at most ~40%
// of their slots), where one iteration makes one 4-byte load that L2 (often
// L1) serves, with 80 registers (24 warps an SM) and the coarse and fine
// phases on separate paths.  What the design does about it: the convergent
// loop of dda.cuh, no division by the factor in the box test, and 64
// registers (__launch_bounds__(128, 8): 32 warps an SM) for the production
// builds, measured faster than the compiler's own 72 and than 256-thread
// blocks; the macro build spills at 64 registers and measured 13% faster so
// on the sparse world than at the 84 it takes uncapped.  The diag builds
// keep the compiler's own budget.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC  (kernels/build.py).
// --fmad=false keeps every a*b+c separately rounded, as the plain torch
// trace computes it; no fast-math, so 1.0f/d and (b - s)/d stay IEEE.
#include <cuda_runtime.h>

#include "ray_setup.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;  // 8 x 128 threads an SM: at most 64 registers a thread

// Rays: vx::PreparedRays or vx::OriginRays.
template <bool MACRO, bool DIAG, class Rays>
__global__ void __launch_bounds__(THREADS, DIAG ? 1 : MIN_BLOCKS)
bigtrace_kernel(vx::TraceParams P, vx::LineTableFetch F, int n, Rays R, float* __restrict__ pos,
                float* __restrict__ normal, int* __restrict__ steps, int* __restrict__ diag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (!DIAG) {
    if (i >= n) return;
  }
  int dg[vx::D_COUNT] = {};
  if (i < n) {
    const vx::TraceResult r = R.template trace<MACRO, DIAG>(P, F, i, dg);
    R.store_flags(i, r.flags);
    vx::store_ray(r, i, pos, normal, steps);
  }
  if constexpr (DIAG) {
    // every lane of the warp is here (no early return in this build)
    const int warp_iters = __reduce_max_sync(0xffffffffu, dg[vx::D_ITERS]);
    if (i < n) {
      for (int k = 0; k < vx::D_ITERS; ++k) diag[(long long)k * n + i] = dg[k];
      diag[(long long)vx::D_ITERS * n + i] = warp_iters;
    }
  }
}

template <bool MACRO, bool DIAG, class Rays>
int launch(const vx::TraceParams& P, const vx::LineTableFetch& F, int n, const Rays& R, float* pos,
           float* normal, int* steps, int* diag, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  bigtrace_kernel<MACRO, DIAG><<<blocks, THREADS, 0, stream>>>(P, F, n, R, pos, normal, steps, diag);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of (use_macro, diag != null).
template <class Rays>
int launch_any(const vx::TraceParams& P, const vx::LineTableFetch& F, int n, const Rays& R, int use_macro,
               float* pos, float* normal, int* steps, int* diag, void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (use_macro) {
    return diag ? launch<true, true>(P, F, n, R, pos, normal, steps, diag, s)
                : launch<true, false>(P, F, n, R, pos, normal, steps, diag, s);
  }
  return diag ? launch<false, true>(P, F, n, R, pos, normal, steps, diag, s)
              : launch<false, false>(P, F, n, R, pos, normal, steps, diag, s);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// `diag` is null, or int32[D_COUNT, n]: the 10 phase counters, then the
// warp's iteration count.
extern "C" int vx_bigtrace(const float* start, const float* dir, const int* active,
                           const int* pad, const int* region_lines, const int* brick_lines,
                           const int* macro, const int* macro2, int n, int gx, int gy, int gz,
                           int rx, int ry, int rz, int factor, int wpb, int max_steps,
                           int brick_layout, int iter_limit, int use_macro, int* flags,
                           float* pos, float* normal, int* steps, int* diag, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const vx::PreparedRays R = {start, dir, active, pad, flags};
  return launch_any(P, F, n, R, use_macro, pos, normal, steps, diag, stream);
}

// The rays entry: origins and raw directions (f32[n, 3], row strides os
// and rs of 3, or 0 for one shared row); writes hit (one byte a ray, 0 or
// 1), position and normal after the hit_imm fix-up, and steps.  Otherwise
// as vx_bigtrace.
extern "C" int vx_bigtrace_rays(const float* origins, int os, const float* rays, int rs,
                                const int* region_lines, const int* brick_lines, const int* macro,
                                const int* macro2, int n, int gx, int gy, int gz, int rx, int ry,
                                int rz, int factor, int wpb, int max_steps, int brick_layout,
                                int iter_limit, int use_macro, unsigned char* hit, float* pos,
                                float* normal, int* steps, int* diag, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const vx::OriginRays R = {origins, os, rays, rs, hit};
  return launch_any(P, F, n, R, use_macro, pos, normal, steps, diag, stream);
}
