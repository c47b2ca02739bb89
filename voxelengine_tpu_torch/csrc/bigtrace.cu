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
// per ray, and the iteration count of the ray's warp batch (32 consecutive
// rays), the loop count of its longest lane, where the TPU reports its
// tile's lockstep iterations
// (pallas_bigtrace.py:1514).  Four instantiations, (macro, diag) each on or
// off; the production ones (diag off) keep their instruction streams.
//
// Three entries over one kernel template, by the form of the rays
// (ray_setup.cuh), each from origins and raw directions: vx_bigtrace_rays
// computes trace_brickmap_hbm's card branch whole, the ray setup before the
// walk and the hit_imm fix-up after it (ray_setup.cuh::trace_ray_full); it
// is the frame path's K1, one launch a trace where the eager setup and
// fix-up took ~69 more kernels and ~0.46 ms of device time on the bench
// frame on an H100 (PERF.md), and it has the four (macro, diag)
// instantiations.  vx_bigtrace_secondary takes the primary trace's results
// and builds, walks and reduces the shading's shadow, reflection or AO rays
// (secondary.cuh; macro on and off, three kinds): a shaded frame's
// secondary traces are three launches where the eager rays and AO's sample
// loop took ~540 kernels (PERF.md).  Its AO kind walks all of a ray's
// samples in one thread and keeps the sum in a register.
// vx_bigtrace_record is vx_bigtrace_rays (macro off) storing the ray API's
// result record instead of the trace's fields
// (ray_setup.cuh::OriginRaysRecord): VoxelRaytracer3D.raytrace's card path,
// one launch a call.  The walk on prepared rays (ray_setup.cuh::
// PreparedRays) has no launcher: its g++ twin, dda_host.cpp::vx_trace_host,
// holds the shared loop to the JAX kernel on the kernel's own inputs.
//
// Design: one thread a ray, the loop of dda.cuh::trace_ray, tables read
// through the read-only path, launched as K4 is (bmtrace.cu): a persistent
// grid of 1024-thread blocks, as many as the card holds at once (asked once
// a process for each instantiation, grid_cache.cuh), in which each warp
// takes 32 rays at a time from a global work counter (lane 0 atomicAdd,
// broadcast by __shfl_sync) until none are left.  The counter is zeroed on
// the launch's stream before every launch.  Batches go out in the caller's
// order (render_frame's tile_order: 32x32-pixel blocks).  A batch is
// warp-uniform (no lane returns inside it), as the diag build's
// __reduce_max_sync needs.  Why: walk lengths vary widely on a turning
// camera (ground rays end in a few chunks, horizon and sky-bound reflection
// rays cross the world); where a 128-thread block had 128 rays of its own,
// its SM slot stayed taken until its slowest warp ended.  Measured on an
// H100 against that launch (PERF.md): 3-4% less device time over the four
// walks of a frame at 8 yaws of the benchmark's turning camera, and 6-7%
// more on the primary rays of the one fixed camera; the same queue in
// 128-, 256- or 512-thread blocks, or with a block taking 4-32 batches at a
// time, was slower.  None of the TPU kernel's machinery is carried over: no
// line cache, no voted DMA, no select-chain fetch, no deferred descend, no
// lockstep tile.
//
// Least time: the bytes of the rays (24 B in, 29 B out per ray) plus the
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
// registers (32 warps an SM) for the production builds, measured faster
// than the compiler's own 72; the macro build spills at 64 registers and
// measured 13% faster so on the sparse world than at the 84 it takes
// uncapped.  The diag builds keep the compiler's own budget, in 128-thread
// blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC  (kernels/build.py).
// --fmad=false keeps every a*b+c separately rounded, as the plain torch
// trace computes it; no fast-math, so 1.0f/d and (b - s)/d stay IEEE.
#include <cuda_runtime.h>

#include "grid_cache.cuh"
#include "ray_setup.cuh"
#include "secondary.cuh"

namespace {

constexpr int THREADS = 1024;  // a production build's block: 1024 x 64 registers fill an SM's register file
constexpr int DIAG_THREADS = 128;  // a diag build's block, at the compiler's own register budget

// Rays: vx::OriginRays, vx::OriginRaysRecord (pos, normal and steps: the
// record's hit_point, normal and steps), or vx::SecondaryRays (DIAG off; it
// stores its own outputs).
template <bool MACRO, bool DIAG, class Rays>
__global__ void __launch_bounds__(DIAG ? DIAG_THREADS : THREADS, 1)
bigtrace_kernel(vx::TraceParams P, vx::LineTableFetch F, int n, int* __restrict__ counter, Rays R,
                float* __restrict__ pos, float* __restrict__ normal, int* __restrict__ steps,
                int* __restrict__ diag) {
  const int lane = threadIdx.x & 31;
  const int batches = (n >> 5) + ((n & 31) != 0);
  for (;;) {
    int b = 0;
    if (lane == 0) b = atomicAdd(counter, 1);  // the warp's next batch of 32 rays
    b = __shfl_sync(0xffffffffu, b, 0);
    if (b >= batches) return;  // the same for every lane of the warp
    const int i = b * 32 + lane;
    int dg[vx::D_COUNT] = {};
    if (i < n) {
      if constexpr (Rays::SECONDARY) {
        R.template run<MACRO>(P, F, i);
      } else {
        const vx::TraceResult r = R.template trace<MACRO, DIAG>(P, F, i, dg);
        R.store(r, i, pos, normal, steps);
      }
    }
    if constexpr (DIAG) {
      // every lane of the warp is here: a batch has no early return
      const int warp_iters = __reduce_max_sync(0xffffffffu, dg[vx::D_ITERS]);
      if (i < n) {
        for (int k = 0; k < vx::D_ITERS; ++k) diag[(long long)k * n + i] = dg[k];
        diag[(long long)vx::D_ITERS * n + i] = warp_iters;
      }
    }
  }
}

// As many blocks as the card holds at once, and no more warps than batches
// of 32 rays; grid (when not null) gets the SMs, the blocks an SM and the
// threads a block the grid was sized by.
template <bool MACRO, bool DIAG, class Rays>
int launch(const vx::TraceParams& P, const vx::LineTableFetch& F, int n, const Rays& R, float* pos,
           float* normal, int* steps, int* diag, int* counter, int* grid, cudaStream_t stream) {
  constexpr int threads = DIAG ? DIAG_THREADS : THREADS;
  static vx::GridCache cache;  // one for each instantiation
  int sms = 0, per_sm = 0;
  cudaError_t e = vx::resident_blocks(cache, bigtrace_kernel<MACRO, DIAG, Rays>, threads, 0, &sms, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long warps = ((long long)n + 31) / 32;
  const long long wanted = (warps + threads / 32 - 1) / (threads / 32);
  const int blocks = (int)(wanted < (long long)per_sm * sms ? wanted : (long long)per_sm * sms);
  e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  bigtrace_kernel<MACRO, DIAG><<<blocks, threads, 0, stream>>>(P, F, n, counter, R, pos, normal, steps, diag);
  if (grid) {
    grid[0] = sms;
    grid[1] = per_sm;
    grid[2] = threads;
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of (use_macro, diag != null).
template <class Rays>
int launch_any(const vx::TraceParams& P, const vx::LineTableFetch& F, int n, const Rays& R, int use_macro,
               float* pos, float* normal, int* steps, int* diag, int* counter, int* grid, void* stream) {
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (use_macro) {
    return diag ? launch<true, true>(P, F, n, R, pos, normal, steps, diag, counter, grid, s)
                : launch<true, false>(P, F, n, R, pos, normal, steps, diag, counter, grid, s);
  }
  return diag ? launch<false, true>(P, F, n, R, pos, normal, steps, diag, counter, grid, s)
              : launch<false, false>(P, F, n, R, pos, normal, steps, diag, counter, grid, s);
}

}  // namespace

// The rays entry: origins and raw directions (f32[n, 3], row strides os
// and rs of 3, or 0 for one shared row); writes hit (one byte a ray, 0 or
// 1), position and normal after the hit_imm fix-up, and steps.  Launches on
// `stream` without synchronising; returns the first CUDA error
// (cudaGetLastError() after the launch).  `diag` is null, or
// int32[D_COUNT, n]: the 10 phase counters, then the iteration count of the
// ray's warp batch.  `counter` is one int of device scratch, zeroed here on
// `stream`; `grid` is null or a host int[3], set to the SMs, the blocks an
// SM and the threads a block that sized the grid
// (kernels/bigtrace.py::launch_grid).
extern "C" int vx_bigtrace_rays(const float* origins, int os, const float* rays, int rs,
                                const int* region_lines, const int* brick_lines, const int* macro,
                                const int* macro2, int n, int gx, int gy, int gz, int rx, int ry,
                                int rz, int factor, int wpb, int max_steps, int brick_layout,
                                int iter_limit, int use_macro, unsigned char* hit, float* pos,
                                float* normal, int* steps, int* diag, int* counter, int* grid, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const vx::OriginRays R = {origins, os, rays, rs, hit};
  return launch_any(P, F, n, R, use_macro, pos, normal, steps, diag, counter, grid, stream);
}

// The record entry: vx_bigtrace_rays with the macro levels off and no diag
// build, storing the ray API's result record in the launch
// (ray_setup.cuh::OriginRaysRecord, engine/raytracer.py::RayTraceResults):
// valid (one byte a ray, 0 or 1), hit_point, normal, distance, voxel_index
// and steps.  VoxelRaytracer3D.raytrace's card path through a line table,
// one launch a call where the plain record after vx_bigtrace_rays took 24
// more kernels (PERF.md).  macro and macro2 are not read.
extern "C" int vx_bigtrace_record(const float* origins, int os, const float* rays, int rs,
                                  const int* region_lines, const int* brick_lines, const int* macro,
                                  const int* macro2, int n, int gx, int gy, int gz, int rx, int ry, int rz,
                                  int factor, int wpb, int max_steps, int brick_layout, int iter_limit,
                                  unsigned char* valid, float* hit_point, float* normal, float* distance,
                                  int* voxel_index, int* steps, int* counter, int* grid, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const vx::OriginRaysRecord R = {{origins, os, rays, rs, valid}, distance, voxel_index, gx * factor, gy * factor};
  if (n == 0) return 0;
  return launch<false, false>(P, F, n, R, hit_point, normal, steps, nullptr, counter, grid,
                              static_cast<cudaStream_t>(stream));
}

// The secondary entry: the shadow, reflection or AO rays (`kind`,
// secondary.cuh) of n primary rays, built from the primary trace's position
// and normal (and the rays' directions, pixels, light), walked and reduced
// in the launch; max_steps is the kind's (8 for AO), iter_limit its cap.
// Writes what shading reads: shadow (hit, steps), reflection (hit,
// position, normal), AO the factor; the other outputs may be null.
// Otherwise as vx_bigtrace_rays, without the diag build.
extern "C" int vx_bigtrace_secondary(VX_SECONDARY_PARAMS, const int* region_lines, const int* brick_lines,
                                     const int* macro, const int* macro2, int n, int gx, int gy, int gz, int rx,
                                     int ry, int rz, int factor, int wpb, int max_steps, int brick_layout,
                                     int iter_limit, int use_macro, VX_SECONDARY_OUTS, int* counter, int* grid,
                                     void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  return vx::with_secondary_kind(kind, VX_SECONDARY_ARGS, [&](const auto& R) {
    if (n == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    return use_macro ? launch<true, false>(P, F, n, R, nullptr, nullptr, nullptr, nullptr, counter, grid, s)
                     : launch<false, false>(P, F, n, R, nullptr, nullptr, nullptr, nullptr, counter, grid, s);
  });
}
