// Dense-slot brickmap traversal for Hopper (sm_90a): K4.
//
// Replaces voxelengine_tpu/ops/pallas_trace2.py::_bm_kernel, the TPU kernel
// of trace_brickmap_mxu, and computes the same function: per ray, the
// two-level brickmap DDA of ops/trace.py::trace_brickmap over a dense-slot
// brickmap, with meta words addressed by chunk index in the coarse layout
// and brick words by chunk index times words per brick; flags = hit |
// hit_imm << 1.  It is K1's DDA body (dda.cuh::trace_ray) with the
// DenseSlotFetch policy in place of the line table.  The TPU kernel's
// one-hot bf16 limb matmuls exist because Mosaic has no per-lane gather;
// here a thread reads the word it needs.
//
// Design: one thread per ray, a plain loop per thread, meta and bricks read
// from global memory through L1/L2.
//
// What bounds it on this card: the bytes of the rays (40 B in, 32 B out per
// ray) plus the table bytes the rays touch (at least the brick word and the
// meta word of each distinct hit; all of it is 272 KB for a 128^3 world at
// factor 8) against the DDA work, sum(steps) events, each a dependent 4-byte load (meta word, then
// brick words) whose latency the thread waits out, with the 32 rays of a
// warp diverging in length and phase (coarse / fine).  Staging tables of up
// to 227 KB in shared memory is later work.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "dda.cuh"

namespace {

__global__ void __launch_bounds__(128)
bmtrace_kernel(vx::TraceParams P, vx::DenseSlotFetch F, int n,
               const float* __restrict__ start, const float* __restrict__ dir,
               const int* __restrict__ active, const int* __restrict__ pad,
               int* __restrict__ flags, float* __restrict__ pos,
               float* __restrict__ normal, int* __restrict__ steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const vx::TraceResult r = vx::trace_ray(
      P, F, start[3 * i], start[3 * i + 1], start[3 * i + 2],
      dir[3 * i], dir[3 * i + 1], dir[3 * i + 2],
      active[i], pad[3 * i], pad[3 * i + 1], pad[3 * i + 2]);
  flags[i] = r.flags;
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vx_trace_brickmap_dense(const float* start, const float* dir, const int* active,
                                       const int* pad, const int* meta, const int* bricks,
                                       int n, int gx, int gy, int gz, int factor, int wpb,
                                       int max_steps, int coarse_layout, int brick_layout,
                                       int iter_limit, int* flags, float* pos, float* normal,
                                       int* steps, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::DenseSlotFetch F = {meta, bricks, gx, gy, coarse_layout, wpb};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bmtrace_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, F, n, start, dir, active, pad, flags, pos, normal, steps);
  return static_cast<int>(cudaGetLastError());
}
