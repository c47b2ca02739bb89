// Line-table brickmap traversal for Hopper (sm_90a).
//
// Replaces voxelengine_tpu/ops/pallas_bigtrace.py::_bigtrace_kernel, the TPU
// kernel of trace_brickmap_hbm, and computes the same function: per ray,
// the two-level brickmap DDA of ops/trace.py::trace_brickmap over the line
// table (meta and slot words in region lines, brick words in brick lines),
// with flags = hit | hit_imm << 1 and steps = max_steps for a ray still
// active at the iteration cap.
//
// Design: one thread per ray, a plain loop per thread (dda.cuh), tables
// read from global memory through L1/L2.  None of the TPU kernel's
// machinery is carried over: no line cache, no voted DMA, no select-chain
// fetch, no deferred descend, no lockstep tile.  The macro skip levels are
// not here yet; walking chunk by chunk gives identical outputs.
//
// Least time: the bytes of the rays (40 B in, 32 B out per ray) plus the
// table bytes the rays touch (at least the region entry and the brick word
// of each distinct hit) against the DDA work, sum(steps) events.
// What bounds it on this card: every DDA event is a dependent 4-byte load
// (meta word, then brick word) whose latency the thread waits out, and the
// 32 rays of a warp diverge in path length and in phase (coarse / fine).
// What the design does about that: nothing yet beyond L1/L2 reuse, which
// the ray order given by render_frame's tile_order (32x32-pixel blocks, so
// neighbouring threads walk neighbouring chunks) makes likely.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC  (kernels/build.py).
// --fmad=false keeps every a*b+c separately rounded, as the plain torch
// trace computes it; no fast-math, so 1.0f/d and (b - s)/d stay IEEE.
#include <cuda_runtime.h>

#include "dda.cuh"

namespace {

__global__ void __launch_bounds__(128)
bigtrace_kernel(vx::TraceParams P, vx::LineTableFetch F, int n,
                const float* __restrict__ start, const float* __restrict__ dir,
                const int* __restrict__ active, const int* __restrict__ pad,
                int* __restrict__ flags, float* __restrict__ pos,
                float* __restrict__ normal, int* __restrict__ steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const vx::TraceResult r = vx::trace_ray(
      P, F,
      start[3 * i], start[3 * i + 1], start[3 * i + 2],
      dir[3 * i], dir[3 * i + 1], dir[3 * i + 2],
      active[i], pad[3 * i], pad[3 * i + 1], pad[3 * i + 2]);
  flags[i] = r.flags;
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vx_bigtrace(const float* start, const float* dir, const int* active,
                           const int* pad, const int* region_lines, const int* brick_lines,
                           int n, int gx, int gy, int gz, int rx, int ry, int factor,
                           int wpb, int max_steps, int brick_layout, int iter_limit,
                           int* flags, float* pos, float* normal, int* steps, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, rx, ry, wpb};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bigtrace_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, F, n, start, dir, active, pad, flags, pos, normal, steps);
  return static_cast<int>(cudaGetLastError());
}
