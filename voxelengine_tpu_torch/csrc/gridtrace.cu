// Dense-grid traversal for Hopper (sm_90a): K2 and K3.
//
// K2 (vx_trace_grid) replaces voxelengine_tpu/ops/pallas_trace.py::
// _grid_kernel_vpu, the TPU kernel of trace_grid_vpu and of
// render_frame_dense; K3 (vx_trace_grid_limbs) replaces pallas_trace.py::
// _grid_kernel, the TPU kernel of trace_grid_mxu, its cross-check.  Both
// compute ops/trace.py::trace_grid per ray (grid_dda.cuh); they differ only
// in the word fetch: K2 reads the int32 words, K3 rebuilds each word from
// four uint8 limb planes.  None of the TPU fetch machinery (pair-gather
// over [8, 128] blocks, one-hot bf16 matmuls) is carried over: a thread
// reads the word it needs.
//
// Design: one thread per ray, a plain loop per thread, the table read from
// global memory through L1/L2.
//
// What bounds it on this card: the bytes of the rays (40 B in, 32 B out per
// ray) plus the table bytes the rays touch (at least the word of each
// distinct hit voxel; the whole table is 32 KB at 64^3) against the DDA
// work, sum(steps) dependent word loads and ~10 float ops each.  At 1M rays the rays'
// 72 MB are the least-time term; the table is read far more often than
// once but stays in L1/L2.  Each step waits out its load's latency and the
// 32 rays of a warp run to the longest ray's length.  Staging a table of
// up to 227 KB in shared memory, and a ray order that keeps a warp's rays
// together, are later work.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "grid_dda.cuh"

namespace {

template <class Fetch>
__global__ void __launch_bounds__(128)
grid_kernel(vx::GridParams P, Fetch F, int n,
            const float* __restrict__ start, const float* __restrict__ dir,
            const int* __restrict__ active, const int* __restrict__ pad,
            int* __restrict__ hit, float* __restrict__ pos,
            float* __restrict__ normal, int* __restrict__ steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const vx::GridResult r = vx::trace_grid_ray(
      P, F, start[3 * i], start[3 * i + 1], start[3 * i + 2],
      dir[3 * i], dir[3 * i + 1], dir[3 * i + 2],
      active[i], pad[3 * i], pad[3 * i + 1], pad[3 * i + 2]);
  hit[i] = r.hit;
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

template <class Fetch>
int launch(const vx::GridParams& P, const Fetch& F, int n, const float* start, const float* dir,
           const int* active, const int* pad, int* hit, float* pos, float* normal, int* steps,
           void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  grid_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, F, n, start, dir, active, pad, hit, pos, normal, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2.  Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vx_trace_grid(const float* start, const float* dir, const int* active,
                             const int* pad, const int* words, int n, int X, int Y, int Z,
                             int layout, int max_steps, int* hit, float* pos, float* normal,
                             int* steps, void* stream) {
  const vx::GridParams P = {X, Y, Z, layout, max_steps};
  return launch(P, vx::WordFetch{words}, n, start, dir, active, pad, hit, pos, normal, steps,
                stream);
}

// K3: the same with the word rebuilt from limbs [4, plane] (uint8).
extern "C" int vx_trace_grid_limbs(const float* start, const float* dir, const int* active,
                                   const int* pad, const unsigned char* limbs, long long plane,
                                   int n, int X, int Y, int Z, int layout, int max_steps,
                                   int* hit, float* pos, float* normal, int* steps,
                                   void* stream) {
  const vx::GridParams P = {X, Y, Z, layout, max_steps};
  return launch(P, vx::LimbFetch{limbs, plane}, n, start, dir, active, pad, hit, pos, normal,
                steps, stream);
}
