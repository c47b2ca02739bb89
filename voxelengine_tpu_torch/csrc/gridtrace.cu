// Dense-grid traversal for Hopper (sm_90a): K2 and K3.
//
// K2 (vx_trace_grid) replaces voxelengine_tpu/ops/pallas_trace.py::
// _grid_kernel_vpu, the TPU kernel of trace_grid_vpu and of
// render_frame_dense; K3 (vx_trace_grid_limbs) replaces pallas_trace.py::
// _grid_kernel, the TPU kernel of trace_grid_mxu, its cross-check.  Each
// computes its wrapper's whole function per ray (grid_dda.cuh::
// trace_grid_full): the ray setup that the JAX wrappers run in XLA before
// their Pallas kernels (normalize, world-AABB clip, entry normal, edge pad),
// the DDA of ops/trace.py::trace_grid, and the zero-step fix-up after it.
// They differ only in the word fetch: K2 reads the int32 words, K3 rebuilds
// each word from four uint8 limb planes.  None of the TPU fetch machinery
// (pair-gather over [8, 128] blocks, one-hot bf16 matmuls) is carried over:
// a thread reads the word it needs.
//
// Design: one thread per ray, a plain loop per thread, the grid read from
// global memory through the read-only path (L1/L2).  The kernel reads the
// origin (one row at stride 0 when it is shared) and the raw direction and
// writes hit (one byte, the bool tensor the wrapper returns), position,
// normal and steps (29 B a ray): the wrapper launches nothing else.  The
// setup and the fix-up are in the kernel because in eager torch they are
// 67 more launches a call (0.25 ms of device time on a dense frame's rays
// and ~1.4 ms of host enqueue) and make the walk read 40 B of prepared
// inputs a ray; fused, the whole call takes 0.028 ms (PERF.md).  Measured
// and not kept: a persistent grid of 1024-thread blocks with a warp work
// queue, as K4 has, with the 32 KB grid copied into each block's shared
// memory or read from global memory: 12% slower either way, and the two
// equal (L1 holds the grid as well as shared memory does).
//
// What bounds it on this card: the bytes of the rays plus the table bytes
// the rays touch (at least the word of each distinct hit voxel; the whole
// table is 32 KB at 64^3) against the DDA work, sum(steps) dependent word
// loads and ~10 float ops each.  At frame size the rays' bytes are the
// least-time term; the table is read far more often than once but stays in
// L1/L2.  Each step waits out its load's latency and the 32 rays of a warp
// run to the longest ray's length.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "grid_dda.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void store(const vx::GridResult& r, int i, unsigned char* __restrict__ hit,
                                      float* __restrict__ pos, float* __restrict__ normal,
                                      int* __restrict__ steps) {
  hit[i] = (unsigned char)r.hit;
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

template <int LAYOUT, class Fetch>
__global__ void __launch_bounds__(THREADS)
grid_kernel(vx::GridParams P, Fetch F, int n,
            const float* __restrict__ origins, int os, const float* __restrict__ rays, int rs,
            unsigned char* __restrict__ hit, float* __restrict__ pos,
            float* __restrict__ normal, int* __restrict__ steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* o = origins + os * i;
  const float* v = rays + rs * i;
  const vx::GridResult r = vx::trace_grid_full<LAYOUT>(P, F, o[0], o[1], o[2], v[0], v[1], v[2]);
  store(r, i, hit, pos, normal, steps);
}

template <class Fetch>
int launch(const vx::GridParams& P, const Fetch& F, int layout, int n, const float* origins,
           int os, const float* rays, int rs, unsigned char* hit, float* pos, float* normal, int* steps,
           void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  const auto s = static_cast<cudaStream_t>(stream);
  return vx::with_layout(layout, [&](auto tag) {
    grid_kernel<decltype(tag)::value><<<blocks, THREADS, 0, s>>>(P, F, n, origins, os, rays, rs,
                                                                 hit, pos, normal, steps);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// K2: trace_grid_vpu's function for n rays (origins and raw directions, ray
// i at origins[os * i .. os * i + 2] and rays[rs * i .. rs * i + 2]; os 0 for
// one origin shared by all rays) through the int32 words of an X x Y x Z
// grid in `layout`.  Writes hit (one byte a ray, 0 or 1), position and
// normal (f32[n, 3]) and steps (i32[n]).  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int vx_trace_grid(const float* origins, int os, const float* rays, int rs,
                             const int* words, int n, int X, int Y, int Z, int layout,
                             int max_steps, unsigned char* hit, float* pos, float* normal,
                             int* steps, void* stream) {
  const vx::GridParams P = {X, Y, Z, max_steps};
  return launch(P, vx::WordFetch{words}, layout, n, origins, os, rays, rs, hit, pos, normal, steps,
                stream);
}

// K3: the same with the word rebuilt from limbs [4, plane] (uint8).
extern "C" int vx_trace_grid_limbs(const float* origins, int os, const float* rays, int rs,
                                   const unsigned char* limbs, long long plane, int n, int X,
                                   int Y, int Z, int layout, int max_steps, unsigned char* hit,
                                   float* pos, float* normal, int* steps, void* stream) {
  const vx::GridParams P = {X, Y, Z, max_steps};
  return launch(P, vx::LimbFetch{limbs, plane}, layout, n, origins, os, rays, rs, hit, pos, normal,
                steps, stream);
}
