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
// Design (K2, and K3's global instantiation): one thread per ray, a plain
// loop per thread, the grid read from global memory through the read-only
// path (L1/L2).  The kernel reads the origin (one row at stride 0 when it
// is shared) and the raw direction and writes hit (one byte, the bool
// tensor the wrapper returns), position, normal and steps (29 B a ray):
// the wrapper launches nothing else.  The
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
// K3 has two instantiations, picked by the wrapper from the grid's size
// (kernels/gridtrace.py::words_in_shared):
//   staged (vx_trace_grid_limbs with staged = 1, grids of up to
//     VX_SMEM_WORDS_LIMIT bytes of words): a persistent grid, sized by the
//     occupancy calculator, of 256- or 1024-thread blocks (whichever holds
//     more warps an SM); each block rebuilds the words from the four planes
//     once into its shared memory (16-byte loads, grid_dda.cuh::
//     limb_words16) and its warps then take 32 rays at a time from a global
//     work counter (zeroed on the stream before the launch) and walk them
//     with one shared load a step (SharedWordFetch): K2's loop at K2's cost
//     a step, where LimbFetch reads four bytes from four planes.  On the
//     config-2 batch (32 KB of words) it measured 14% faster than the
//     global instantiation and within 6% of K2 (PERF.md), where a
//     persistent K2 measured slower than plain blocks (above);
//   global (staged = 0, larger grids): plain 128-thread blocks with
//     LimbFetch, as K2 runs.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "grid_dda.cuh"

// Largest staged word table (bytes) K3 keeps in a block's shared memory;
// the wrapper's kernels/gridtrace.py::SMEM_WORDS_LIMIT is the same number.
#define VX_SMEM_WORDS_LIMIT (200 * 1024)

namespace {

constexpr int THREADS = 128;
constexpr int STAGED_THREADS_MAX = 1024;

__device__ __forceinline__ void store(const vx::GridResult& r, int i, unsigned char* __restrict__ hit,
                                      float* __restrict__ pos, float* __restrict__ normal,
                                      int* __restrict__ steps) {
  hit[i] = (unsigned char)r.hit;
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

template <int LAYOUT, class Fetch>
__device__ __forceinline__ void trace_store(const vx::GridParams& P, const Fetch& F, int i,
                                            const float* __restrict__ origins, int os,
                                            const float* __restrict__ rays, int rs,
                                            unsigned char* __restrict__ hit, float* __restrict__ pos,
                                            float* __restrict__ normal, int* __restrict__ steps) {
  const float* o = origins + (long long)os * i;
  const float* v = rays + (long long)rs * i;
  const vx::GridResult r = vx::trace_grid_full<LAYOUT>(P, F, o[0], o[1], o[2], v[0], v[1], v[2]);
  store(r, i, hit, pos, normal, steps);
}

template <int LAYOUT, class Fetch>
__global__ void __launch_bounds__(THREADS)
grid_kernel(vx::GridParams P, Fetch F, int n,
            const float* __restrict__ origins, int os, const float* __restrict__ rays, int rs,
            unsigned char* __restrict__ hit, float* __restrict__ pos,
            float* __restrict__ normal, int* __restrict__ steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace_store<LAYOUT>(P, F, i, origins, os, rays, rs, hit, pos, normal, steps);
}

// K3, staged: the words rebuilt into shared memory (words16 groups of 16),
// then 32 rays a warp at a time from the work counter.
template <int LAYOUT>
__global__ void __launch_bounds__(STAGED_THREADS_MAX)
grid_limbs_staged_kernel(vx::GridParams P, const unsigned char* __restrict__ limbs, long long plane,
                         int words16, int n, int* __restrict__ counter,
                         const float* __restrict__ origins, int os, const float* __restrict__ rays,
                         int rs, unsigned char* __restrict__ hit, float* __restrict__ pos,
                         float* __restrict__ normal, int* __restrict__ steps) {
  extern __shared__ int4 smem_words[];
  int* words = reinterpret_cast<int*>(smem_words);
  for (int q = threadIdx.x; q < words16; q += blockDim.x) vx::limb_words16(limbs, plane, q, words + 16 * q);
  __syncthreads();
  const vx::SharedWordFetch F = {words};
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) return;  // the same for every lane of the warp
    const int i = base + lane;
    if (i < n) trace_store<LAYOUT>(P, F, i, origins, os, rays, rs, hit, pos, normal, steps);
  }
}

// Threads a block and blocks of the staged K3 for smem bytes of words: the
// block size of {256, 1024} that holds more warps an SM (256 on a tie), and
// as many blocks as the card holds at once, no more than batches of 32 rays.
template <int LAYOUT>
int staged_shape(size_t smem, int n, int* threads, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(grid_limbs_staged_kernel<LAYOUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int best_warps = 0, best_per_sm = 0;
  for (int t : {256, 1024}) {
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_limbs_staged_kernel<LAYOUT>, t, smem);
    if (per_sm * t / 32 > best_warps) {
      best_warps = per_sm * t / 32;
      best_per_sm = per_sm;
      *threads = t;
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (best_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long warps = ((long long)n + 31) / 32;
  const long long wanted = (warps + *threads / 32 - 1) / (*threads / 32);
  const long long most = (long long)best_per_sm * sms;
  *blocks = (int)(wanted < most ? wanted : most);
  return 0;
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

// K3: the same with the words given as limbs [4, plane] (uint8, plane a
// multiple of 16, 16-byte aligned).  staged = 1 runs the shared-memory
// instantiation: the first words16 * 16 words (the grid's words rounded up
// to 16; at most VX_SMEM_WORDS_LIMIT bytes, else cudaErrorInvalidValue) are
// rebuilt into each block's shared memory, and `counter` (one int of device
// scratch) is zeroed here on `stream` for the work queue.  staged = 0 runs
// the global instantiation (LimbFetch; words16 and counter unused).
extern "C" int vx_trace_grid_limbs(const float* origins, int os, const float* rays, int rs,
                                   const unsigned char* limbs, long long plane, int n, int X,
                                   int Y, int Z, int layout, int max_steps, int staged, int words16,
                                   int* counter, unsigned char* hit, float* pos, float* normal,
                                   int* steps, void* stream) {
  const vx::GridParams P = {X, Y, Z, max_steps};
  if (!staged)
    return launch(P, vx::LimbFetch{limbs, plane}, layout, n, origins, os, rays, rs, hit, pos, normal,
                  steps, stream);
  if (n == 0) return 0;
  const size_t smem = (size_t)words16 * 16 * sizeof(int);
  if (smem > VX_SMEM_WORDS_LIMIT || (long long)words16 * 16 > plane)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return vx::with_layout(layout, [&](auto tag) {
    constexpr int L = decltype(tag)::value;
    int threads = 0, blocks = 0;
    int e = staged_shape<L>(smem, n, &threads, &blocks);
    if (e != 0) return e;
    e = static_cast<int>(cudaMemsetAsync(counter, 0, sizeof(int), s));
    if (e != 0) return e;
    grid_limbs_staged_kernel<L><<<blocks, threads, smem, s>>>(P, limbs, plane, words16, n, counter,
                                                             origins, os, rays, rs, hit, pos, normal,
                                                             steps);
    return static_cast<int>(cudaGetLastError());
  });
}
