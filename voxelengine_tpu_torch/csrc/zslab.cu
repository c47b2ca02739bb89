// One round of the z-sharded walk for Hopper (sm_90a): K4-slab.
//
// No TPU kernel: the JAX package runs the round as its XLA state machine,
// voxelengine_tpu/ops/trace.py::_run_loop(slab=) under the migration loop of
// voxelengine_tpu/parallel/distributed.py::_trace_zsharded, not as a
// pallas_call.  Here it is K4's loop (dda.cuh::ray_iterate) instantiated for
// a rank's z-slab of a dense-slot LINEAR world (zslab.cuh::SlabFetch), with
// a pause at the slab's boundary and the ray's whole RayState in and out as
// int32 rows, so that the neighbour rank resumes a paused ray where it
// stopped (zslab.cuh).  The plain version is ops/trace.py::run_slab.
//
// What bounds it: as K4, the dependent chain of each iteration (address,
// one load, bit test, advance) against the DDA events of the round's rays;
// its bytes are the rays' inputs and results, a handed-on ray's 140-byte
// state row in, and a paused ray's row out.
//
// Design (K4's, bmtrace.cu): a persistent grid of 1024-thread blocks (64
// registers, one block an SM), as many as the occupancy calculator says the
// card holds at once; each warp takes 32 rays at a time from a global work
// counter (lane 0 atomicAdd, broadcast by __shfl_sync), zeroed on the
// launch's stream before every launch.  The slab's meta words are read from
// global memory (a copy in shared memory and an occupancy bitmap were
// measured no faster: PERF.md).  A handed-on round reads a warp's 32 state
// rows, 4,480 contiguous bytes, with 16-byte accesses through a buffer in
// shared memory (a lane's row at a stride of 35 words, so the lanes' rows
// fall in distinct banks), not with 35 strided 4-byte accesses a lane.
// Only a paused ray's row is written; a ray that is done leaves none.  The
// pause is asked only where its answer can change (zslab.cuh::slab_walk).
//
// One entry, vx_zslab_rays, the batch form the migration runs on the card:
// round 0 takes the whole batch's origins and raw directions and does the
// ray setup, the ownership test and the hit_imm fix-up in the launch
// (zslab.cuh::slab_round_rays), later rounds the handed-on rows and their
// batch indices.  A done ray's result goes to its index in the batch-wide
// outputs; a paused ray's row and index are appended to compact outputs at
// a slot a warp takes with one atomicAdd (the order of the slots is the
// warps' and changes from run to run; no result depends on it), and the
// counts the hand-off's shapes need (paused, owned) are two ints the
// wrapper reads once.  The round on prepared rays, with its results at the
// round's own rows, is the g++ twin's (dda_host.cpp::vx_zslab_host).
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cstdint>

#include <cuda_runtime.h>

#include "grid_cache.cuh"
#include "zslab.cuh"

namespace {

constexpr int THREADS = 1024;  // 1024 x 64 registers: one block fills an SM's register file
constexpr int WARPS = THREADS / 32;
constexpr int ROW_WORDS = 32 * vx::STATE_WORDS;  // a warp's 32 rows: 1,120 words, 280 16-byte pieces
constexpr size_t ROW_BYTES = (size_t)WARPS * ROW_WORDS * sizeof(int);  // 143,360

// The warp's rows [base, base + rows) of `src` (STATE_WORDS words each) into
// buf, 16 bytes a lane at a time where src is aligned (base is a multiple
// of 32, so a warp's block starts on a 16-byte boundary when src does).
__device__ __forceinline__ void load_rows(const int* src, int rows, int* buf, int lane) {
  const int words = rows * vx::STATE_WORDS;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = words & ~3;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* b4 = reinterpret_cast<int4*>(buf);
    for (int q = lane; q < head / 4; q += 32) b4[q] = __ldg(s4 + q);
  }
  for (int w = head + lane; w < words; w += 32) buf[w] = __ldg(src + w);
}

// The batch form (vx_zslab_rays).  counters: [0] the work counter, [1] the
// paused rays appended, [2] the rays round 0 owned.  ROUND0: ray i of m is
// the batch's ray i; else row i of rows_in, whose batch index is idx_in[i].
template <bool ROUND0>
__global__ void __launch_bounds__(THREADS, 1)
zslab_rays_kernel(vx::TraceParams P, vx::SlabFetch F, int m, int* __restrict__ counters,
                  const float* __restrict__ origins, int os, const float* __restrict__ rays, int rs,
                  const int* __restrict__ rows_in, const int* __restrict__ idx_in, int* __restrict__ rows_out,
                  int* __restrict__ idx_out, int* __restrict__ hit, float* __restrict__ pos,
                  float* __restrict__ normal, int* __restrict__ steps) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* buf = reinterpret_cast<int*>(smem) + warp * ROW_WORDS;  // this warp's rows
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counters, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= m) return;  // the same for every lane of the warp
    const int rows = min(32, m - base);
    const int i = base + lane;
    if (!ROUND0) load_rows(rows_in + (long long)base * vx::STATE_WORDS, rows, buf, lane);
    __syncwarp();
    int st = vx::SLAB_OTHER, b = 0;
    if (i < m) {
      int* row = buf + lane * vx::STATE_WORDS;
      b = ROUND0 ? i : __ldg(idx_in + i);  // the ray's index in the batch
      const vx::RayOf ray = {origins, os, rays, rs, b};
      vx::TraceResult r;
      st = ROUND0 ? vx::slab_round_rays(P, F, ray, row, r)
                  : vx::slab_round(P, F, row, nullptr, nullptr, 0, nullptr, row, r);
      if (st == vx::SLAB_DONE) {
        hit[b] = r.flags & 1;
        vx::store_ray(r, b, pos, normal, steps);
      }
    }
    if (ROUND0) {
      const unsigned owned = __ballot_sync(0xffffffffu, st != vx::SLAB_OTHER);
      if (lane == 0 && owned) atomicAdd(counters + 2, __popc(owned));
    }
    __syncwarp();  // the packed rows visible to the whole warp
    const unsigned paused = __ballot_sync(0xffffffffu, st == vx::SLAB_PAUSED);
    if (paused) {
      int slot = 0;
      if (lane == 0) slot = atomicAdd(counters + 1, __popc(paused));
      slot = __shfl_sync(0xffffffffu, slot, 0);
      if (st == vx::SLAB_PAUSED) idx_out[slot + __popc(paused & ((1u << lane) - 1u))] = b;
      // the paused rows, one after another, each written by the whole warp
      for (unsigned p = paused; p; p &= p - 1, ++slot) {
        const int* src = buf + (__ffs(p) - 1) * vx::STATE_WORDS;
        int* dst = rows_out + (long long)slot * vx::STATE_WORDS;
        for (int w = lane; w < vx::STATE_WORDS; w += 32) dst[w] = src[w];
      }
    }
    __syncwarp();
  }
}

// The persistent grid of `kernel` for m rays.
template <class Kernel>
cudaError_t slab_grid(vx::GridCache& cache, Kernel kernel, int m, int* blocks) {
  int sms = 0, per_sm = 0;
  const cudaError_t e = vx::resident_blocks(cache, kernel, THREADS, ROW_BYTES, &sms, &per_sm);
  if (e != cudaSuccess) return e;
  // as many blocks as the card holds at once, and no more than the rays'
  // batches of 32 need; a round of few batches takes a block for each, up
  // to one an SM, so that its warps spread over the SMs instead of sharing
  // one or two (a warp that finds no batch leaves at once)
  const long long warps = ((long long)m + 31) / 32;
  const long long full = (warps + WARPS - 1) / WARPS, spread = warps < sms ? warps : sms;
  const long long wanted = full > spread ? full : spread;
  *blocks = (int)(wanted < (long long)per_sm * sms ? wanted : (long long)per_sm * sms);
  return cudaSuccess;
}

}  // namespace

// The batch form; launches on `stream` without synchronising and returns
// the first CUDA error.  origins and rays: the whole batch's (f32[n, 3] at
// row strides os and rs, 3 or 0).  Round 0: rows_in and idx_in null, m =
// n; later rounds: rows_in (i32[m, STATE_WORDS]) and idx_in (i32[m], each
// row's batch index).  counters: three ints of device scratch, zeroed here
// on `stream`; after the launch [1] holds the paused rays and [2] (round
// 0) the rays the slab owned.  Appends each paused ray's row to rows_out
// and its batch index to idx_out (room for m each); writes each done ray's
// hit (i32, 0 or 1), position, normal and steps at its batch index of the
// batch-wide outputs, and nothing for the other rays.
extern "C" int vx_zslab_rays(const float* origins, int os, const float* rays, int rs, const int* rows_in,
                             const int* idx_in, const int* meta, const int* bricks, int m, int gx, int gy, int gz,
                             int z0, int slab_gz, int factor, int wpb, int max_steps, int brick_layout,
                             int iter_limit, int* counters, int* rows_out, int* idx_out, int* hit, float* pos,
                             float* normal, int* steps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counters, 0, 3 * sizeof(int), s);
  if (e != cudaSuccess || m == 0) return static_cast<int>(e);
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::SlabFetch F = {meta, bricks, gx, gy, z0, slab_gz, wpb};
  static vx::GridCache cache0, cache1;
  int blocks = 0;
  if (rows_in == nullptr) {
    e = slab_grid(cache0, zslab_rays_kernel<true>, m, &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    zslab_rays_kernel<true><<<blocks, THREADS, ROW_BYTES, s>>>(P, F, m, counters, origins, os, rays, rs, nullptr,
                                                               nullptr, rows_out, idx_out, hit, pos, normal, steps);
  } else {
    e = slab_grid(cache1, zslab_rays_kernel<false>, m, &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    zslab_rays_kernel<false><<<blocks, THREADS, ROW_BYTES, s>>>(P, F, m, counters, origins, os, rays, rs, rows_in,
                                                                idx_in, rows_out, idx_out, hit, pos, normal, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
