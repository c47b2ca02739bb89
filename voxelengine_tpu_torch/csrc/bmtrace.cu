// Brickmap traversal without a line table for Hopper (sm_90a): K4.
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
// The vx_trace_brickmap_compact_* entries are the same kernel over a
// compact brickmap (CompactFetch: the brick slot from brick_idx).  It has no TPU kernel: the
// JAX package walks a compact world without a line table in XLA
// (voxelengine_tpu/ops/trace.py:411,435, trace_brickmap and
// trace_brickmap_staged, which give the same results), and the TPU kernel
// takes dense slots only (pallas_trace2.py:335).  Its bound is K4's; a
// descend costs one more dependent load, the slot word.
//
// What bounds it on this card: the bytes of the rays (24 B in, 29 B out per
// ray) plus the table bytes the rays touch (at least the brick word and the
// meta word of each distinct hit) against the DDA work, sum(steps) events.
// Measured (PERF.md): on its 1,048,576 random rays the first build (then
// on prepared rays, 40 B in and 32 B out) ran at ~34x that bound, bound
// like K1 by each iteration's dependent chain; the same rays sorted by
// direction octant, then start chunk, ran in 0.64 of the time, so
// divergence and scattered loads are about a third of it.
//
// Design: the JAX kernel keeps both tables in VMEM; here the meta words go
// to shared memory and the bricks stay in global memory, read through the
// read-only path.  A persistent grid, sized by the occupancy calculator to
// what the card holds at once, of 1024-thread blocks (64 registers a thread,
// one block an SM, 32 warps): each block copies the world's meta words into
// dynamic shared memory once (16-byte loads where the table is aligned),
// then each warp takes 32 rays at a time from a global work counter (lane 0
// atomicAdd, broadcast by __shfl_sync) until none are left.  The counter is
// zeroed on the launch's stream before every launch.  With the loop of
// dda.cuh K4 runs 28% faster; shared-memory meta measured 2-4% faster than
// global meta on terrains of 16-224 KB of meta (L1 holds most of the meta
// words the rays touch either way).
//
// Each table form has three entries, all from origins and raw directions:
// a rays form (vx_trace_brickmap_dense_rays, vx_trace_brickmap_compact_rays:
// the ray setup and the hit_imm fix-up in the kernel,
// ray_setup.cuh::trace_ray_full), the frame path's K4: one launch a trace
// where the eager setup and fix-up (ops/trace2.py;
// pallas_trace2.py:344-356,395-405 in XLA) took ~69 more kernels.  A
// secondary form (vx_trace_brickmap_{dense,compact}_secondary): the
// shading's shadow, reflection or AO rays built from the primary trace,
// walked and reduced in the launch (secondary.cuh), as K1's.  And a record
// form (vx_trace_brickmap_{dense,compact}_record): the rays form storing
// the ray API's result record (ray_setup.cuh::OriginRaysRecord), as K1's
// vx_bigtrace_record: VoxelRaytracer3D.raytrace's card path without a
// line table, one launch a call.  The walk on prepared rays has no
// launcher: its g++ twins (dda_host.cpp::vx_trace_brickmap_{dense,compact}
// _host) hold the shared loop to the JAX package on its own inputs.  The
// grid's size is asked of the runtime once a process for each
// instantiation and shared-memory size (grid_cache.cuh), not on every
// launch.
//
// For each table form (dense slots, compact), two instantiations of one
// template, chosen by the wrapper from the meta table's size alone
// (kernels/bmtrace.py::meta_in_shared):
//   SHARED_META: meta in shared memory, for num_chunks * 4 bytes up to
//     VX_SMEM_META_LIMIT below: the 227 KB a block can have (above 48 KB by
//     cudaFuncSetAttribute), since no size up to 224 KB measured slower
//     than global meta;
//   global meta: the same kernel with meta read from global memory, for
//     larger worlds.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cstdint>

#include <cuda_runtime.h>

#include "grid_cache.cuh"
#include "ray_setup.cuh"
#include "secondary.cuh"

// Largest meta table (bytes) the SHARED_META instantiation takes; the
// wrapper's kernels/bmtrace.py::SMEM_META_LIMIT is the same number.
#define VX_SMEM_META_LIMIT (227 * 1024)

namespace {

constexpr int THREADS = 1024;  // 1024 x 64 registers: one block fills an SM's register file

// Fetch: DenseSlotFetch or CompactFetch, with meta in shared memory when
// Fetch::SHARED; Rays: vx::OriginRays, vx::OriginRaysRecord (pos, normal
// and steps: the record's hit_point, normal and steps) or
// vx::SecondaryRays (which stores its own outputs).
template <class Fetch, class Rays>
__global__ void __launch_bounds__(THREADS, 1)
bmtrace_kernel(vx::TraceParams P, Fetch F, int n, int num_chunks, int* __restrict__ counter, Rays R,
               float* __restrict__ pos, float* __restrict__ normal, int* __restrict__ steps) {
  extern __shared__ int4 smem_meta[];
  Fetch Fl = F;
  if constexpr (Fetch::SHARED) {
    int* meta = reinterpret_cast<int*>(smem_meta);
    int head = 0;  // words copied by 16-byte loads
    if ((reinterpret_cast<uintptr_t>(F.meta_words) & 15) == 0) {
      head = num_chunks & ~3;
      const int4* src = reinterpret_cast<const int4*>(F.meta_words);
      for (int i = threadIdx.x; i < head / 4; i += THREADS) smem_meta[i] = __ldg(src + i);
    }
    for (int i = head + threadIdx.x; i < num_chunks; i += THREADS) meta[i] = __ldg(F.meta_words + i);
    __syncthreads();
    Fl.meta_words = meta;
  }
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) return;  // the same for every lane of the warp
    const int i = base + lane;
    if (i < n) {
      if constexpr (Rays::SECONDARY) {
        R.template run<false>(P, Fl, i);
      } else {
        const vx::TraceResult r = R.template trace<false, false>(P, Fl, i, nullptr);
        R.store(r, i, pos, normal, steps);
      }
    }
  }
}

template <class Fetch, class Rays>
int launch(const vx::TraceParams& P, const Fetch& F, int n, int num_chunks, int* counter, const Rays& R,
           float* pos, float* normal, int* steps, cudaStream_t stream) {
  const size_t smem = Fetch::SHARED ? (size_t)num_chunks * sizeof(int) : 0;
  if (smem > VX_SMEM_META_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static vx::GridCache cache;  // one for each instantiation
  int sms = 0, per_sm = 0;
  cudaError_t e = vx::resident_blocks(cache, bmtrace_kernel<Fetch, Rays>, THREADS, smem, &sms, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as the card holds at once, and no more warps than batches of 32
  const long long warps = ((long long)n + 31) / 32;
  const long long wanted = (warps + THREADS / 32 - 1) / (THREADS / 32);
  const int blocks = (int)(wanted < (long long)per_sm * sms ? wanted : (long long)per_sm * sms);
  e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  bmtrace_kernel<Fetch, Rays><<<blocks, THREADS, smem, stream>>>(P, F, n, num_chunks, counter, R, pos,
                                                                  normal, steps);
  return static_cast<int>(cudaGetLastError());
}

// K4 over either table form in the instantiation `shared_meta` picks.
template <class Rays>
int dense(const vx::TraceParams& P, const int* meta, const int* bricks, int coarse_layout, int wpb, int n,
          int shared_meta, int* counter, const Rays& R, float* pos, float* normal, int* steps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int nc = P.gx * P.gy * P.gz;
  if (n == 0) return 0;
  if (shared_meta) {
    const vx::DenseSlotFetch<true> F = {meta, bricks, P.gx, P.gy, coarse_layout, wpb};
    return launch(P, F, n, nc, counter, R, pos, normal, steps, s);
  }
  const vx::DenseSlotFetch<false> F = {meta, bricks, P.gx, P.gy, coarse_layout, wpb};
  return launch(P, F, n, nc, counter, R, pos, normal, steps, s);
}

template <class Rays>
int compact(const vx::TraceParams& P, const int* meta, const int* brick_idx, const int* bricks,
            int coarse_layout, int wpb, int n, int shared_meta, int* counter, const Rays& R, float* pos,
            float* normal, int* steps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int nc = P.gx * P.gy * P.gz;
  if (n == 0) return 0;
  if (shared_meta) {
    const vx::CompactFetch<true> F = {{meta, bricks, P.gx, P.gy, coarse_layout, wpb}, brick_idx};
    return launch(P, F, n, nc, counter, R, pos, normal, steps, s);
  }
  const vx::CompactFetch<false> F = {{meta, bricks, P.gx, P.gy, coarse_layout, wpb}, brick_idx};
  return launch(P, F, n, nc, counter, R, pos, normal, steps, s);
}

}  // namespace

// The rays forms: origins and raw directions (f32[n, 3], row strides os
// and rs of 3, or 0 for one shared row); writes hit (one byte a ray, 0 or
// 1), position and normal after the hit_imm fix-up, and steps.  Launches on
// `stream` without synchronising; returns the first CUDA error
// (cudaGetLastError() after the launch).  `counter` is one int of device
// scratch, zeroed here on `stream`; `shared_meta` picks the instantiation
// (the wrapper's choice by table size; a table over VX_SMEM_META_LIMIT is
// refused with cudaErrorInvalidValue).  The compact form takes each chunk's
// brick slot in brick_idx (int32[num_chunks], -1 for an empty chunk) and
// bricks int32[num_bricks, wpb].
extern "C" int vx_trace_brickmap_dense_rays(const float* origins, int os, const float* rays, int rs,
                                            const int* meta, const int* bricks, int n, int gx, int gy,
                                            int gz, int factor, int wpb, int max_steps, int coarse_layout,
                                            int brick_layout, int iter_limit, int shared_meta, int* counter,
                                            unsigned char* hit, float* pos, float* normal, int* steps,
                                            void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::OriginRays R = {origins, os, rays, rs, hit};
  return dense(P, meta, bricks, coarse_layout, wpb, n, shared_meta, counter, R, pos, normal, steps, stream);
}

extern "C" int vx_trace_brickmap_compact_rays(const float* origins, int os, const float* rays, int rs,
                                              const int* meta, const int* brick_idx, const int* bricks, int n,
                                              int gx, int gy, int gz, int factor, int wpb, int max_steps,
                                              int coarse_layout, int brick_layout, int iter_limit,
                                              int shared_meta, int* counter, unsigned char* hit, float* pos,
                                              float* normal, int* steps, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::OriginRays R = {origins, os, rays, rs, hit};
  return compact(P, meta, brick_idx, bricks, coarse_layout, wpb, n, shared_meta, counter, R, pos, normal,
                 steps, stream);
}

// The record forms: as the rays forms, storing the ray API's result record
// (ray_setup.cuh::OriginRaysRecord): valid (one byte a ray, 0 or 1),
// hit_point, normal, distance, voxel_index and steps.
extern "C" int vx_trace_brickmap_dense_record(const float* origins, int os, const float* rays, int rs,
                                              const int* meta, const int* bricks, int n, int gx, int gy, int gz,
                                              int factor, int wpb, int max_steps, int coarse_layout,
                                              int brick_layout, int iter_limit, int shared_meta, int* counter,
                                              unsigned char* valid, float* hit_point, float* normal,
                                              float* distance, int* voxel_index, int* steps, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::OriginRaysRecord R = {{origins, os, rays, rs, valid}, distance, voxel_index, gx * factor, gy * factor};
  return dense(P, meta, bricks, coarse_layout, wpb, n, shared_meta, counter, R, hit_point, normal, steps, stream);
}

extern "C" int vx_trace_brickmap_compact_record(const float* origins, int os, const float* rays, int rs,
                                                const int* meta, const int* brick_idx, const int* bricks, int n,
                                                int gx, int gy, int gz, int factor, int wpb, int max_steps,
                                                int coarse_layout, int brick_layout, int iter_limit,
                                                int shared_meta, int* counter, unsigned char* valid,
                                                float* hit_point, float* normal, float* distance,
                                                int* voxel_index, int* steps, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::OriginRaysRecord R = {{origins, os, rays, rs, valid}, distance, voxel_index, gx * factor, gy * factor};
  return compact(P, meta, brick_idx, bricks, coarse_layout, wpb, n, shared_meta, counter, R, hit_point, normal,
                 steps, stream);
}

// The secondary entries: the shadow, reflection or AO rays (`kind`,
// secondary.cuh) of n primary rays built, walked and reduced in the
// launch, as bigtrace.cu::vx_bigtrace_secondary; max_steps is the kind's
// (8 for AO).  Tables, instantiation and counter as the rays forms'.
extern "C" int vx_trace_brickmap_dense_secondary(VX_SECONDARY_PARAMS, const int* meta, const int* bricks, int n,
                                                 int gx, int gy, int gz, int factor, int wpb, int max_steps,
                                                 int coarse_layout, int brick_layout, int iter_limit,
                                                 int shared_meta, int* counter, VX_SECONDARY_OUTS, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  return vx::with_secondary_kind(kind, VX_SECONDARY_ARGS, [&](const auto& R) {
    return dense(P, meta, bricks, coarse_layout, wpb, n, shared_meta, counter, R, nullptr, nullptr, nullptr,
                 stream);
  });
}

extern "C" int vx_trace_brickmap_compact_secondary(VX_SECONDARY_PARAMS, const int* meta, const int* brick_idx,
                                                   const int* bricks, int n, int gx, int gy, int gz, int factor,
                                                   int wpb, int max_steps, int coarse_layout, int brick_layout,
                                                   int iter_limit, int shared_meta, int* counter,
                                                   VX_SECONDARY_OUTS, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  return vx::with_secondary_kind(kind, VX_SECONDARY_ARGS, [&](const auto& R) {
    return compact(P, meta, brick_idx, bricks, coarse_layout, wpb, n, shared_meta, counter, R, nullptr, nullptr,
                   nullptr, stream);
  });
}
