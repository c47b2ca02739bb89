// Persistent-threads line-table traversal for Hopper (sm_90a): K5.
//
// Replaces voxelengine_tpu/ops/pallas_bigtrace.py::_rr_kernel, the TPU
// kernel of trace_brickmap_hbm_rr, and computes its function: K1's (the
// line-table DDA, with the L1/L2/L3 macro skips when use_macro is set),
// with flags = hit | hit_imm << 1 and steps = max_steps for a ray still
// active at the iteration cap.
//
// What the TPU kernel is for: a tile of rays runs in lockstep until its
// slowest ray finishes, and path lengths are heavy-tailed, so it keeps 128-
// ray rows (its SIMD unit) in flight and refills a finished row from a queue
// at once (pallas_bigtrace.py:1685-1689,1741-1797).  On this card the unit
// that runs in lockstep is a warp's 32 lanes: a lane whose ray has ended
// idles until the warp's longest ray ends (K1's lanes are active on 0.36 of
// its warp-iterations on the sparse world, 0.73 on the demo frame; PERF.md).
// The counterpart here is one level finer than the TPU's, the persistent
// while-while loop with dynamic ray fetch of Aila and Laine, "Understanding
// the Efficiency of Ray Traversal on GPUs" (HPG 2009): each lane holds one
// ray's walk as a dda.cuh::RayState and advances it one iteration at a time
// (ray_iterate); a lane whose ray ends writes its result at once and goes
// idle; when at least `refill` lanes of the warp are idle (refill = 32: all
// of them), lane 0 takes that many rays from a global work counter with one
// atomicAdd, and each idle lane starts the next of them (ray_init).  The
// warp returns when all its lanes are idle and the queue is spent.  The grid
// is sized to what the card holds at once (occupancy x SMs); the counter is
// zeroed on the launch's stream before every launch.  None of the TPU
// mechanism (line cache, DMA rounds, rows_inflight, num_slots, inner_steps,
// dma_per_round, shortlist) is carried over.
//
// Between refills each live lane runs its own loop, as K1's lanes do, and
// leaves it when its ray ends or when __activemask shows that `refill`
// lanes are idle; a ballot of the whole warp on every iteration measured
// 4-9% slower.  Measured (PERF.md): refill 8 takes the sparse world's
// batch 15-19% faster than batches of 32 rays did (lanes active 0.36 ->
// 0.55 of the warp-iterations) and the demo frame 2-6% slower: its 14,400
// groups of 32 coherent rays come to ~3.4 a resident warp, so the drain at
// the end of the queue, as long as the longest ray a warp holds, weighs
// more than the idle lanes refill saves.  At refill 32 (the old schedule)
// the loop costs 0-8% more than batches did.  The macro build spills 16 B
// at 64 registers and measured as fast as unspilled builds at 70-72
// registers (6 or 7 blocks an SM).
//
// A counting instantiation (stats given) adds, per warp, its warp-
// iterations (passes in which a lane iterates) and the lanes that iterate in
// them, so that stats[0] / (32 * stats[1]) is the share of lane-slots doing
// work; no path runs it.
//
// The rays entry (vx_rrtrace_rays, trace_brickmap_hbm_rr's card path)
// takes origins and raw directions: a lane's refill sets its ray up
// (ray_setup.cuh::ray_init_of), and the store of a hit at the ray's start
// does the hit_imm fix-up, the setup computed again from the ray
// (ray_setup.cuh::fix_hit_imm, as trace_ray_of does); hit is one byte.
// The prepared entry (vx_rrtrace, the wrapper's setup done) stays for
// kernel_ab.py's and chip_smoke.py's walk-alone times and gates.
//
// Bound: as K1 (bigtrace.cu): each iteration's dependent chain and the
// warps' divergence, with the same loop (dda.cuh) and register budget; the
// queue costs one atomic per refill.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "ray_setup.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;  // as K1's production builds: at most 64 registers a thread
constexpr unsigned FULL = 0xffffffffu;

// Where a launch's rays come from and where their results go: the
// prepared entry's (start, dir, active, pad; flags = hit | hit_imm << 1)
// or, with RAYS, the rays entry's (origins, rays at row strides os, rs;
// hit one byte, the hit_imm fix-up done).
struct RrRays {
  const float* start;
  const float* dir;
  const int* active;
  const int* pad;
  const float* origins;
  int os;
  const float* rays;
  int rs;
  int* flags;
  unsigned char* hit;
};

template <bool MACRO, bool COUNT, bool RAYS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rrtrace_kernel(vx::TraceParams P, vx::LineTableFetch F, int n, int refill,
               int* __restrict__ counter, unsigned long long* __restrict__ stats, const RrRays R,
               float* __restrict__ pos, float* __restrict__ normal, int* __restrict__ steps) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  vx::RayState S;
  int ray = -1;        // this lane's ray; -1 while idle
  bool spent = false;  // no rays left in the queue (the same for every lane)
  unsigned long long live_lanes = 0, warp_iters = 0;
  for (;;) {
    unsigned idle = __ballot_sync(FULL, ray < 0);
    if (!spent && __popc(idle) >= refill) {
      const int k = __popc(idle);
      int base = 0;
      if (lane == 0) base = atomicAdd(counter, k);
      base = __shfl_sync(FULL, base, 0);
      spent = base + k >= n;
      if (ray < 0) {
        const int i = base + __popc(idle & below);
        if (i < n) {
          bool live;
          if constexpr (RAYS) {
            live = vx::ray_init_of(P, S, R.origins + (long long)R.os * i, R.rays + (long long)R.rs * i);
          } else {
            live = vx::ray_init(S, R.start[3 * i], R.start[3 * i + 1], R.start[3 * i + 2], R.dir[3 * i],
                                R.dir[3 * i + 1], R.dir[3 * i + 2], R.active[i], R.pad[3 * i], R.pad[3 * i + 1],
                                R.pad[3 * i + 2]);
          }
          if (live) {
            ray = i;
          } else {
            const vx::TraceResult none = {0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
            if constexpr (RAYS) R.hit[i] = 0; else R.flags[i] = 0;
            vx::store_ray(none, i, pos, normal, steps);
          }
        }
      }
      idle = __ballot_sync(FULL, ray < 0);
    }
    if (idle == FULL) {
      if (spent) break;
      continue;
    }
    // the live lanes iterate, each in its own loop, until its ray ends or
    // (while the queue has rays) `refill` lanes of the warp are idle: a
    // lane in this loop counts the others still in it (__activemask, no
    // synchronisation), so the warp meets at the ballot above only to refill
    if (ray >= 0) {
      const int busy = spent ? -1 : 32 - refill;  // the most lanes iterating that leave `refill` idle
      for (;;) {
        if constexpr (COUNT) {  // the lowest lane counts the lanes iterating together
          const unsigned active = __activemask();
          if (lane == __ffs(active) - 1) {
            live_lanes += __popc(active);
            ++warp_iters;
          }
        }
        if (vx::ray_iterate<MACRO, false>(P, F, S)) {
          vx::TraceResult r = vx::ray_result(P, S);
          if constexpr (RAYS) {
            vx::fix_hit_imm(P, vx::RayOf{R.origins, R.os, R.rays, R.rs, ray}, r);
            R.hit[ray] = (unsigned char)(r.flags & 1);
          } else {
            R.flags[ray] = r.flags;
          }
          vx::store_ray(r, ray, pos, normal, steps);
          ray = -1;
          break;
        }
        if (__popc(__activemask()) <= busy) break;
      }
    }
  }
  if constexpr (COUNT) {  // every lane is here: the warp's sums, one atomic each
    for (int off = 16; off > 0; off >>= 1) {
      live_lanes += __shfl_xor_sync(FULL, live_lanes, off);
      warp_iters += __shfl_xor_sync(FULL, warp_iters, off);
    }
    if (lane == 0) {
      atomicAdd(stats, live_lanes);
      atomicAdd(stats + 1, warp_iters);
    }
  }
}

template <bool MACRO, bool COUNT, bool RAYS>
int launch(const vx::TraceParams& P, const vx::LineTableFetch& F, int n, int refill,
           int* counter, unsigned long long* stats, const RrRays& R, float* pos, float* normal, int* steps,
           cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rrtrace_kernel<MACRO, COUNT, RAYS>, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as the card holds at once, and no more warps than 32-ray groups
  const long long groups = ((long long)n + 31) / 32;
  const long long warps = (long long)(per_sm > 0 ? per_sm : 1) * sms * (THREADS / 32);
  const int blocks = (int)(((warps < groups ? warps : groups) + THREADS / 32 - 1) / (THREADS / 32));
  e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  rrtrace_kernel<MACRO, COUNT, RAYS><<<blocks, THREADS, 0, stream>>>(P, F, n, refill, counter, stats, R, pos,
                                                                     normal, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` without synchronising; returns the first CUDA error
// (cudaGetLastError() after the launch).  `counter` is one int of device
// scratch, zeroed here on `stream`; `refill` (1-32) is the number of idle
// lanes at which a warp takes new rays; `stats` is null, or two zeroed
// uint64 that the counting instantiation adds to (lanes iterating, warp-
// iterations).
extern "C" int vx_rrtrace(const float* start, const float* dir, const int* active,
                          const int* pad, const int* region_lines, const int* brick_lines,
                          const int* macro, const int* macro2, int n, int gx, int gy, int gz,
                          int rx, int ry, int rz, int factor, int wpb, int max_steps,
                          int brick_layout, int iter_limit, int use_macro, int refill,
                          int* counter, unsigned long long* stats, int* flags, float* pos,
                          float* normal, int* steps, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const RrRays R = {start, dir, active, pad, nullptr, 0, nullptr, 0, flags, nullptr};
  const auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (refill < 1 || refill > 32) return static_cast<int>(cudaErrorInvalidValue);
#define VX_RR_LAUNCH(M, C) launch<M, C, false>(P, F, n, refill, counter, stats, R, pos, normal, steps, s)
  if (stats) return use_macro ? VX_RR_LAUNCH(true, true) : VX_RR_LAUNCH(false, true);
  return use_macro ? VX_RR_LAUNCH(true, false) : VX_RR_LAUNCH(false, false);
#undef VX_RR_LAUNCH
}

// The rays entry: origins (voxels) and raw directions at row strides os
// and rs (3, or 0 for one row shared by every ray) in place of the
// prepared rays, hit (one byte) in place of flags; no counting
// instantiation.  Otherwise as vx_rrtrace.
extern "C" int vx_rrtrace_rays(const float* origins, int os, const float* rays, int rs,
                               const int* region_lines, const int* brick_lines, const int* macro,
                               const int* macro2, int n, int gx, int gy, int gz, int rx, int ry, int rz,
                               int factor, int wpb, int max_steps, int brick_layout, int iter_limit,
                               int use_macro, int refill, int* counter, unsigned char* hit, float* pos,
                               float* normal, int* steps, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const RrRays R = {nullptr, nullptr, nullptr, nullptr, origins, os, rays, rs, nullptr, hit};
  const auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (refill < 1 || refill > 32) return static_cast<int>(cudaErrorInvalidValue);
  return use_macro ? launch<true, false, true>(P, F, n, refill, counter, nullptr, R, pos, normal, steps, s)
                   : launch<false, false, true>(P, F, n, refill, counter, nullptr, R, pos, normal, steps, s);
}
