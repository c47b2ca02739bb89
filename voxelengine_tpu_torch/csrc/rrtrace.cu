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
// One entry, vx_rrtrace_rays (trace_brickmap_hbm_rr's card path), from
// origins and raw directions: a lane's refill sets its ray up
// (ray_setup.cuh::ray_init_of), and the store of a hit at the ray's start
// does the hit_imm fix-up, the setup computed again from the ray
// (ray_setup.cuh::fix_hit_imm, as trace_ray_of does); hit is one byte.
// The schedule on prepared rays, with the share of lane-slots doing work
// counted, is the g++ twin's (dda_host.cpp::vx_rrtrace_host).
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

// Where a launch's rays come from and where their results go: origins and
// rays at row strides os, rs; hit one byte, the hit_imm fix-up done.
struct RrRays {
  const float* origins;
  int os;
  const float* rays;
  int rs;
  unsigned char* hit;
};

template <bool MACRO>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rrtrace_kernel(vx::TraceParams P, vx::LineTableFetch F, int n, int refill, int* __restrict__ counter,
               const RrRays R, float* __restrict__ pos, float* __restrict__ normal, int* __restrict__ steps) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  vx::RayState S;
  int ray = -1;        // this lane's ray; -1 while idle
  bool spent = false;  // no rays left in the queue (the same for every lane)
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
          if (vx::ray_init_of(P, S, R.origins + (long long)R.os * i, R.rays + (long long)R.rs * i)) {
            ray = i;
          } else {
            const vx::TraceResult none = {0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
            R.hit[i] = 0;
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
        if (vx::ray_iterate<MACRO, false>(P, F, S)) {
          vx::TraceResult r = vx::ray_result(P, S);
          vx::fix_hit_imm(P, vx::RayOf{R.origins, R.os, R.rays, R.rs, ray}, r);
          R.hit[ray] = (unsigned char)(r.flags & 1);
          vx::store_ray(r, ray, pos, normal, steps);
          ray = -1;
          break;
        }
        if (__popc(__activemask()) <= busy) break;
      }
    }
  }
}

template <bool MACRO>
int launch(const vx::TraceParams& P, const vx::LineTableFetch& F, int n, int refill, int* counter, const RrRays& R,
           float* pos, float* normal, int* steps, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rrtrace_kernel<MACRO>, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as the card holds at once, and no more warps than 32-ray groups
  const long long groups = ((long long)n + 31) / 32;
  const long long warps = (long long)(per_sm > 0 ? per_sm : 1) * sms * (THREADS / 32);
  const int blocks = (int)(((warps < groups ? warps : groups) + THREADS / 32 - 1) / (THREADS / 32));
  e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  rrtrace_kernel<MACRO><<<blocks, THREADS, 0, stream>>>(P, F, n, refill, counter, R, pos, normal, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rays entry: origins (voxels) and raw directions at row strides os
// and rs (3, or 0 for one row shared by every ray); writes hit (one byte a
// ray, 0 or 1), position and normal after the hit_imm fix-up, and steps.
// Launches on `stream` without synchronising; returns the first CUDA error
// (cudaGetLastError() after the launch).  `counter` is one int of device
// scratch, zeroed here on `stream`; `refill` (1-32) is the number of idle
// lanes at which a warp takes new rays.
extern "C" int vx_rrtrace_rays(const float* origins, int os, const float* rays, int rs,
                               const int* region_lines, const int* brick_lines, const int* macro,
                               const int* macro2, int n, int gx, int gy, int gz, int rx, int ry, int rz,
                               int factor, int wpb, int max_steps, int brick_layout, int iter_limit,
                               int use_macro, int refill, int* counter, unsigned char* hit, float* pos,
                               float* normal, int* steps, void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const RrRays R = {origins, os, rays, rs, hit};
  const auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (refill < 1 || refill > 32) return static_cast<int>(cudaErrorInvalidValue);
  return use_macro ? launch<true>(P, F, n, refill, counter, R, pos, normal, steps, s)
                   : launch<false>(P, F, n, refill, counter, R, pos, normal, steps, s);
}
