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
// measured no faster: PERF.md).  State rows move a warp at a time: the 32
// rows of a warp's rays are 4,480 contiguous bytes, which the warp reads
// and writes with 16-byte accesses through a buffer in shared memory (a
// lane's row at a stride of 35 words, so the lanes' rows fall in distinct
// banks), not with 35 strided 4-byte accesses a lane.  Only a paused ray's
// row is written (the 16-byte pieces that touch one); a ray that is done
// leaves its row unwritten.  The pause is asked only where its answer can
// change (zslab.cuh::slab_walk).
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

// buf's rows back to dst, only the pieces that touch a row whose bit is set
// in `paused` (a 16-byte piece spans at most two rows).
__device__ __forceinline__ void store_rows(const int* buf, int rows, unsigned paused, int* dst, int lane) {
  const int words = rows * vx::STATE_WORDS;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    head = words & ~3;
    const int4* b4 = reinterpret_cast<const int4*>(buf);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int q = lane; q < head / 4; q += 32) {
      const unsigned touched = (1u << ((4 * q) / vx::STATE_WORDS)) | (1u << ((4 * q + 3) / vx::STATE_WORDS));
      if (paused & touched) d4[q] = b4[q];
    }
  }
  for (int w = head + lane; w < words; w += 32)
    if ((paused >> (w / vx::STATE_WORDS)) & 1) dst[w] = buf[w];
}

__global__ void __launch_bounds__(THREADS, 1)
zslab_kernel(vx::TraceParams P, vx::SlabFetch F, int m, int* __restrict__ counter,
             const float* __restrict__ start, const float* __restrict__ dir, const int* __restrict__ active,
             const int* __restrict__ pad, const int* __restrict__ rows_in, int* __restrict__ rows_out,
             int* __restrict__ status, int* __restrict__ flags, float* __restrict__ pos,
             float* __restrict__ normal, int* __restrict__ steps) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* buf = reinterpret_cast<int*>(smem) + warp * ROW_WORDS;  // this warp's rows
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= m) return;  // the same for every lane of the warp
    const int rows = min(32, m - base);
    const int i = base + lane;
    const long long w0 = (long long)base * vx::STATE_WORDS;
    if (rows_in != nullptr) load_rows(rows_in + w0, rows, buf, lane);
    __syncwarp();
    int st = vx::SLAB_DONE;
    vx::TraceResult r = {0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
    if (i < m) {
      int* row = buf + lane * vx::STATE_WORDS;
      st = rows_in != nullptr
          ? vx::slab_round(P, F, row, nullptr, nullptr, 0, nullptr, row, r)
          : vx::slab_round(P, F, nullptr, start + 3 * i, dir + 3 * i, active[i], pad + 3 * i, row, r);
      status[i] = st;
      flags[i] = r.flags;
      pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
      normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
      steps[i] = r.steps;
    }
    __syncwarp();  // the packed rows visible to the whole warp
    const unsigned paused = __ballot_sync(0xffffffffu, st == vx::SLAB_PAUSED);
    if (paused) store_rows(buf, rows, paused, rows_out + w0, lane);
    __syncwarp();
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns the first CUDA error.
// Round 0: start, dir (f32[m, 3]), active (i32[m]) and pad (i32[m, 3]) from
// the ray setup, rows_in null; later rounds: rows_in (i32[m, STATE_WORDS]),
// the ray inputs null.  meta and bricks are the slab's (chunk rows z0 ..
// z0 + slab_gz - 1 of a LINEAR gx x gy x gz grid); counter one int of
// device scratch, zeroed here on `stream`.  Writes status (SlabStatus),
// rows_out (i32[m, STATE_WORDS]) for the paused rays only and, for rays
// that are done, flags = hit | hit_imm << 1, position, normal and steps.
extern "C" int vx_zslab(const float* start, const float* dir, const int* active, const int* pad,
                        const int* rows_in, const int* meta, const int* bricks, int m, int gx, int gy, int gz,
                        int z0, int slab_gz, int factor, int wpb, int max_steps, int brick_layout, int iter_limit,
                        int* counter, int* rows_out, int* status, int* flags, float* pos, float* normal,
                        int* steps, void* stream) {
  if (m == 0) return 0;
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::SlabFetch F = {meta, bricks, gx, gy, z0, slab_gz, wpb};
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = ROW_BYTES;
  static vx::GridCache cache;  // the runtime asked once a process (grid_cache.cuh)
  int sms = 0, per_sm = 0;
  cudaError_t e = vx::resident_blocks(cache, zslab_kernel, THREADS, smem, &sms, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as the card holds at once, and no more than the rays'
  // batches of 32 need; a round of few batches takes a block for each, up
  // to one an SM, so that its warps spread over the SMs instead of sharing
  // one or two (a warp that finds no batch leaves at once)
  const long long warps = ((long long)m + 31) / 32;
  const long long full = (warps + WARPS - 1) / WARPS, spread = warps < sms ? warps : sms;
  const long long wanted = full > spread ? full : spread;
  const int blocks = (int)(wanted < (long long)per_sm * sms ? wanted : (long long)per_sm * sms);
  e = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  zslab_kernel<<<blocks, THREADS, smem, s>>>(P, F, m, counter, start, dir, active, pad, rows_in, rows_out, status,
                                             flags, pos, normal, steps);
  return static_cast<int>(cudaGetLastError());
}
