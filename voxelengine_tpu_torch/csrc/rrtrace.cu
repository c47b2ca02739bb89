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
// ray rows in flight and refills a finished row from a queue at once.  On
// this card a K1 block likewise holds its SM slot until its slowest warp is
// done.  The counterpart here: the grid is sized to what the card holds at
// once (occupancy x SMs); each warp takes the next `batch` rays from a
// global work counter (lane 0 atomicAdd, broadcast by __shfl_sync), traces
// them with dda.cuh::trace_ray, writes the results and takes the next batch
// until the queue is empty, so a finished warp is refilled at once.  None
// of the TPU mechanism (line cache, DMA rounds, rows_inflight, num_slots,
// inner_steps, dma_per_round, shortlist) is carried over.  The counter is
// zeroed on the launch's stream before every launch.
//
// Bound: as K1 (bigtrace.cu): each iteration's dependent chain and the
// warps' divergence, with the same loop (dda.cuh) and register budget; the
// queue costs one atomic per batch.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "dda.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;  // as K1's production builds: at most 64 registers a thread

template <bool MACRO>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rrtrace_kernel(vx::TraceParams P, vx::LineTableFetch F, int n, int batch,
               int* __restrict__ counter,
               const float* __restrict__ start, const float* __restrict__ dir,
               const int* __restrict__ active, const int* __restrict__ pad,
               int* __restrict__ flags, float* __restrict__ pos,
               float* __restrict__ normal, int* __restrict__ steps) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, batch);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) return;  // the same for every lane of the warp
    const int end = n - base < batch ? n : base + batch;
    for (int i = base + lane; i < end; i += 32) {
      const vx::TraceResult r = vx::trace_ray<MACRO, false>(
          P, F, start[3 * i], start[3 * i + 1], start[3 * i + 2],
          dir[3 * i], dir[3 * i + 1], dir[3 * i + 2],
          active[i], pad[3 * i], pad[3 * i + 1], pad[3 * i + 2]);
      flags[i] = r.flags;
      pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
      normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
      steps[i] = r.steps;
    }
  }
}

template <bool MACRO>
int launch(const vx::TraceParams& P, const vx::LineTableFetch& F, int n, int batch,
           int* counter, const float* start, const float* dir, const int* active,
           const int* pad, int* flags, float* pos, float* normal, int* steps,
           cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rrtrace_kernel<MACRO>, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as the card holds at once, and no more warps than batches
  const long long batches = ((long long)n + batch - 1) / batch;
  const long long warps = (long long)(per_sm > 0 ? per_sm : 1) * sms * (THREADS / 32);
  const int blocks = (int)(((warps < batches ? warps : batches) + THREADS / 32 - 1) / (THREADS / 32));
  e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  rrtrace_kernel<MACRO><<<blocks, THREADS, 0, stream>>>(P, F, n, batch, counter, start, dir,
                                                         active, pad, flags, pos, normal, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` without synchronising; returns the first CUDA error
// (cudaGetLastError() after the launch).  `counter` is one int of device
// scratch, zeroed here on `stream`; `batch` (rays per grab) is a positive
// multiple of 32.
extern "C" int vx_rrtrace(const float* start, const float* dir, const int* active,
                          const int* pad, const int* region_lines, const int* brick_lines,
                          const int* macro, const int* macro2, int n, int gx, int gy, int gz,
                          int rx, int ry, int rz, int factor, int wpb, int max_steps,
                          int brick_layout, int iter_limit, int use_macro, int batch,
                          int* counter, int* flags, float* pos, float* normal, int* steps,
                          void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  return use_macro
             ? launch<true>(P, F, n, batch, counter, start, dir, active, pad, flags, pos, normal, steps, s)
             : launch<false>(P, F, n, batch, counter, start, dir, active, pad, flags, pos, normal, steps, s);
}
