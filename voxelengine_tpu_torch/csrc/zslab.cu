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
// One thread a ray, 128-thread blocks, over the rays the rank owns this
// round (the wrapper gathers them): round 0 starts rays from K4's ray setup,
// later rounds resume handed-on states.  What bounds it: as K4, the
// dependent chain of each iteration (address, one load, bit test, advance)
// against the DDA events of the round's rays; its bytes are the rays' state
// rows, 140 B in and out a ray, and the result.  A first, simple kernel: no
// shared-memory meta and no work queue (K4 has both).
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "zslab.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
zslab_kernel(vx::TraceParams P, vx::SlabFetch F, int m, const float* __restrict__ start,
             const float* __restrict__ dir, const int* __restrict__ active, const int* __restrict__ pad,
             const int* __restrict__ rows_in, int* __restrict__ rows_out, int* __restrict__ status,
             int* __restrict__ flags, float* __restrict__ pos, float* __restrict__ normal,
             int* __restrict__ steps) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  vx::TraceResult r;
  const long long w = (long long)i * vx::STATE_WORDS;
  status[i] = rows_in != nullptr
      ? vx::slab_round(P, F, rows_in + w, nullptr, nullptr, 0, nullptr, rows_out + w, r)
      : vx::slab_round(P, F, nullptr, start + 3 * i, dir + 3 * i, active[i], pad + 3 * i, rows_out + w, r);
  flags[i] = r.flags;
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

}  // namespace

// Launches on `stream` without synchronising; returns the first CUDA error.
// Round 0: start, dir (f32[m, 3]), active (i32[m]) and pad (i32[m, 3]) from
// the ray setup, rows_in null; later rounds: rows_in (i32[m, STATE_WORDS]),
// the ray inputs null.  meta and bricks are the slab's (chunk rows z0 ..
// z0 + slab_gz - 1 of a LINEAR gx x gy x gz grid).  Writes rows_out (i32[m,
// STATE_WORDS]), status (SlabStatus) and, for rays that are done, flags =
// hit | hit_imm << 1, position, normal and steps.
extern "C" int vx_zslab(const float* start, const float* dir, const int* active, const int* pad,
                        const int* rows_in, const int* meta, const int* bricks, int m, int gx, int gy,
                        int gz, int z0, int slab_gz, int factor, int wpb, int max_steps, int brick_layout,
                        int iter_limit, int* rows_out, int* status, int* flags, float* pos, float* normal,
                        int* steps, void* stream) {
  if (m == 0) return 0;
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::SlabFetch F = {meta, bricks, gx, gy, z0, slab_gz, wpb};
  zslab_kernel<<<(m + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, F, m, start, dir, active, pad, rows_in, rows_out, status, flags, pos, normal, steps);
  return static_cast<int>(cudaGetLastError());
}
