// The record instantiation of K1's loop for Hopper (sm_90a): the crossing
// dump (crossings.cuh) of each selected ray.
//
// Replaces, as a diagnostic, voxelengine_tpu/ops/crossing_trace.py::
// trace_ray_crossings (:67), which scans the TPU kernel's loop body
// (pallas_bigtrace.py:753, _trace_inner, diag build) over one ray.  One
// thread a ray, each writing its own [max_rows, C_FIELDS] block of rows and
// K1's result for the ray; the walk is dda.cuh's, built with the DIAG
// counters and the same flags as K1 (bigtrace.cu), so the rows are K1's
// events.  A handful of rays a call: what bounds it is the bytes of the
// rows it writes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC  (kernels/build.py).
#include <cuda_runtime.h>

#include "crossings.cuh"

namespace {

constexpr int THREADS = 32;

template <bool MACRO>
__global__ void crossings_kernel(vx::TraceParams P, vx::LineTableFetch F, int n,
                                 const float* __restrict__ start, const float* __restrict__ dir,
                                 const int* __restrict__ active, const int* __restrict__ pad,
                                 int max_rows, int* __restrict__ rows, int* __restrict__ nrows,
                                 int* __restrict__ flags, float* __restrict__ pos,
                                 float* __restrict__ normal, int* __restrict__ steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  vx::TraceResult r;
  nrows[i] = vx::record_crossings<MACRO>(
      P, F, start[3 * i], start[3 * i + 1], start[3 * i + 2], dir[3 * i], dir[3 * i + 1],
      dir[3 * i + 2], active[i], pad[3 * i], pad[3 * i + 1], pad[3 * i + 2], max_rows,
      rows + (long long)i * max_rows * vx::C_FIELDS, &r);
  flags[i] = r.flags;
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// rows is int32[n, max_rows, C_FIELDS], nrows int32[n]; the outputs as K1's.
extern "C" int vx_trace_crossings(const float* start, const float* dir, const int* active,
                                  const int* pad, const int* region_lines,
                                  const int* brick_lines, const int* macro, const int* macro2,
                                  int n, int gx, int gy, int gz, int rx, int ry, int rz,
                                  int factor, int wpb, int max_steps, int brick_layout,
                                  int iter_limit, int use_macro, int max_rows, int* rows,
                                  int* nrows, int* flags, float* pos, float* normal, int* steps,
                                  void* stream) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + THREADS - 1) / THREADS;
  if (use_macro)
    crossings_kernel<true><<<blocks, THREADS, 0, s>>>(P, F, n, start, dir, active, pad, max_rows,
                                                      rows, nrows, flags, pos, normal, steps);
  else
    crossings_kernel<false><<<blocks, THREADS, 0, s>>>(P, F, n, start, dir, active, pad, max_rows,
                                                       rows, nrows, flags, pos, normal, steps);
  return static_cast<int>(cudaGetLastError());
}
