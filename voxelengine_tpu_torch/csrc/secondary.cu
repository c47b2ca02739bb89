// The shading's secondary rays around a caller's tracer, for Hopper
// (sm_90a): one launch that builds a kind's rays, and for AO one that
// reduces what the tracer returns for its samples.
//
// No TPU kernel: the JAX package builds these rays and reduces AO with XLA
// ops around its tracer in the jitted frame (voxelengine_tpu/render/
// frame.py:245-293, 378-420; the z-sharded frame passes its own tracer,
// voxelengine_tpu/parallel/distributed.py:190-243).  K1's and K4's
// secondary entries build, walk and reduce in one launch over one device's
// world; a world sharded over ranks walks through a tracer that takes rays
// and runs collectives (parallel/distributed.py), so its frame builds the
// rays here, calls the tracer once a kind (AO's samples as one batch) and
// reduces AO here (a shadow's or a reflection's results are the tracer's
// own).  The per-ray code is secondary.cuh's (secondary_build_ray,
// secondary_ao), the fused entries' own builders and falloff.  The
// plain versions are ops/secondary.py::secondary_rays_plain and
// secondary_reduce_plain.
//
// What bounds it: bytes.  The build reads a primary ray's position (12 B),
// normal (12 B) where the kind reads it, the reflection's direction and
// AO's pixel (16 B) and writes each built ray's origin and direction (24
// B); AO's reduce reads the tracer's hit (1 B) and position (12 B) of each
// sample and writes one f32 a pixel.  AO's ~40 float ops and one
// hash a sample are far below that.  One thread a ray, 256 a block, no
// shared memory: a plain elementwise pass.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "secondary.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    build_kernel(int kind, vx::SecondaryArgs A, int n, long long m, float* __restrict__ origins,
                 float* __restrict__ dirs) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  vx::secondary_build_ray(kind, A, n, j, origins + 3 * j, dirs + 3 * j);
}

__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ pos, int ao_samples, const unsigned char* __restrict__ t_hit,
                  const float* __restrict__ t_pos, int n, float* __restrict__ ao) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) ao[i] = vx::secondary_ao(pos, ao_samples, t_hit, t_pos, n, i);
}

int blocks_of(long long m) { return (int)((m + kThreads - 1) / kThreads); }

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (1, cudaErrorInvalidValue, for an unknown kind or an AO launch without
// samples).  Writes the kind's M rays (secondary.cuh::secondary_build_ray's
// order): origins and raw directions, f32[M, 3] each.
extern "C" int vx_secondary_build(VX_SECONDARY_PARAMS, int n, float* origins, float* out_dirs, void* stream) {
  if (kind < vx::SEC_SHADOW || kind > vx::SEC_AO || (kind == vx::SEC_AO && ao_samples < 1)) return 1;
  const long long m = kind == vx::SEC_AO ? (long long)n * ao_samples : n;
  if (m == 0) return 0;
  build_kernel<<<blocks_of(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(kind, VX_SECONDARY_IN_ARGS, n, m,
                                                                                 origins, out_dirs);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (1 without samples).  pos is the primary trace's position, t_hit and
// t_pos the tracer's results for the M = n * ao_samples AO rays of
// vx_secondary_build; writes the AO factor ao (f32[n]).
extern "C" int vx_secondary_reduce(const float* pos, int ao_samples, int n, const unsigned char* t_hit,
                                   const float* t_pos, float* ao, void* stream) {
  if (ao_samples < 1) return 1;
  if (n == 0) return 0;
  reduce_kernel<<<blocks_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(pos, ao_samples, t_hit, t_pos, n,
                                                                                 ao);
  return static_cast<int>(cudaGetLastError());
}
