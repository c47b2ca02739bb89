// The camera basis for Hopper (sm_90a): render/camera.py::get_directions,
// one thread an Euler triple, with glibc's sinf and cosf (camera.cuh).
//
// It has no TPU kernel to replace: the JAX package computes the basis with
// jnp.sin and jnp.cos inside its jitted frame (voxelengine_tpu/render/
// camera.py:19-34), which on XLA:CPU are glibc's sinf and cosf.  The
// port's eager frame would otherwise spend ~15 launches on the basis, and
// CUDA's own sinf and cosf are not glibc's.  Its plain version is
// core/libm.py's torch route (render/camera.py::basis_plain), which the CPU
// runs.  A frame passes one triple (the Euler angles stay on the card, so
// the host never reads them).
//
// What bounds it: launch latency.  A frame's call is one thread's ~100
// double ops and 48 bytes.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math;
// the fused steps are camera.cuh's explicit fma calls).
#include <cuda_runtime.h>

#include "camera.cuh"

__global__ void camera_basis_kernel(const float* __restrict__ euler, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) vx::camera_basis(euler + 3LL * i, out + 9LL * i);
}

// euler f32[n, 3] (pitch, yaw, roll) -> out f32[n, 9] (-forward, -up, right).
extern "C" int vx_camera_basis(const float* euler, int n, float* out, void* stream) {
  if (n == 0) return 0;
  camera_basis_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(euler, n, out);
  return static_cast<int>(cudaGetLastError());
}
