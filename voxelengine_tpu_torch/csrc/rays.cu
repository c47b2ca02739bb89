// The frame's ray setup for Hopper (sm_90a): render/frame.py::primary_rays
// in one launch, one thread a ray (csrc/rays.cuh), the camera basis
// included.
//
// It has no TPU kernel to replace: the JAX package builds its rays with
// XLA ops inside its jitted frame (voxelengine_tpu/render/frame.py:171-220),
// which XLA fuses.  The port's eager version (primary_rays_plain: a
// meshgrid, the tile-order permute and block_perm gather, the checkerboard
// remap, two divisions, the basis, the direction and its norm) launched
// ~34 kernels a frame, at ~16 us of host time each.  Its plain version is
// that eager body, which the CPU runs.
//
// What bounds it: bytes.  A perspective ray writes 36 B (its direction,
// px, py and the pre-remap row as int64, the dtypes torch.arange gives the
// plain version); ~40 float and integer ops a ray are far below that.
// Design:
//   - plain 256-thread blocks, the grid from N alone: no device query
//     on a launch;
//   - the basis (camera.cuh's glibc sincosf, ~100 float64 ops) once a
//     block, by thread 0 into shared memory, read by the block's rays (in
//     every thread it took 0.0223 ms of device time on the bench frame
//     against 0.0185: PERF.md, PR 13);
//   - a block's 256 ray rows staged in shared memory and written as 768
//     consecutive floats, so each warp's stores are coalesced (the int64
//     outputs are already one word a thread);
//   - Euler angles, origin and an orthographic window read on the card,
//     so a drifted or zoomed camera needs no host read.
// The `frame` entry makes the pixels from the stream index (tile order,
// an optional block permutation); the `pixels` entry reads given (px, py_r)
// (parallel/sharded.py::_rays_for_pixels).
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "rays.cuh"

namespace {

constexpr int kThreads = 256;

// rows: f32[n, 3] directions (perspective) or origins (orthographic);
// basis (null, or f32[9]: fwd, up, right), written by one thread.  GIVEN:
// (px, py_r) read from px_io and py_r_io; otherwise written there.
template <bool GIVEN>
__global__ void __launch_bounds__(kThreads)
    rays_kernel(const float* __restrict__ euler, const float* __restrict__ origin, const float* __restrict__ window,
                const int64_t* __restrict__ block_perm, int n, int width, int height, int bw, int bh,
                int checkerboard, int even_frame, int ortho, float a, float b, float* __restrict__ basis,
                float* __restrict__ rows, int64_t* __restrict__ px_io, int64_t* __restrict__ py_out,
                int64_t* __restrict__ py_r_io) {
  __shared__ float stage[3 * kThreads];
  __shared__ vx::RayCamera cam;
  if (threadIdx.x == 0) vx::ray_camera(euler, origin, window, a, b, width, height, ortho, &cam);
  __syncthreads();
  if (basis && blockIdx.x == 0 && threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) {
      basis[k] = cam.fwd[k];
      basis[3 + k] = cam.up[k];
      basis[6 + k] = cam.right[k];
    }
  }
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int64_t i = first + threadIdx.x;
  if (i < n) {
    int64_t px, py_r;
    if (GIVEN) {
      px = px_io[i];
      py_r = py_r_io[i];
    } else {
      vx::frame_pixel(i, width, bw, bh, block_perm, &px, &py_r);
      px_io[i] = px;
      py_r_io[i] = py_r;
    }
    const int64_t py = vx::remap_row(px, py_r, checkerboard, even_frame);
    py_out[i] = py;
    vx::pixel_ray(cam, px, py, stage + 3 * threadIdx.x);
  }
  __syncthreads();
  const int count = 3 * (int)min((int64_t)kThreads, n - first);
  for (int j = threadIdx.x; j < count; j += kThreads) rows[3 * first + j] = stage[j];
}

}  // namespace

// euler (f32[3]), origin (f32[3]), window (null or f32[2]), block_perm (null
// or int64[blocks]); n, W, H, bw, bh (W, 1: row-major), checkerboard,
// even_frame, ortho; a, b (scale_x, scale_y, or the window without a
// tensor); basis (null or f32[9]), rows (f32[n, 3]), px, py, py_r (int64[n]).
extern "C" int vx_rays_frame(const float* euler, const float* origin, const float* window, const int64_t* block_perm,
                             int n, int width, int height, int bw, int bh, int checkerboard, int even_frame,
                             int ortho, float a, float b, float* basis, float* rows, int64_t* px, int64_t* py,
                             int64_t* py_r, void* stream) {
  if (n == 0) return 0;
  rays_kernel<false><<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      euler, origin, window, block_perm, n, width, height, bw, bh, checkerboard, even_frame, ortho, a, b, basis,
      rows, px, py, py_r);
  return static_cast<int>(cudaGetLastError());
}

// The same for given pixels: px and py_r (int64[n]) in, py out.
extern "C" int vx_rays_pixels(const float* euler, const float* origin, const float* window, const int64_t* px,
                              const int64_t* py_r, int n, int width, int height, int checkerboard, int even_frame,
                              int ortho, float a, float b, float* basis, float* rows, int64_t* py, void* stream) {
  if (n == 0) return 0;
  rays_kernel<true><<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      euler, origin, window, nullptr, n, width, height, 1, 1, checkerboard, even_frame, ortho, a, b, basis, rows,
      const_cast<int64_t*>(px), py, const_cast<int64_t*>(py_r));
  return static_cast<int>(cudaGetLastError());
}
