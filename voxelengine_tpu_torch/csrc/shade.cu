// A frame's shading and composite for Hopper (sm_90a): render/frame.py::
// shade_traced after its traces, one thread a ray (csrc/shade.cuh), and in
// the composite entry render/frame.py::composite_frame too.
//
// It has no TPU kernel to replace: the JAX package shades and composites
// with XLA ops inside its jitted frame (voxelengine_tpu/render/
// frame.py:350-470 and :114-169, render/shading.py:28-59), which XLA fuses.
// The port's eager version launched ~76 kernels a primary frame and most of
// an app frame's ~1,165.  Its plain version is that eager body
// (shade_traced_plain, composite_frame), which the CPU runs.
//
// What bounds it: bytes.  A ray reads its trace (hit, position, normal,
// steps: 29 B), its direction (12 B unless one row is shared), its pixel
// (24 B of int64) and writes 13 B (color, write) or its pixel's 12 B; the
// shading is ~100 float ops, far below that.
//
// Two entries over one kernel:
//   vx_shade writes color (f32[n, 3]) and write (one byte): the sharded
//     frames' form, whose halo rows pair with the band's
//     (parallel/sharded.py);
//   vx_shade_composite scatters each written pixel straight into the
//     framebuffer at (px, py) and drops py >= H.  The checkerboard's pair
//     select and its odd-height drop (composite_frame) are exactly that
//     scatter: y = 2y' + (x even) + (frame even) maps the frame's rays one
//     to one onto the rows it writes, so no two rays write one pixel, and
//     a ray's pixel needs no unblocking and no block_perm inverse.
// The environment vectors and the camera position are read on the card
// (one host read a frame would synchronise the stream).  The shadow,
// reflection and AO results are optional inputs (null: not traced), so an
// app frame's shading after its secondary traces is one launch too.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "shade.cuh"

namespace {

constexpr int kThreads = 256;

// COMPOSITE: write the framebuffer (f32[H, W, 3]); otherwise color and write.
template <bool COMPOSITE>
__global__ void __launch_bounds__(kThreads)
    shade_kernel(vx::ShadeArgs A, int n, float* __restrict__ color, unsigned char* __restrict__ write,
                 float* __restrict__ fb) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float c[3];
  bool w;
  vx::shade_ray(A, i, c, &w);
  if (COMPOSITE) {
    const int64_t px = A.px[i], py = A.py[i];
    if (w && py >= 0 && py < A.height) {
      float* p = fb + 3 * (py * A.width + px);
      p[0] = c[0]; p[1] = c[1]; p[2] = c[2];
    }
  } else {
    color[3 * i] = c[0]; color[3 * i + 1] = c[1]; color[3 * i + 2] = c[2];
    write[i] = w;
  }
}

template <bool COMPOSITE>
int launch(const vx::ShadeArgs& A, int n, float* color, unsigned char* write, float* fb, void* stream) {
  if (n == 0) return 0;
  shade_kernel<COMPOSITE><<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, n, color, write, fb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// color f32[n, 3], write one byte a ray (0 or 1).
extern "C" int vx_shade(VX_SHADE_PARAMS, float* color, unsigned char* write, void* stream) {
  return launch<false>(VX_SHADE_ARGS, n, color, write, nullptr, stream);
}

// The same rays shaded into fb (f32[height, width, 3]) in place: each
// written pixel at (px, py), py >= height dropped.
extern "C" int vx_shade_composite(VX_SHADE_PARAMS, float* fb, void* stream) {
  return launch<true>(VX_SHADE_ARGS, n, nullptr, nullptr, fb, stream);
}
