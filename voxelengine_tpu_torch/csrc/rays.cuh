// A frame's primary ray of one stream index: render/frame.py::
// primary_rays_plain ray by ray, __host__ __device__ (dda.cuh's VX_HD) so
// that g++ builds the same source into camera_host.cpp for the CPU tests.
//
// Every float op rounds as the plain torch version rounds it (nvcc
// --fmad=false, g++ -ffp-contract=off; kernels/build.py), in its order:
//   - u = float(px) / W and v = float(py) / H, IEEE divisions
//     (core/exact.py::fdiv);
//   - perspective (render/camera.py::ray_direction): ux = u * 2 - 1,
//     d = (fwd + (ux * scale_x) * right) + (vy * scale_y) * up, divided by
//     the float64 root of (dx*dx + dy*dy) + dz*dz rounded once to float
//     (core/exact.py::sqrt_rn, dot3);
//   - orthographic (render/camera.py::ray_origin_ortho): the origin
//     (origin + right * (((u * 2 - 1) * sx) * ratio)) + up * ((v * 2 - 1) * sy),
//     the direction fwd.
// The basis is camera.cuh's, glibc's sincosf as the reference's XLA:CPU.
#pragma once

#include <math.h>
#include <stdint.h>

#include "camera.cuh"

namespace vx {

// What a frame's rays share: the basis and the origin (read from the
// card's tensors) and the projection's constants.
struct RayCamera {
  float fwd[3], up[3], right[3], origin[3];
  float a, b;   // perspective: scale_x, scale_y; orthographic: the window's sx, sy
  float ratio;  // orthographic: float(W) / float(H)
  int width, height, ortho;
};

// The frame's RayCamera from Euler angles (pitch, yaw, roll) and the
// origin; an orthographic window from `window` (f32[2]) where given, else
// from (a, b).
VX_HD void ray_camera(const float* euler, const float* origin, const float* window, float a, float b, int width,
                      int height, int ortho, RayCamera* c) {
  float basis[9];
  camera_basis(euler, basis);
  for (int k = 0; k < 3; ++k) {
    c->fwd[k] = basis[k];
    c->up[k] = basis[3 + k];
    c->right[k] = basis[6 + k];
    c->origin[k] = origin[k];
  }
  c->a = window ? window[0] : a;
  c->b = window ? window[1] : b;
  c->ratio = (float)width / (float)height;
  c->width = width;
  c->height = height;
  c->ortho = ortho;
}

// Stream index i -> (px, pre-remap row py_r): blocks of bw x bh pixels,
// bw-wide rows within a block, blocks in row-major order, stream block b
// holding block block_perm[b] where given (render/frame.py's tile order).
// bw = W, bh = 1 is the row-major order of an untiled frame.
VX_HD void frame_pixel(int64_t i, int width, int bw, int bh, const int64_t* block_perm, int64_t* px,
                       int64_t* py_r) {
  const int64_t area = (int64_t)bw * bh;
  int64_t blk = i / area;
  const int64_t k = i - blk * area;
  if (block_perm) blk = block_perm[blk];
  const int64_t across = width / bw;
  const int64_t brow = blk / across;
  *py_r = brow * bh + k / bw;
  *px = (blk - brow * across) * bw + k % bw;
}

// The checkerboard remap y = 2 y' + (x even) + (frame even)
// (Renderer.cu:186-196); it may give H, the dropped row of an odd height.
VX_HD int64_t remap_row(int64_t px, int64_t py_r, int checkerboard, int even_frame) {
  return checkerboard ? py_r * 2 + (px % 2 == 0 ? 1 : 0) + even_frame : py_r;
}

// The ray of pixel (px, py): out = its direction (perspective) or its
// origin (orthographic).
VX_HD void pixel_ray(const RayCamera& c, int64_t px, int64_t py, float* out) {
  const float u = (float)px / (float)c.width, v = (float)py / (float)c.height;
  const float ux = u * 2.0f - 1.0f, vy = v * 2.0f - 1.0f;
  if (c.ortho) {
    const float s = ux * c.a * c.ratio, t = vy * c.b;
    for (int k = 0; k < 3; ++k) out[k] = (c.origin[k] + c.right[k] * s) + c.up[k] * t;
    return;
  }
  const float s = ux * c.a, t = vy * c.b;
  float d[3];
  for (int k = 0; k < 3; ++k) d[k] = (c.fwd[k] + s * c.right[k]) + t * c.up[k];
  const float n = (float)sqrt((double)((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]));
  for (int k = 0; k < 3; ++k) out[k] = d[k] / n;
}

}  // namespace vx
