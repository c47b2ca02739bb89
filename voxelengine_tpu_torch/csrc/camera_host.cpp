// Host build of camera.cuh and rays.cuh (g++ -ffp-contract=off): the camera
// kernel's per-triple logic and glibc_sincosf on the CPU, so the tests can
// hold them against the C library's sinf and cosf and against core/libm.py
// before the kernel runs on the card; and the ray-setup kernel's per-ray
// logic, held against the plain primary_rays and JAX's.
#include "camera.cuh"
#include "rays.cuh"

// camera.cu::vx_camera_basis on the host (its arguments minus the stream).
extern "C" int vx_camera_basis_host(const float* euler, int n, float* out) {
  for (int i = 0; i < n; ++i) vx::camera_basis(euler + 3LL * i, out + 9LL * i);
  return 0;
}

// glibc_sincosf of n angles.
extern "C" int vx_sincosf_host(const float* x, int n, float* s, float* c) {
  for (int i = 0; i < n; ++i) {
    const vx::SinCosF r = vx::glibc_sincosf(x[i]);
    s[i] = r.s;
    c[i] = r.c;
  }
  return 0;
}

namespace {

// rays.cu's per-block camera, once for all rays; its basis where asked.
vx::RayCamera host_camera(const float* euler, const float* origin, const float* window, int width, int height,
                          int ortho, float a, float b, float* basis) {
  vx::RayCamera cam;
  vx::ray_camera(euler, origin, window, a, b, width, height, ortho, &cam);
  if (basis) {
    for (int k = 0; k < 3; ++k) {
      basis[k] = cam.fwd[k];
      basis[3 + k] = cam.up[k];
      basis[6 + k] = cam.right[k];
    }
  }
  return cam;
}

}  // namespace

// rays.cu::vx_rays_frame on the host (its arguments minus the stream).
extern "C" int vx_rays_frame_host(const float* euler, const float* origin, const float* window,
                                  const int64_t* block_perm, int n, int width, int height, int bw, int bh,
                                  int checkerboard, int even_frame, int ortho, float a, float b, float* basis,
                                  float* rows, int64_t* px, int64_t* py, int64_t* py_r) {
  const vx::RayCamera cam = host_camera(euler, origin, window, width, height, ortho, a, b, basis);
  for (int64_t i = 0; i < n; ++i) {
    vx::frame_pixel(i, width, bw, bh, block_perm, px + i, py_r + i);
    py[i] = vx::remap_row(px[i], py_r[i], checkerboard, even_frame);
    vx::pixel_ray(cam, px[i], py[i], rows + 3 * i);
  }
  return 0;
}

// rays.cu::vx_rays_pixels on the host (its arguments minus the stream).
extern "C" int vx_rays_pixels_host(const float* euler, const float* origin, const float* window, const int64_t* px,
                                   const int64_t* py_r, int n, int width, int height, int checkerboard,
                                   int even_frame, int ortho, float a, float b, float* basis, float* rows,
                                   int64_t* py) {
  const vx::RayCamera cam = host_camera(euler, origin, window, width, height, ortho, a, b, basis);
  for (int64_t i = 0; i < n; ++i) {
    py[i] = vx::remap_row(px[i], py_r[i], checkerboard, even_frame);
    vx::pixel_ray(cam, px[i], py[i], rows + 3 * i);
  }
  return 0;
}
