// Host build of camera.cuh (g++ -ffp-contract=off): the camera kernel's
// per-triple logic and glibc_sincosf on the CPU, so the tests can hold them
// against the C library's sinf and cosf and against core/libm.py before the
// kernel runs on the card.
#include "camera.cuh"

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
