// Host build of shade.cuh (g++ -ffp-contract=off): the shading kernel's
// per-ray logic on the CPU, so the tests can hold it against the plain
// shade_traced and composite_frame and against JAX's frames before the
// kernel runs on the card.  Each entry takes its launcher's arguments
// (shade.cu) minus the stream.
#include "shade.cuh"

// shade.cu::vx_shade on the host.
extern "C" int vx_shade_host(VX_SHADE_PARAMS, float* color, unsigned char* write) {
  const vx::ShadeArgs A = VX_SHADE_ARGS;
  for (int i = 0; i < n; ++i) {
    bool w;
    vx::shade_ray(A, i, color + 3 * i, &w);
    write[i] = w;
  }
  return 0;
}

// shade.cu::vx_shade_composite on the host.
extern "C" int vx_shade_composite_host(VX_SHADE_PARAMS, float* fb) {
  const vx::ShadeArgs A = VX_SHADE_ARGS;
  for (int i = 0; i < n; ++i) {
    float c[3];
    bool w;
    vx::shade_ray(A, i, c, &w);
    if (w && A.py[i] >= 0 && A.py[i] < height) {
      float* p = fb + 3 * (A.py[i] * width + A.px[i]);
      p[0] = c[0]; p[1] = c[1]; p[2] = c[2];
    }
  }
  return 0;
}
