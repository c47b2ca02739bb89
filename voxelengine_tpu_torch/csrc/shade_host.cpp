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
extern "C" int vx_shade_composite_host(VX_SHADE_PARAMS, int tw, int th, int tiles_x, int ranks, int rank, float* fb) {
  const vx::ShadeArgs A = VX_SHADE_ARGS;
  const vx::FrameDest D = {tw, th, tiles_x, ranks, rank};
  for (int i = 0; i < n; ++i) vx::shade_to_dest(A, D, i, fb);
  return 0;
}
