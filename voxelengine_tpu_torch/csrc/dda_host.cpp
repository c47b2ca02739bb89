// Host build of dda.cuh: the Hopper kernel's per-ray step logic compiled
// by a C++ compiler (-ffp-contract=off), so the CPU tests can hold it
// against the plain torch trace before the kernel ever runs on the card.
#include "dda.cuh"

extern "C" int vx_trace_host(const float* start, const float* dir, const int* active,
                             const int* pad, const int* region_lines, const int* brick_lines,
                             int n, int gx, int gy, int gz, int rx, int ry, int rz, int factor,
                             int wpb, int max_steps, int brick_layout, int iter_limit,
                             int* flags, float* pos, float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, rx, ry, rz, factor, wpb, max_steps, brick_layout,
                             iter_limit};
  for (int i = 0; i < n; ++i) {
    const vx::TraceResult r = vx::trace_ray(
        P, region_lines, brick_lines,
        start[3 * i], start[3 * i + 1], start[3 * i + 2],
        dir[3 * i], dir[3 * i + 1], dir[3 * i + 2],
        active[i], pad[3 * i], pad[3 * i + 1], pad[3 * i + 2]);
    flags[i] = r.flags;
    pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
    normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
    steps[i] = r.steps;
  }
  return 0;
}
