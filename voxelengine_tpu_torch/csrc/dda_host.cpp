// Host build of dda.cuh and grid_dda.cuh: the Hopper kernels' per-ray step
// logic compiled by a C++ compiler (-ffp-contract=off), so the CPU tests can
// hold it against the plain torch traces before the kernels ever run on the
// card.  One entry per kernel, taking its launcher's arguments minus the
// stream.
#include "dda.cuh"
#include "grid_dda.cuh"

namespace {

int flag_of(const vx::TraceResult& r) { return r.flags; }
int flag_of(const vx::GridResult& r) { return r.hit; }

// Run trace(start_i, dir_i, active_i, pad_i) for every ray and store its
// result as the kernels do.
template <class Trace>
int for_rays(int n, const float* start, const float* dir, const int* active, const int* pad,
             int* flags, float* pos, float* normal, int* steps, Trace trace) {
  for (int i = 0; i < n; ++i) {
    const auto r = trace(start + 3 * i, dir + 3 * i, active[i], pad + 3 * i);
    flags[i] = flag_of(r);
    pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
    normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
    steps[i] = r.steps;
  }
  return 0;
}

template <class Fetch>
int brickmap_rays(const vx::TraceParams& P, const Fetch& F, int n, const float* start,
                  const float* dir, const int* active, const int* pad, int* flags, float* pos,
                  float* normal, int* steps) {
  return for_rays(n, start, dir, active, pad, flags, pos, normal, steps,
                  [&](const float* s, const float* d, int a, const int* p) {
                    return vx::trace_ray(P, F, s[0], s[1], s[2], d[0], d[1], d[2], a, p[0], p[1],
                                         p[2]);
                  });
}

template <class Fetch>
int grid_rays(const vx::GridParams& P, const Fetch& F, int n, const float* start,
              const float* dir, const int* active, const int* pad, int* hit, float* pos,
              float* normal, int* steps) {
  return for_rays(n, start, dir, active, pad, hit, pos, normal, steps,
                  [&](const float* s, const float* d, int a, const int* p) {
                    return vx::trace_grid_ray(P, F, s[0], s[1], s[2], d[0], d[1], d[2], a, p[0],
                                              p[1], p[2]);
                  });
}

}  // namespace

// K1's step (bigtrace.cu::vx_bigtrace).
extern "C" int vx_trace_host(const float* start, const float* dir, const int* active,
                             const int* pad, const int* region_lines, const int* brick_lines,
                             int n, int gx, int gy, int gz, int rx, int ry, int factor,
                             int wpb, int max_steps, int brick_layout, int iter_limit,
                             int* flags, float* pos, float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, rx, ry, wpb};
  return brickmap_rays(P, F, n, start, dir, active, pad, flags, pos, normal, steps);
}

// K4's step (bmtrace.cu::vx_trace_brickmap_dense).
extern "C" int vx_trace_brickmap_dense_host(const float* start, const float* dir,
                                            const int* active, const int* pad, const int* meta,
                                            const int* bricks, int n, int gx, int gy, int gz,
                                            int factor, int wpb, int max_steps,
                                            int coarse_layout, int brick_layout, int iter_limit,
                                            int* flags, float* pos, float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::DenseSlotFetch F = {meta, bricks, gx, gy, coarse_layout, wpb};
  return brickmap_rays(P, F, n, start, dir, active, pad, flags, pos, normal, steps);
}

// K2's step (gridtrace.cu::vx_trace_grid).
extern "C" int vx_trace_grid_host(const float* start, const float* dir, const int* active,
                                  const int* pad, const int* words, int n, int X, int Y, int Z,
                                  int layout, int max_steps, int* hit, float* pos,
                                  float* normal, int* steps) {
  const vx::GridParams P = {X, Y, Z, layout, max_steps};
  return grid_rays(P, vx::WordFetch{words}, n, start, dir, active, pad, hit, pos, normal, steps);
}

// K3's step (gridtrace.cu::vx_trace_grid_limbs).
extern "C" int vx_trace_grid_limbs_host(const float* start, const float* dir, const int* active,
                                        const int* pad, const unsigned char* limbs,
                                        long long plane, int n, int X, int Y, int Z, int layout,
                                        int max_steps, int* hit, float* pos, float* normal,
                                        int* steps) {
  const vx::GridParams P = {X, Y, Z, layout, max_steps};
  return grid_rays(P, vx::LimbFetch{limbs, plane}, n, start, dir, active, pad, hit, pos, normal,
                   steps);
}
