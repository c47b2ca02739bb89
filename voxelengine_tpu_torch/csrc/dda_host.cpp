// Host build of dda.cuh and grid_dda.cuh: the Hopper kernels' per-ray step
// logic compiled by a C++ compiler (-ffp-contract=off), so the CPU tests can
// hold it against the plain torch traces before the kernels ever run on the
// card.  One entry per kernel, taking its launcher's arguments minus the
// stream (K4's also minus its instantiation flag and work-counter scratch).
#include <cstring>

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

// K1's step (bigtrace.cu::vx_bigtrace).  `diag` as the kernel's, except
// that the iteration count is the ray's own (there is no warp here).
extern "C" int vx_trace_host(const float* start, const float* dir, const int* active,
                             const int* pad, const int* region_lines, const int* brick_lines,
                             const int* macro, const int* macro2, int n, int gx, int gy, int gz,
                             int rx, int ry, int rz, int factor, int wpb, int max_steps,
                             int brick_layout, int iter_limit, int use_macro, int* flags,
                             float* pos, float* normal, int* steps, int* diag) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  if (diag == nullptr) {
    if (use_macro)
      return for_rays(n, start, dir, active, pad, flags, pos, normal, steps,
                      [&](const float* s, const float* d, int a, const int* p) {
                        return vx::trace_ray<true>(P, F, s[0], s[1], s[2], d[0], d[1], d[2], a,
                                                   p[0], p[1], p[2]);
                      });
    return brickmap_rays(P, F, n, start, dir, active, pad, flags, pos, normal, steps);
  }
  int i = 0;
  return for_rays(n, start, dir, active, pad, flags, pos, normal, steps,
                  [&](const float* s, const float* d, int a, const int* p) {
                    int dg[vx::D_COUNT];
                    std::memset(dg, 0, sizeof dg);
                    const auto r = use_macro
                        ? vx::trace_ray<true, true>(P, F, s[0], s[1], s[2], d[0], d[1], d[2], a,
                                                    p[0], p[1], p[2], dg)
                        : vx::trace_ray<false, true>(P, F, s[0], s[1], s[2], d[0], d[1], d[2], a,
                                                     p[0], p[1], p[2], dg);
                    for (int k = 0; k < vx::D_COUNT; ++k) diag[(long long)k * n + i] = dg[k];
                    ++i;
                    return r;
                  });
}

// K5's step (rrtrace.cu::vx_rrtrace): the work queue taken in order, a
// batch at a time; each ray is traced as K1 traces it.  `counter` (the
// kernel's work-counter scratch) is not used.
extern "C" int vx_rrtrace_host(const float* start, const float* dir, const int* active,
                               const int* pad, const int* region_lines, const int* brick_lines,
                               const int* macro, const int* macro2, int n, int gx, int gy,
                               int gz, int rx, int ry, int rz, int factor, int wpb,
                               int max_steps, int brick_layout, int iter_limit, int use_macro,
                               int batch, int* counter, int* flags, float* pos, float* normal,
                               int* steps) {
  if (batch <= 0 || batch % 32) return 1;
  for (int base = 0; base < n; base += batch) {
    const int m = n - base < batch ? n - base : batch;
    const int err = vx_trace_host(start + 3 * base, dir + 3 * base, active + base, pad + 3 * base,
                                  region_lines, brick_lines, macro, macro2, m, gx, gy, gz, rx,
                                  ry, rz, factor, wpb, max_steps, brick_layout, iter_limit,
                                  use_macro, flags + base, pos + 3 * base, normal + 3 * base,
                                  steps + base, nullptr);
    if (err) return err;
  }
  return 0;
}

// K4's step (bmtrace.cu::vx_trace_brickmap_dense), meta read where it lies;
// the launcher's shared_meta and counter (its instantiation and its work
// queue) have no host counterpart.
extern "C" int vx_trace_brickmap_dense_host(const float* start, const float* dir,
                                            const int* active, const int* pad, const int* meta,
                                            const int* bricks, int n, int gx, int gy, int gz,
                                            int factor, int wpb, int max_steps,
                                            int coarse_layout, int brick_layout, int iter_limit,
                                            int* flags, float* pos, float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::DenseSlotFetch<> F = {meta, bricks, gx, gy, coarse_layout, wpb};
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
