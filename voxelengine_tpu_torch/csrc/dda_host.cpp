// Host build of dda.cuh, crossings.cuh, grid_dda.cuh, ray_setup.cuh and zslab.cuh: the Hopper
// kernels' per-ray logic compiled by a C++ compiler (-ffp-contract=off), so the CPU
// tests can hold it against the plain torch traces and the JAX package
// before the kernels ever run on the card.  One entry per kernel, taking its
// launcher's arguments minus the stream (K4's also minus its instantiation
// flag and work-counter scratch); K5's runs the kernel's per-lane schedule
// for one warp.  vx_trace_grid_host and vx_trace_grid_limbs_host run the
// grid walk alone on prepared rays (start, direction, active, pad).  The
// *_rays_host entries are K1's and K4's rays entries: origins and raw
// directions, the setup and the hit_imm fix-up included; the
// *_record_host entries their record entries (the ray API's result record
// stored in the ray's store); the *_secondary_host entries their secondary
// entries (secondary.cuh);
// vx_secondary_build_host and vx_secondary_reduce_host secondary.cu's two
// entries, vx_zslab_rays_host K4-slab's batch form, vx_rrtrace_rays_host
// K5's rays entry.
#include <cstring>
#include <vector>

#include "crossings.cuh"
#include "dda.cuh"
#include "grid_dda.cuh"
#include "secondary.cuh"
#include "zslab.cuh"

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
int grid_rays(const vx::GridParams& P, const Fetch& F, int layout, int n, const float* start,
              const float* dir, const int* active, const int* pad, int* hit, float* pos,
              float* normal, int* steps) {
  return vx::with_layout(layout, [&](auto tag) {
    return for_rays(n, start, dir, active, pad, hit, pos, normal, steps,
                    [&](const float* s, const float* d, int a, const int* p) {
                      return vx::trace_grid_ray<decltype(tag)::value>(
                          P, F, s[0], s[1], s[2], d[0], d[1], d[2], a, p[0], p[1], p[2]);
                    });
  });
}

// trace_grid_full for every ray, stored as the kernels store it (hit one byte).
template <class Fetch>
int grid_full_rays(const vx::GridParams& P, const Fetch& F, int layout, int n,
                   const float* origins, int os, const float* rays, int rs, unsigned char* hit,
                   float* pos, float* normal, int* steps) {
  return vx::with_layout(layout, [&](auto tag) {
    for (int i = 0; i < n; ++i) {
      const float* o = origins + os * i;
      const float* v = rays + rs * i;
      const vx::GridResult r = vx::trace_grid_full<decltype(tag)::value>(P, F, o[0], o[1], o[2],
                                                                         v[0], v[1], v[2]);
      hit[i] = (unsigned char)r.hit;
      pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
      normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
      steps[i] = r.steps;
    }
    return 0;
  });
}

// A launch's rays one by one, as the kernels' threads take them (Rays:
// vx::PreparedRays, vx::OriginRays or vx::OriginRaysRecord); with DIAG each
// ray's counters, its own iteration count last (there is no warp here).
template <bool MACRO, bool DIAG, class Fetch, class Rays>
int each_ray(const vx::TraceParams& P, const Fetch& F, int n, const Rays& R, float* pos, float* normal,
             int* steps, int* diag) {
  for (int i = 0; i < n; ++i) {
    int dg[vx::D_COUNT];
    std::memset(dg, 0, sizeof dg);
    const vx::TraceResult r = R.template trace<MACRO, DIAG>(P, F, i, dg);
    R.store(r, i, pos, normal, steps);
    if (DIAG)
      for (int k = 0; k < vx::D_COUNT; ++k) diag[(long long)k * n + i] = dg[k];
  }
  return 0;
}

void store(const vx::TraceResult& r, int i, int* flags, float* pos, float* normal, int* steps) {
  flags[i] = r.flags;
  pos[3 * i] = r.px; pos[3 * i + 1] = r.py; pos[3 * i + 2] = r.pz;
  normal[3 * i] = r.nx; normal[3 * i + 1] = r.ny; normal[3 * i + 2] = r.nz;
  steps[i] = r.steps;
}

// K5's schedule for one warp (rrtrace.cu::rrtrace_kernel): 32 lane states
// advanced in lockstep, an idle lane refilled from the queue in lane order
// once at least `refill` lanes are idle (the kernel's lanes leave their own
// loops at that point, which in lockstep is after the same iteration);
// stats as the counting instantiation's.  RAYS: the rays entry's refill
// (ray_init_of from origins and raw directions at row strides os, rs) and
// store (the hit_imm fix-up, hit one byte in `hit`); else the prepared
// rays and flags.
template <bool MACRO, bool RAYS>
void rr_warp(const vx::TraceParams& P, const vx::LineTableFetch& F, int n, int refill,
             const float* start, const float* dir, const int* active, const int* pad, const float* origins,
             int os, const float* rays, int rs, int* flags, unsigned char* hit, float* pos, float* normal,
             int* steps, unsigned long long* stats) {
  vx::RayState S[32];
  int ray[32];
  for (int l = 0; l < 32; ++l) ray[l] = -1;
  int next = 0;  // the work counter
  bool spent = false;
  const auto store_flags = [&](int i, int f) {
    if (RAYS)
      hit[i] = (unsigned char)(f & 1);
    else
      flags[i] = f;
  };
  for (;;) {
    int idle = 0;
    for (int l = 0; l < 32; ++l) idle += ray[l] < 0;
    if (!spent && idle >= refill) {
      const int base = next;
      next += idle;
      spent = base + idle >= n;
      int rank = 0;
      for (int l = 0; l < 32; ++l) {
        if (ray[l] >= 0) continue;
        const int i = base + rank++;
        if (i >= n) continue;
        const bool live = RAYS ? vx::ray_init_of(P, S[l], origins + (long long)os * i, rays + (long long)rs * i)
                               : vx::ray_init(S[l], start[3 * i], start[3 * i + 1], start[3 * i + 2], dir[3 * i],
                                              dir[3 * i + 1], dir[3 * i + 2], active[i], pad[3 * i],
                                              pad[3 * i + 1], pad[3 * i + 2]);
        if (live) {
          ray[l] = i;
        } else {
          store_flags(i, 0);
          vx::store_ray(vx::TraceResult{0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0}, i, pos, normal, steps);
        }
      }
      idle = 0;
      for (int l = 0; l < 32; ++l) idle += ray[l] < 0;
    }
    if (idle == 32) {
      if (spent) break;
      continue;
    }
    if (stats) {
      stats[0] += 32 - idle;
      stats[1] += 1;
    }
    for (int l = 0; l < 32; ++l) {
      if (ray[l] >= 0 && vx::ray_iterate<MACRO, false>(P, F, S[l])) {
        vx::TraceResult r = vx::ray_result(P, S[l]);
        if (RAYS) vx::fix_hit_imm(P, vx::RayOf{origins, os, rays, rs, ray[l]}, r);
        store_flags(ray[l], r.flags);
        vx::store_ray(r, ray[l], pos, normal, steps);
        ray[l] = -1;
      }
    }
  }
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

// K1's rays entry (bigtrace.cu::vx_bigtrace_rays), its arguments minus
// the stream; `diag` as vx_trace_host's.
extern "C" int vx_bigtrace_rays_host(const float* origins, int os, const float* rays, int rs,
                                     const int* region_lines, const int* brick_lines, const int* macro,
                                     const int* macro2, int n, int gx, int gy, int gz, int rx, int ry,
                                     int rz, int factor, int wpb, int max_steps, int brick_layout,
                                     int iter_limit, int use_macro, unsigned char* hit, float* pos,
                                     float* normal, int* steps, int* diag) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const vx::OriginRays R = {origins, os, rays, rs, hit};
  if (use_macro)
    return diag ? each_ray<true, true>(P, F, n, R, pos, normal, steps, diag)
                : each_ray<true, false>(P, F, n, R, pos, normal, steps, diag);
  return diag ? each_ray<false, true>(P, F, n, R, pos, normal, steps, diag)
              : each_ray<false, false>(P, F, n, R, pos, normal, steps, diag);
}

// K1's record entry (bigtrace.cu::vx_bigtrace_record), its arguments minus
// the stream.
extern "C" int vx_bigtrace_record_host(const float* origins, int os, const float* rays, int rs,
                                       const int* region_lines, const int* brick_lines, const int* macro,
                                       const int* macro2, int n, int gx, int gy, int gz, int rx, int ry, int rz,
                                       int factor, int wpb, int max_steps, int brick_layout, int iter_limit,
                                       unsigned char* valid, float* hit_point, float* normal, float* distance,
                                       int* voxel_index, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  const vx::OriginRaysRecord R = {{origins, os, rays, rs, valid}, distance, voxel_index, gx * factor, gy * factor};
  return each_ray<false, false>(P, F, n, R, hit_point, normal, steps, nullptr);
}

// The record instantiation (crossings.cu::vx_trace_crossings), ray by ray.
extern "C" int vx_trace_crossings_host(const float* start, const float* dir, const int* active,
                                       const int* pad, const int* region_lines,
                                       const int* brick_lines, const int* macro,
                                       const int* macro2, int n, int gx, int gy, int gz, int rx,
                                       int ry, int rz, int factor, int wpb, int max_steps,
                                       int brick_layout, int iter_limit, int use_macro,
                                       int max_rows, int* rows, int* nrows, int* flags,
                                       float* pos, float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  for (int i = 0; i < n; ++i) {
    vx::TraceResult r;
    const float* s = start + 3 * i;
    const float* d = dir + 3 * i;
    const int* p = pad + 3 * i;
    int* block = rows + (long long)i * max_rows * vx::C_FIELDS;
    nrows[i] = use_macro
        ? vx::record_crossings<true>(P, F, s[0], s[1], s[2], d[0], d[1], d[2], active[i], p[0],
                                     p[1], p[2], max_rows, block, &r)
        : vx::record_crossings<false>(P, F, s[0], s[1], s[2], d[0], d[1], d[2], active[i], p[0],
                                      p[1], p[2], max_rows, block, &r);
    store(r, i, flags, pos, normal, steps);
  }
  return 0;
}

// K5 (rrtrace.cu::vx_rrtrace) as one warp runs it: the per-lane refill
// schedule over the whole queue, each lane's walk advanced by ray_iterate.
// `counter` (the kernel's work-counter scratch) is not used; `stats`, when
// given, receives the counting instantiation's two sums for this warp.
extern "C" int vx_rrtrace_host(const float* start, const float* dir, const int* active,
                               const int* pad, const int* region_lines, const int* brick_lines,
                               const int* macro, const int* macro2, int n, int gx, int gy,
                               int gz, int rx, int ry, int rz, int factor, int wpb,
                               int max_steps, int brick_layout, int iter_limit, int use_macro,
                               int refill, int* counter, unsigned long long* stats, int* flags,
                               float* pos, float* normal, int* steps) {
  (void)counter;
  if (refill < 1 || refill > 32) return 1;
  if (n == 0) return 0;
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  if (use_macro)
    rr_warp<true, false>(P, F, n, refill, start, dir, active, pad, nullptr, 0, nullptr, 0, flags, nullptr, pos,
                         normal, steps, stats);
  else
    rr_warp<false, false>(P, F, n, refill, start, dir, active, pad, nullptr, 0, nullptr, 0, flags, nullptr, pos,
                          normal, steps, stats);
  return 0;
}

// K5's rays entry (rrtrace.cu::vx_rrtrace_rays) as one warp runs it: the
// refill sets each ray up, the store does the hit_imm fix-up.  `counter` is
// not used.
extern "C" int vx_rrtrace_rays_host(const float* origins, int os, const float* rays, int rs,
                                    const int* region_lines, const int* brick_lines, const int* macro,
                                    const int* macro2, int n, int gx, int gy, int gz, int rx, int ry, int rz,
                                    int factor, int wpb, int max_steps, int brick_layout, int iter_limit,
                                    int use_macro, int refill, int* counter, unsigned char* hit, float* pos,
                                    float* normal, int* steps) {
  (void)counter;
  if (refill < 1 || refill > 32) return 1;
  if (n == 0) return 0;
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  if (use_macro)
    rr_warp<true, true>(P, F, n, refill, nullptr, nullptr, nullptr, nullptr, origins, os, rays, rs, nullptr, hit,
                        pos, normal, steps, nullptr);
  else
    rr_warp<false, true>(P, F, n, refill, nullptr, nullptr, nullptr, nullptr, origins, os, rays, rs, nullptr, hit,
                         pos, normal, steps, nullptr);
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

// K4's compact instantiation (bmtrace.cu::vx_trace_brickmap_compact), as
// the dense host entry: brick slots from brick_idx.
extern "C" int vx_trace_brickmap_compact_host(const float* start, const float* dir,
                                              const int* active, const int* pad, const int* meta,
                                              const int* brick_idx, const int* bricks, int n,
                                              int gx, int gy, int gz, int factor, int wpb,
                                              int max_steps, int coarse_layout, int brick_layout,
                                              int iter_limit, int* flags, float* pos,
                                              float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::CompactFetch<> F = {{meta, bricks, gx, gy, coarse_layout, wpb}, brick_idx};
  return brickmap_rays(P, F, n, start, dir, active, pad, flags, pos, normal, steps);
}

// K2 (gridtrace.cu::vx_trace_grid): trace_grid_vpu's function, ray setup
// and fix-up included.
extern "C" int vx_trace_grid_full_host(const float* origins, int os, const float* rays, int rs,
                                       const int* words, int n, int X, int Y, int Z, int layout,
                                       int max_steps, unsigned char* hit, float* pos,
                                       float* normal, int* steps) {
  const vx::GridParams P = {X, Y, Z, max_steps};
  return grid_full_rays(P, vx::WordFetch{words}, layout, n, origins, os, rays, rs, hit, pos, normal,
                        steps);
}

// K3's staging (gridtrace.cu, staged instantiation): words 0 .. 16 *
// words16 - 1 rebuilt from the limb planes into out.
extern "C" int vx_limb_words_host(const unsigned char* limbs, long long plane, int words16,
                                  int* out) {
  for (int q = 0; q < words16; ++q) vx::limb_words16(limbs, plane, q, out + 16 * q);
  return 0;
}

// K3 (gridtrace.cu::vx_trace_grid_limbs), either instantiation: staged = 1
// rebuilds words16 * 16 words first and walks them (SharedWordFetch),
// staged = 0 reads the planes at every step (LimbFetch).  The launcher's
// counter (its work queue) has no host counterpart.
extern "C" int vx_trace_grid_limbs_full_host(const float* origins, int os, const float* rays,
                                             int rs, const unsigned char* limbs, long long plane,
                                             int n, int X, int Y, int Z, int layout,
                                             int max_steps, int staged, int words16, int* counter,
                                             unsigned char* hit, float* pos, float* normal,
                                             int* steps) {
  (void)counter;
  const vx::GridParams P = {X, Y, Z, max_steps};
  if (!staged)
    return grid_full_rays(P, vx::LimbFetch{limbs, plane}, layout, n, origins, os, rays, rs, hit,
                          pos, normal, steps);
  if ((long long)words16 * 16 > plane) return 1;
  std::vector<int> words((size_t)words16 * 16);
  vx_limb_words_host(limbs, plane, words16, words.data());
  return grid_full_rays(P, vx::SharedWordFetch{words.data()}, layout, n, origins, os, rays, rs, hit,
                        pos, normal, steps);
}

// The grid walk alone (grid_dda.cuh::trace_grid_ray) on prepared rays, with
// the int32 word fetch: position and normal are the last step's, before the
// wrapper's zero-step fix-up.
extern "C" int vx_trace_grid_host(const float* start, const float* dir, const int* active,
                                  const int* pad, const int* words, int n, int X, int Y, int Z,
                                  int layout, int max_steps, int* hit, float* pos,
                                  float* normal, int* steps) {
  const vx::GridParams P = {X, Y, Z, max_steps};
  return grid_rays(P, vx::WordFetch{words}, layout, n, start, dir, active, pad, hit, pos, normal,
                   steps);
}

// The same with the limb-plane fetch.
extern "C" int vx_trace_grid_limbs_host(const float* start, const float* dir, const int* active,
                                        const int* pad, const unsigned char* limbs,
                                        long long plane, int n, int X, int Y, int Z, int layout,
                                        int max_steps, int* hit, float* pos, float* normal,
                                        int* steps) {
  const vx::GridParams P = {X, Y, Z, max_steps};
  return grid_rays(P, vx::LimbFetch{limbs, plane}, layout, n, start, dir, active, pad, hit, pos,
                   normal, steps);
}

// K4-slab (zslab.cu::vx_zslab), ray by ray: one round of the z-sharded walk
// over the rank's slab.  The launcher's counter has no host counterpart.
extern "C" int vx_zslab_host(const float* start, const float* dir, const int* active, const int* pad,
                             const int* rows_in, const int* meta, const int* bricks, int m, int gx, int gy,
                             int gz, int z0, int slab_gz, int factor, int wpb, int max_steps,
                             int brick_layout, int iter_limit, int* counter, int* rows_out, int* status,
                             int* flags, float* pos, float* normal, int* steps) {
  (void)counter;
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::SlabFetch F = {meta, bricks, gx, gy, z0, slab_gz, wpb};
  for (int i = 0; i < m; ++i) {
    vx::TraceResult r;
    const long long w = (long long)i * vx::STATE_WORDS;
    status[i] = rows_in != nullptr
        ? vx::slab_round(P, F, rows_in + w, nullptr, nullptr, 0, nullptr, rows_out + w, r)
        : vx::slab_round(P, F, nullptr, start + 3 * i, dir + 3 * i, active[i], pad + 3 * i,
                         rows_out + w, r);
    store(r, i, flags, pos, normal, steps);
  }
  return 0;
}

// K4-slab's batch form (zslab.cu::vx_zslab_rays), ray by ray in batch
// order: round 0 (rows_in null) over the whole batch, or the handed-on rows
// with their batch indices.  Paused rays are appended in that order (the
// kernel's warps append in theirs); counters[1] and [2] as the kernel's,
// counters[0] unused.
extern "C" int vx_zslab_rays_host(const float* origins, int os, const float* rays, int rs, const int* rows_in,
                                  const int* idx_in, const int* meta, const int* bricks, int m, int gx, int gy,
                                  int gz, int z0, int slab_gz, int factor, int wpb, int max_steps, int brick_layout,
                                  int iter_limit, int* counters, int* rows_out, int* idx_out, int* hit, float* pos,
                                  float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::SlabFetch F = {meta, bricks, gx, gy, z0, slab_gz, wpb};
  counters[0] = counters[1] = counters[2] = 0;
  std::vector<int> row(vx::STATE_WORDS);
  for (int i = 0; i < m; ++i) {
    const int b = rows_in == nullptr ? i : idx_in[i];
    const vx::RayOf ray = {origins, os, rays, rs, b};
    vx::TraceResult r;
    int st;
    if (rows_in == nullptr) {
      st = vx::slab_round_rays(P, F, ray, row.data(), r);
    } else {
      std::memcpy(row.data(), rows_in + (long long)i * vx::STATE_WORDS, sizeof(int) * vx::STATE_WORDS);
      st = vx::slab_round(P, F, row.data(), nullptr, nullptr, 0, nullptr, row.data(), r);
    }
    counters[2] += rows_in == nullptr && st != vx::SLAB_OTHER;
    if (st == vx::SLAB_DONE) {
      hit[b] = r.flags & 1;
      vx::store_ray(r, b, pos, normal, steps);
    } else if (st == vx::SLAB_PAUSED) {
      std::memcpy(rows_out + (long long)counters[1] * vx::STATE_WORDS, row.data(), sizeof(int) * vx::STATE_WORDS);
      idx_out[counters[1]++] = b;
    }
  }
  return 0;
}

// K4's rays entries (bmtrace.cu::vx_trace_brickmap_dense_rays and
// _compact_rays), as their prepared-ray host entries: no instantiation flag
// and no work counter.
extern "C" int vx_trace_brickmap_dense_rays_host(const float* origins, int os, const float* rays, int rs,
                                                 const int* meta, const int* bricks, int n, int gx, int gy,
                                                 int gz, int factor, int wpb, int max_steps,
                                                 int coarse_layout, int brick_layout, int iter_limit,
                                                 unsigned char* hit, float* pos, float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::DenseSlotFetch<> F = {meta, bricks, gx, gy, coarse_layout, wpb};
  return each_ray<false, false>(P, F, n, vx::OriginRays{origins, os, rays, rs, hit}, pos, normal, steps,
                                nullptr);
}

extern "C" int vx_trace_brickmap_compact_rays_host(const float* origins, int os, const float* rays, int rs,
                                                   const int* meta, const int* brick_idx, const int* bricks,
                                                   int n, int gx, int gy, int gz, int factor, int wpb,
                                                   int max_steps, int coarse_layout, int brick_layout,
                                                   int iter_limit, unsigned char* hit, float* pos,
                                                   float* normal, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::CompactFetch<> F = {{meta, bricks, gx, gy, coarse_layout, wpb}, brick_idx};
  return each_ray<false, false>(P, F, n, vx::OriginRays{origins, os, rays, rs, hit}, pos, normal, steps,
                                nullptr);
}

// K4's record entries (bmtrace.cu::vx_trace_brickmap_dense_record and
// _compact_record), as their rays host entries.
extern "C" int vx_trace_brickmap_dense_record_host(const float* origins, int os, const float* rays, int rs,
                                                   const int* meta, const int* bricks, int n, int gx, int gy,
                                                   int gz, int factor, int wpb, int max_steps, int coarse_layout,
                                                   int brick_layout, int iter_limit, unsigned char* valid,
                                                   float* hit_point, float* normal, float* distance,
                                                   int* voxel_index, int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::DenseSlotFetch<> F = {meta, bricks, gx, gy, coarse_layout, wpb};
  const vx::OriginRaysRecord R = {{origins, os, rays, rs, valid}, distance, voxel_index, gx * factor, gy * factor};
  return each_ray<false, false>(P, F, n, R, hit_point, normal, steps, nullptr);
}

extern "C" int vx_trace_brickmap_compact_record_host(const float* origins, int os, const float* rays, int rs,
                                                     const int* meta, const int* brick_idx, const int* bricks,
                                                     int n, int gx, int gy, int gz, int factor, int wpb,
                                                     int max_steps, int coarse_layout, int brick_layout,
                                                     int iter_limit, unsigned char* valid, float* hit_point,
                                                     float* normal, float* distance, int* voxel_index,
                                                     int* steps) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::CompactFetch<> F = {{meta, bricks, gx, gy, coarse_layout, wpb}, brick_idx};
  const vx::OriginRaysRecord R = {{origins, os, rays, rs, valid}, distance, voxel_index, gx * factor, gy * factor};
  return each_ray<false, false>(P, F, n, R, hit_point, normal, steps, nullptr);
}

namespace {

// A secondary launch's rays one by one, as the kernels' threads take them.
template <bool MACRO, class Fetch, class Rays>
int each_secondary(const vx::TraceParams& P, const Fetch& F, int n, const Rays& R) {
  for (int i = 0; i < n; ++i) R.template run<MACRO>(P, F, i);
  return 0;
}

}  // namespace

// K1's secondary entry (bigtrace.cu::vx_bigtrace_secondary), its arguments
// minus the stream.
extern "C" int vx_bigtrace_secondary_host(VX_SECONDARY_PARAMS, const int* region_lines, const int* brick_lines,
                                          const int* macro, const int* macro2, int n, int gx, int gy, int gz,
                                          int rx, int ry, int rz, int factor, int wpb, int max_steps,
                                          int brick_layout, int iter_limit, int use_macro, VX_SECONDARY_OUTS) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::LineTableFetch F = {region_lines, brick_lines, macro, macro2, rx, ry, rz, wpb};
  return vx::with_secondary_kind(kind, VX_SECONDARY_ARGS, [&](const auto& R) {
    return use_macro ? each_secondary<true>(P, F, n, R) : each_secondary<false>(P, F, n, R);
  });
}

// K4's secondary entries (bmtrace.cu::vx_trace_brickmap_dense_secondary and
// _compact_secondary), as their rays entries' host twins: no instantiation
// flag and no work counter.
extern "C" int vx_trace_brickmap_dense_secondary_host(VX_SECONDARY_PARAMS, const int* meta, const int* bricks,
                                                      int n, int gx, int gy, int gz, int factor, int wpb,
                                                      int max_steps, int coarse_layout, int brick_layout,
                                                      int iter_limit, VX_SECONDARY_OUTS) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::DenseSlotFetch<> F = {meta, bricks, gx, gy, coarse_layout, wpb};
  return vx::with_secondary_kind(kind, VX_SECONDARY_ARGS,
                                 [&](const auto& R) { return each_secondary<false>(P, F, n, R); });
}

extern "C" int vx_trace_brickmap_compact_secondary_host(VX_SECONDARY_PARAMS, const int* meta, const int* brick_idx,
                                                        const int* bricks, int n, int gx, int gy, int gz,
                                                        int factor, int wpb, int max_steps, int coarse_layout,
                                                        int brick_layout, int iter_limit, VX_SECONDARY_OUTS) {
  const vx::TraceParams P = {gx, gy, gz, factor, max_steps, brick_layout, iter_limit};
  const vx::CompactFetch<> F = {{meta, bricks, gx, gy, coarse_layout, wpb}, brick_idx};
  return vx::with_secondary_kind(kind, VX_SECONDARY_ARGS,
                                 [&](const auto& R) { return each_secondary<false>(P, F, n, R); });
}

// secondary.cu's two entries, their arguments minus the stream.
extern "C" int vx_secondary_build_host(VX_SECONDARY_PARAMS, int n, float* origins, float* out_dirs) {
  if (kind < vx::SEC_SHADOW || kind > vx::SEC_AO || (kind == vx::SEC_AO && ao_samples < 1)) return 1;
  const vx::SecondaryArgs A = VX_SECONDARY_IN_ARGS;
  const long long m = kind == vx::SEC_AO ? (long long)n * ao_samples : n;
  for (long long j = 0; j < m; ++j) vx::secondary_build_ray(kind, A, n, j, origins + 3 * j, out_dirs + 3 * j);
  return 0;
}

extern "C" int vx_secondary_reduce_host(const float* pos, int ao_samples, int n, const unsigned char* t_hit,
                                        const float* t_pos, float* ao) {
  if (ao_samples < 1) return 1;
  for (int i = 0; i < n; ++i) ao[i] = vx::secondary_ao(pos, ao_samples, t_hit, t_pos, n, i);
  return 0;
}
