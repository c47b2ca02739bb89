// One ray's shading: render/frame.py::shade_traced_plain after its traces,
// ray by ray, __host__ __device__ (dda.cuh's VX_HD) so that g++ builds the
// same source into shade_host.cpp for the CPU tests.
//
// In the plain version's order, every float op rounded as it rounds it
// (nvcc --fmad=false without fast-math, g++ -ffp-contract=off;
// kernels/build.py):
//   - normal = -out.normal (Renderer.cu:212);
//   - calculate_color (render/shading.py): the lit mask, l_dot * light,
//     ambient * (0.25 + hemi * 0.75), the view vector over max(|v|, 1e-12)
//     with IEEE division, the reflected light L - (2 n) (n . L), s ** 32 as
//     five squarings; dot products summed x*x + y*y + z*z left to right
//     (core/exact.py::dot3), roots correctly rounded (core/exact.py::
//     sqrt_rn);
//   - the reflection lerp color + (rcol - color) * reflectivity, and the AO
//     multiply where l_dot == 0, where their inputs are given;
//   - tonemap c / (c + 1) and its clamp;
//   - the DEBUG, NORMALS, DEPTH and STEPS views: _mod as fmod plus a sign
//     fix, the depth |position - origin| * 0.01, the heat steps / 256;
//   - the sky (the raw direction), the crosshair on the pre-remap row, the
//     DEBUG bottom-left overlay and the final clamp.
// torch.clamp, torch.clamp_min and torch.clamp_max pass NaN on.  Their
// other cases are written as each build's torch computes them (clamp_t,
// clamp_min_t, clamp_max_t), so that a signed zero comes out as the plain
// version's on the same device.  These three functions are the one place
// where the g++ build and the card's build compile different code: the CPU
// tests hold the host branch to torch's CPU clamps; the __CUDA_ARCH__
// branch is held to torch's CUDA clamps only on the card
// (tests/test_torch_frame_kernels.py's cuda lane, signed zeros and NaN
// included, and chip_smoke.py's shading gates).  secondary.cuh's AO
// falloff uses them too.
#pragma once

#include <math.h>
#include <stdint.h>

#include "dda.cuh"

namespace vx {

// DebugView values (config.py).
enum ShadeView { VIEW_SHADED = 0, VIEW_DEBUG = 1, VIEW_NORMALS = 2, VIEW_DEPTH = 3, VIEW_STEPS = 4 };

// torch.clamp_min(x, lo) and torch.clamp(x, lo, hi) with Python numbers:
// on the card torch's CUDA kernels, isnan(x) ? x : ::max / ::min (fmaxf,
// fminf); on the CPU std::max / std::min, which keep x on a tie (a -0.0
// against 0.0) and NaN.
VX_HD float clamp_min_t(float x, float lo) {
#ifdef __CUDA_ARCH__
  return x != x ? x : fmaxf(x, lo);
#else
  return x < lo ? lo : x;
#endif
}

VX_HD float clamp_max_t(float x, float hi) {
#ifdef __CUDA_ARCH__
  return x != x ? x : fminf(x, hi);
#else
  return hi < x ? hi : x;
#endif
}

VX_HD float clamp_t(float x, float lo, float hi) {
#ifdef __CUDA_ARCH__
  return x != x ? x : fminf(fmaxf(x, lo), hi);
#else
  const float m = x < lo ? lo : x;
  return hi < m ? hi : m;
#endif
}

VX_HD float dot3f(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

// render/shading.py::reflect: out = i - (2 n) (n . i).
VX_HD void reflect3(const float* i, const float* n, float* out) {
  const float d = dot3f(n, i);
  for (int k = 0; k < 3; ++k) out[k] = i[k] - 2.0f * n[k] * d;
}

// Where a frame's shading reads its inputs (device memory on the card).
// Optional inputs are null where their trace did not run.
struct ShadeArgs {
  // the primary trace: hit (one byte), position, normal (the trace's
  // step-sign convention), steps
  const unsigned char* hit;
  const float* pos;
  const float* nrm;
  const int* steps;
  // the rays: origins and raw directions, row strides 3 or 0
  const float* origins;
  int os;
  const float* dirs;
  int ds;
  // final pixel, row after the checkerboard remap, pre-remap row
  const int64_t* px;
  const int64_t* py;
  const int64_t* py_r;
  // f32[3] each: the camera position, the Environment's vectors
  const float* cam;
  const float* light_dir;
  const float* light_color;
  const float* ambient;
  // the shadow trace: hit, steps
  const unsigned char* shadow_hit;
  const int* shadow_steps;
  // the reflection trace: hit, position, normal (its direction, which a
  // miss shows, is computed again from dirs)
  const unsigned char* refl_hit;
  const float* refl_pos;
  const float* refl_nrm;
  // the AO factor, f32[n]
  const float* ao;
  int width, height, view, crosshair;
  float reflectivity;
  float pos_mod;  // cfg.debug_pos_mod
  float mod_m;    // float32(1) + float32(FLT_EPS_DDA), DEBUG's _mod divisor
};

// render/shading.py::calculate_color of one hit: camera (or bounce origin)
// cam, normal n (renderer convention), hit position p.
VX_HD void calculate_color(const ShadeArgs& A, const float* cam, const float* n, const float* p, bool shadow,
                           float* c) {
  const float* L = A.light_dir;
  const float lit = shadow ? 0.0f : 1.0f;
  const float nl = dot3f(n, L);
  const float l_dot = clamp_min_t(nl, 0.0f) * lit;
  const float hemi = n[1] * 0.5f + 0.5f;
  const float w = 0.25f + hemi * 0.75f;  // lerp(0.25, 1.0, hemi)
  float view[3], refl[3];
  for (int k = 0; k < 3; ++k) view[k] = p[k] - cam[k];
  const float len = clamp_min_t(sqrtf(dot3f(view, view)), 1e-12f);
  for (int k = 0; k < 3; ++k) view[k] = view[k] / len;
  for (int k = 0; k < 3; ++k) refl[k] = L[k] - 2.0f * n[k] * nl;
  float s = clamp_min_t(dot3f(view, refl), 0.0f);
  for (int k = 0; k < 5; ++k) s = s * s;  // s ** 32
  const float spec = shadow ? 0.0f : s;
  for (int k = 0; k < 3; ++k) c[k] = (l_dot * A.light_color[k] + A.ambient[k] * w) + spec * A.light_color[k];
}

// jnp.mod(a, m) for m > 0 (render/frame.py::_mod).
VX_HD float mod_t(float a, float m) {
  const float r = fmodf(a, m);
  return (r != 0.0f && r < 0.0f) ? r + m : r;
}

// Ray i's clamped color and whether it writes its pixel.
VX_HD void shade_ray(const ShadeArgs& A, int i, float* color, bool* write_out) {
  const bool hit = A.hit[i] != 0;
  const float* pos = A.pos + 3 * i;
  const float* dir = A.dirs + (long long)A.ds * i;
  const int64_t px = A.px[i], py = A.py[i];
  const int64_t hw = A.width >> 1, hh = A.height >> 1;
  float n[3];
  for (int k = 0; k < 3; ++k) n[k] = -A.nrm[3 * i + k];
  int steps = A.steps[i];
  bool shadow = false;
  if (A.shadow_hit) {
    shadow = A.shadow_hit[i] != 0 && hit;
    steps = steps + (hit ? A.shadow_steps[i] : 0);
  }
  float c[3], heat[3] = {(float)steps / 256.0f, 0.0f, 0.0f};
  bool write = true;
  if (A.view == VIEW_SHADED) {
    calculate_color(A, A.cam, n, pos, shadow, c);
    if (A.refl_hit) {
      float ro[3], rn[3], rc[3];
      if (A.refl_hit[i]) {
        for (int k = 0; k < 3; ++k) ro[k] = pos[k] + n[k] * 0.01f;
        for (int k = 0; k < 3; ++k) rn[k] = -A.refl_nrm[3 * i + k];
        calculate_color(A, ro, rn, A.refl_pos + 3 * i, false, rc);
      } else {
        reflect3(dir, n, rc);  // the miss: the reflected direction
      }
      for (int k = 0; k < 3; ++k) c[k] = c[k] + (rc[k] - c[k]) * A.reflectivity;
    }
    if (A.ao && clamp_min_t(dot3f(n, A.light_dir), 0.0f) == 0.0f) {
      for (int k = 0; k < 3; ++k) c[k] = c[k] * A.ao[i];
    }
    for (int k = 0; k < 3; ++k) c[k] = clamp_t(c[k] / (c[k] + 1.0f), 0.0f, 1.0f);  // tonemap
  } else if (A.view == VIEW_NORMALS) {
    for (int k = 0; k < 3; ++k) c[k] = n[k];
  } else if (A.view == VIEW_STEPS) {
    for (int k = 0; k < 3; ++k) c[k] = heat[k];
  } else {  // DEBUG, DEPTH
    const float* o = A.origins + (long long)A.os * i;
    float v[3];
    for (int k = 0; k < 3; ++k) v[k] = pos[k] - o[k];
    const float depth[3] = {sqrtf(dot3f(v, v)) * 0.01f, 0.0f, 0.0f};
    if (A.view == VIEW_DEPTH) {
      for (int k = 0; k < 3; ++k) c[k] = depth[k];
    } else {
      const bool left = px < hw, top = py < hh;
      for (int k = 0; k < 3; ++k) {
        const float hp = mod_t(pos[k] / A.pos_mod, A.mod_m);
        c[k] = top ? (left ? n[k] : hp) : depth[k];
      }
      write = !(left && !top);  // bottom-left quadrant: no write on hit (Renderer.cu:233-235)
    }
  }
  if (!hit) {
    for (int k = 0; k < 3; ++k) c[k] = dir[k];  // sky = raw ray direction
  }
  write = write || !hit;
  if (A.crosshair && px == hw && A.py_r[i] == hh) {
    for (int k = 0; k < 3; ++k) c[k] = 10.0f;
    write = true;
  }
  if (A.view == VIEW_DEBUG && px < hw && py > hh) {
    for (int k = 0; k < 3; ++k) c[k] = heat[k];
    write = true;
  }
  for (int k = 0; k < 3; ++k) color[k] = clamp_t(c[k], 0.0f, 1.0f);
  *write_out = write;
}

// A rank's part of a sharded frame's framebuffer (parallel/sharded.py):
// the image cut into tiles of th rows by tw columns, tiles_x of them to a
// row of tiles, tile j on rank j % ranks, held at entry j / ranks of the
// rank's f32[tiles / ranks, th, tw, 3].  A row band (make_framebuffer_rows)
// is tw = W, th = H / N, tiles_x = 1; the block-cyclic layout
// (make_framebuffer_cyclic) tw = bw, th = bhf, tiles_x = W / bw; a whole
// framebuffer tw = W, th = H, tiles_x = ranks = 1.
struct FrameDest {
  int tw, th, tiles_x, ranks, rank;
};

// The float offset of pixel (px, py) in the rank's part, or -1 where the
// pixel is not the rank's or lies outside the image's rows [0, height).
VX_HD long long dest_offset(const FrameDest& D, int height, int64_t px, int64_t py) {
  if (py < 0 || py >= height) return -1;
  const int x = (int)px, y = (int)py;
  // one part whose tiles stack as the image's rows (the whole framebuffer,
  // one rank's band of one): the image's own layout, without the divisions
  if (D.ranks == 1 && D.tiles_x == 1) return 3 * ((long long)y * D.tw + x);
  const int j = (y / D.th) * D.tiles_x + x / D.tw;
  if (j % D.ranks != D.rank) return -1;
  return 3 * (((long long)(j / D.ranks) * D.th + y % D.th) * D.tw + x % D.tw);
}

// The composite (shade.cu::vx_shade_composite): ray i shaded, and written
// where its pixel lies in the rank's part, if it writes and its pre-remap
// row is a row of the image (a sharded frame's halo ray of row -1 writes
// nothing; one device's rays have none).  That is composite_frame's and
// checkerboard_pair_select's pair select on the image, a band or a block:
// y = 2y' + (x even) + (frame even) sends each ray to one pixel.
VX_HD void shade_to_dest(const ShadeArgs& A, const FrameDest& D, int i, float* fb) {
  float c[3];
  bool w;
  shade_ray(A, i, c, &w);
  // py is 2 py_r + (x even) + (frame even), or py_r: a negative pre-remap
  // row lands at py <= 0, so only py == 0 reads it
  const int64_t py = A.py[i];
  if (!w || (py == 0 && A.py_r[i] < 0)) return;
  const long long off = dest_offset(D, A.height, A.px[i], py);
  if (off < 0) return;
  fb[off] = c[0]; fb[off + 1] = c[1]; fb[off + 2] = c[2];
}

}  // namespace vx

// The arguments of the kernel's entries (shade.cu) and of their host
// twins (shade_host.cpp), in ShadeArgs' order, then n; the outputs follow.
#define VX_SHADE_PARAMS                                                                                 \
  const unsigned char *hit, const float *pos, const float *nrm, const int *steps, const float *origins, \
      int os, const float *dirs, int ds, const int64_t *px, const int64_t *py, const int64_t *py_r,     \
      const float *cam, const float *light_dir, const float *light_color, const float *ambient,         \
      const unsigned char *shadow_hit, const int *shadow_steps, const unsigned char *refl_hit,          \
      const float *refl_pos, const float *refl_nrm, const float *ao, int width, int height, int view,   \
      int crosshair, float reflectivity, float pos_mod, float mod_m, int n
#define VX_SHADE_ARGS                                                                                     \
  vx::ShadeArgs {                                                                                         \
    hit, pos, nrm, steps, origins, os, dirs, ds, px, py, py_r, cam, light_dir, light_color, ambient,      \
        shadow_hit, shadow_steps, refl_hit, refl_pos, refl_nrm, ao, width, height, view,                  \
        crosshair, reflectivity, pos_mod, mod_m                                                           \
  }
