// Host build of noise.cuh and terrain.cuh: W1's and the noise probe's
// per-point logic compiled by a C++ compiler (-ffp-contract=off), so the
// CPU tests can hold it against native/golden_noise.json, the plain torch
// noise and the JAX package before the kernel runs on the card.  Each entry
// takes its launcher's arguments (terrain.cu) minus the stream; W1's runs
// the kernel's reduction with a loop over the 32 lanes of a word in place
// of the ballot and the warp reductions.
#include "terrain.cuh"

// W1 (terrain.cu::vx_terrain_slab) on the host.
extern "C" int vx_terrain_slab_host(int z0, int factor, int chunks_x, int chunks_y, int wpb,
                                    int brick_layout, int octaves, unsigned char* occ, int* bmin,
                                    int* bmax, int* words) {
  const vx::SlabParams S = {z0, factor, chunks_x, wpb, brick_layout, octaves};
  for (int c = 0; c < chunks_x * chunks_y; ++c) {
    int lo[3] = {factor, factor, factor}, hi[3] = {-1, -1, -1};
    for (int w = 0; w < wpb; ++w) {
      unsigned int word = 0;
      for (int lane = 0; lane < 32; ++lane) {
        int l[3];
        if (!vx::slab_bit(S, c, 32 * w + lane, l)) continue;
        word |= 1u << lane;
        for (int k = 0; k < 3; ++k) {
          lo[k] = l[k] < lo[k] ? l[k] : lo[k];
          hi[k] = l[k] > hi[k] ? l[k] : hi[k];
        }
      }
      words[(long long)c * wpb + w] = (int)word;
    }
    const bool o = hi[0] >= 0;
    occ[c] = (unsigned char)o;
    for (int k = 0; k < 3; ++k) {
      bmin[3 * c + k] = o ? lo[k] : 0;
      bmax[3 * c + k] = o ? hi[k] : -1;
    }
  }
  return 0;
}

// The noise probe (terrain.cu::vx_noise_points) on the host.
extern "C" int vx_noise_points_host(int kind, int n, const void* in, float scale, int seed,
                                    int octaves, float lacunarity, float decay, float* fout,
                                    unsigned int* uout) {
  const vx::NoiseArgs A = {kind, in, scale, seed, octaves, lacunarity, decay, fout, uout};
  for (int i = 0; i < n; ++i) vx::noise_point(A, i);
  return 0;
}
