// Terrain slab build for Hopper (sm_90a): W1, and a noise probe.
//
// W1 (vx_terrain_slab) computes, for one z-slab of chunks, what
// core/brickmap.py::_slab_to_chunks returns for the slab that
// worldgen/terrain.py::solid_at makes: per chunk its occupancy, its tight
// bounds (bmin, bmax; 0 and -1 for an empty chunk) and its brick words in
// the brick layout's bit order.  core/brickmap.py::
// build_brickmap_terrain_compact runs it slab by slab on the card and keeps
// its torch slot assignment.  It has no TPU kernel to replace: the JAX
// package's build (voxelengine_tpu/core/brickmap.py:284,
// build_brickmap_terrain_compact) runs the same expressions under one
// jax.jit a slab, which XLA fuses into a few loops; eager torch runs each of
// the ~100 ops of an octave as its own kernel over the whole slab in device
// memory (~95 s for the 1024^3 demo world, ~52 min for the 8192x512x8192
// bench world).
//
// What bounds it on this card: operations.  A voxel is 32 octaves of 8
// hashed gradient corners (noise.cuh): 549 integer and float ops an octave
// and 17,608 a voxel as chip_smoke.py::w1_ops_per_voxel counts them,
// against 4 bytes of output per 32 voxels; every operand lives in
// registers.  Measured at 2.2x that bound (76.8 ms a bench-world slab of
// 134M voxels; the bench world in ~20 s, PERF.md).
//
// Design: one block a chunk, 32 * min(8, words per brick) threads.  Lane k
// of a warp computes the voxel of bit 32 w + k of the chunk's brick
// (terrain.cuh::slab_bit, the brick layout's inverse), so one __ballot_sync
// makes word w and lane 0 stores it; the bounds come from per-lane min/max
// of the solid voxels' coordinates, then warp reductions
// (__reduce_min_sync / __reduce_max_sync), then shared-memory atomics over
// the block's warps; thread 0 writes occupancy and bounds.  No dense slab
// ever exists.
//
// The noise probe (vx_noise_points) evaluates one of noise.cuh's functions
// on a flat batch of points; chip_smoke.py holds it against
// native/golden_noise.json and the plain torch noise on the card.
//
// Build: kernels/build.py (nvcc sm_90a, -O3, --fmad=false, no fast-math).
#include <cuda_runtime.h>

#include "terrain.cuh"

namespace {

__global__ void __launch_bounds__(256)
terrain_slab_kernel(vx::SlabParams S, unsigned char* __restrict__ occ, int* __restrict__ bmin,
                    int* __restrict__ bmax, int* __restrict__ words) {
  __shared__ int red[6];  // lo x, y, z; hi x, y, z over the block
  const int c = blockIdx.x, f = S.factor;
  if (threadIdx.x < 3) {
    red[threadIdx.x] = f;
    red[3 + threadIdx.x] = -1;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int lo[3] = {f, f, f}, hi[3] = {-1, -1, -1};
  int* out = words + (long long)c * S.wpb;
  for (int w = warp; w < S.wpb; w += nwarps) {
    int l[3];
    const bool s = vx::slab_bit(S, c, 32 * w + lane, l);
    const unsigned int word = __ballot_sync(0xFFFFFFFFu, s);
    if (s) {
      for (int k = 0; k < 3; ++k) {
        lo[k] = min(lo[k], l[k]);
        hi[k] = max(hi[k], l[k]);
      }
    }
    if (lane == 0) out[w] = (int)word;
  }
  for (int k = 0; k < 3; ++k) {
    lo[k] = __reduce_min_sync(0xFFFFFFFFu, lo[k]);
    hi[k] = __reduce_max_sync(0xFFFFFFFFu, hi[k]);
  }
  if (lane == 0) {
    for (int k = 0; k < 3; ++k) {
      atomicMin(&red[k], lo[k]);
      atomicMax(&red[3 + k], hi[k]);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool o = red[3] >= 0;
    occ[c] = (unsigned char)o;
    for (int k = 0; k < 3; ++k) {
      bmin[3 * c + k] = o ? red[k] : 0;
      bmax[3 * c + k] = o ? red[3 + k] : -1;
    }
  }
}

__global__ void noise_points_kernel(vx::NoiseArgs A, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) vx::noise_point(A, i);
}

}  // namespace

// W1: one z-slab (world rows z0 .. z0 + factor) of chunks_y x chunks_x
// chunks.  Writes occ (one byte a chunk), bmin, bmax (i32[n, 3]) and words
// (i32[n, wpb]), chunks in (cy, cx) row-major order.  Launches on `stream`
// without synchronising; returns cudaGetLastError().
extern "C" int vx_terrain_slab(int z0, int factor, int chunks_x, int chunks_y, int wpb,
                               int brick_layout, int octaves, unsigned char* occ, int* bmin,
                               int* bmax, int* words, void* stream) {
  const int n = chunks_x * chunks_y;
  if (n == 0) return 0;
  const vx::SlabParams S = {z0, factor, chunks_x, wpb, brick_layout, octaves};
  const int threads = 32 * (wpb < 8 ? wpb : 8);
  terrain_slab_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(S, occ, bmin, bmax,
                                                                          words);
  return static_cast<int>(cudaGetLastError());
}

// The noise probe: for each of n points, kind 0 hash_u32 (in: uint32[n],
// uout), 1 random_float (in: uint32[n], fout), 2 perlin_noise(scale, seed)
// (in: f32[n, 3], fout), 3 repeater_perlin(scale, octaves, lacunarity,
// decay) (in: f32[n, 3], fout), 4 terrain_t(octaves) (in: i32[n, 3], fout),
// 5 terrain_solid(octaves) (in: i32[n, 3], uout 0 or 1).
extern "C" int vx_noise_points(int kind, int n, const void* in, float scale, int seed, int octaves,
                               float lacunarity, float decay, float* fout, unsigned int* uout,
                               void* stream) {
  if (n == 0) return 0;
  const vx::NoiseArgs A = {kind, in, scale, seed, octaves, lacunarity, decay, fout, uout};
  noise_points_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(A, n);
  return static_cast<int>(cudaGetLastError());
}
