// The grid of a persistent launch (K1 in bigtrace.cu, K4 in bmtrace.cu,
// K4-slab in zslab.cu): as many blocks as the card holds at once, SMs x the
// kernel's resident blocks at its shared-memory size.  The runtime is asked
// once a process for each kernel, device and shared-memory size, not on
// every launch: the three queries (SM count, the shared-memory attribute,
// the occupancy calculator) cost the host more than the rest of a launch.
// Host code.
#pragma once

#include <mutex>

#include <cuda_runtime.h>

namespace vx {

// One kernel's answers; the launcher keeps one as a static local.
struct GridCache {
  static constexpr int SLOTS = 16;
  std::mutex mu;
  int used = 0;
  int dev[SLOTS];
  size_t smem[SLOTS];
  int sms[SLOTS];
  int per_sm[SLOTS];
};

// *sms the current device's SM count, *per_sm the resident blocks an SM of
// `kernel` at `threads` and `smem` bytes of dynamic shared memory (allowed
// above 48 KB first); cudaErrorInvalidConfiguration if not one block fits.
template <class Kernel>
cudaError_t resident_blocks(GridCache& cache, Kernel kernel, int threads, size_t smem, int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int k = 0; k < cache.used; ++k) {
    if (cache.dev[k] == dev && cache.smem[k] == smem) {
      *sms = cache.sms[k];
      *per_sm = cache.per_sm[k];
      return cudaSuccess;
    }
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (cache.used < GridCache::SLOTS) {
    cache.dev[cache.used] = dev;
    cache.smem[cache.used] = smem;
    cache.sms[cache.used] = *sms;
    cache.per_sm[cache.used] = *per_sm;
    ++cache.used;
  }
  return cudaSuccess;
}

}  // namespace vx
