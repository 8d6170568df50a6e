// Device helpers shared by the cache_sim programs (cache_sim.cu, wlfu.cu, tinylfu.cu,
// plfua_dyn.cu): the block-wide lexicographic argmin that picks a victim, block-wide sums,
// and the count-min sketch's lowbias32 hashing.
//
// Every program runs one thread block per sample with blockDim.x a multiple of 32, and
// calls these helpers from all threads of the block (each holds __syncthreads()).

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;

// (ka, ia) precedes (kb, ib): smaller key, then lower id.
__device__ __forceinline__ bool precedes(int ka, int ia, int kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ void warp_min(int& key, int& id) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const int k2 = __shfl_down_sync(0xffffffffu, key, off);
    const int i2 = __shfl_down_sync(0xffffffffu, id, off);
    if (precedes(k2, i2, key, id)) {
      key = k2;
      id = i2;
    }
  }
}

// argmin of where(in_cache, key, INT_MAX) with ties to the lowest id: a non-cached id
// competes as (INT_MAX, id), so an empty cache gives id 0, as the reference's argmin does.
// The result is valid in thread 0 only. Every thread's reads of key and in_cache happen
// before the block barrier inside, so thread 0 may write them once this returns.
__device__ int block_argmin(const int* key, const unsigned char* in_cache, int n,
                            int* s_key, int* s_id) {
  int best_k = INT_MAX;
  int best_i = INT_MAX;  // above every real id, so any real candidate replaces it
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = in_cache[i] ? key[i] : INT_MAX;
    if (precedes(k, i, best_k, best_i)) {
      best_k = k;
      best_i = i;
    }
  }
  warp_min(best_k, best_i);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) {
    s_key[warp] = best_k;
    s_id[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / kWarp;
    best_k = lane < n_warps ? s_key[lane] : INT_MAX;
    best_i = lane < n_warps ? s_id[lane] : INT_MAX;
    warp_min(best_k, best_i);
  }
  return best_i;
}

// Sum (max when `take_max`) of one int per thread, returned to every thread. `s_part`
// holds kMaxThreads / kWarp ints. The barrier before the return lets the next call reuse
// `s_part`, and orders every thread's memory writes before the call against every
// thread's reads after it.
__device__ int block_reduce(int v, bool take_max, int* s_part) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const int o = __shfl_down_sync(0xffffffffu, v, off);
    v = take_max ? max(v, o) : v + o;
  }
  if (threadIdx.x % kWarp == 0) s_part[threadIdx.x / kWarp] = v;
  __syncthreads();
  int total = s_part[0];
  for (int w = 1; w < static_cast<int>(blockDim.x) / kWarp; ++w) {
    total = take_max ? max(total, s_part[w]) : total + s_part[w];
  }
  __syncthreads();
  return total;
}

// ------------------------------------------------------------ count-min sketch hashing
// The reference's sketch module computes these tables host-side in numpy uint32; uint32_t
// arithmetic wraps the same way, so the kernels hash the id where they need a bucket.

constexpr int kDepth = 4;       // sketch rows
constexpr int kBloomDepth = 2;  // doorkeeper hashes

__device__ __forceinline__ uint32_t sketch_salt(int d) {
  return d == 0 ? 0x9E3779B9u : d == 1 ? 0x85EBCA6Bu : d == 2 ? 0xC2B2AE35u : 0x27D4EB2Fu;
}

__device__ __forceinline__ uint32_t bloom_salt(int d) {
  return d == 0 ? 0xB5297A4Du : 0x68E31DA4u;
}

// lowbias32 finalizer (hash-prospector constants).
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// mix32((id + 1) * salt) % modulus: one entry of bucket_table / bloom_table.
__device__ __forceinline__ int salted_index(int id, uint32_t salt, int modulus) {
  return static_cast<int>(mix32((static_cast<uint32_t>(id) + 1u) * salt) %
                          static_cast<uint32_t>(modulus));
}

// Count-min estimate of `id`: min over the kDepth rows (row d at rows + d * width).
__device__ __forceinline__ int sketch_estimate(const int* rows, int width, int id) {
  int est = INT_MAX;
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    est = min(est, rows[d * width + salted_index(id, sketch_salt(d), width)]);
  }
  return est;
}

__device__ __forceinline__ void sketch_add(int* rows, int width, int id) {
#pragma unroll
  for (int d = 0; d < kDepth; ++d) rows[d * width + salted_index(id, sketch_salt(d), width)] += 1;
}

// Threads per block: one per id up to the block's limit, a whole number of warps.
inline int block_threads(int n_objects) {
  const int threads = (n_objects + kWarp - 1) / kWarp * kWarp;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

}  // namespace

// Every library of the cache_sim programs exports this, for the wrapper's error message
// (each library is built from one source that includes this header once).
extern "C" const char* cache_sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
