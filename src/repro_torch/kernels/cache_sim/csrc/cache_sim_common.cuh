// Device helpers shared by the cache_sim programs (cache_sim.cu, wlfu.cu, tinylfu.cu,
// plfua_dyn.cu, sized.cu, arc.cu): the block-wide lexicographic argmin that picks a victim
// (over the cached ids, or over any set of ids a mask names), byte mode's bounded
// multi-victim loop, block-wide sums, int32 arithmetic that wraps as the reference's, and
// the count-min sketch's lowbias32 hashing.
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

// The mask of the cached ids (in_cache[i] != 0), and the mask of the ids whose tag is
// `tag` (arc's lists: lst[i] == tag).
struct CachedMask {
  const unsigned char* in_cache;
  __device__ __forceinline__ bool operator()(int i) const { return in_cache[i] != 0; }
};

struct TagMask {
  const unsigned char* lst;
  unsigned char tag;
  __device__ __forceinline__ bool operator()(int i) const { return lst[i] == tag; }
};

// argmin of where(in_set, key, INT_MAX) with ties to the lowest id: an id outside the set
// competes as (INT_MAX, id), so an empty set gives id 0, as the reference's argmin does.
// The result is valid in thread 0 only. Every thread's reads of key and of the mask's
// bytes happen before the block barrier inside, so thread 0 may write them once this
// returns. Warp 0 reads s_key/s_id after that barrier: a second call straight after this
// one (arc's trim, then its demotion) needs a barrier between the two.
template <class Mask>
__device__ int block_argmin_of(const int* key, Mask in_set, int n, int* s_key, int* s_id) {
  int best_k = INT_MAX;
  int best_i = INT_MAX;  // above every real id, so any real candidate replaces it
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = in_set(i) ? key[i] : INT_MAX;
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

// The victim among the cached ids.
__device__ __forceinline__ int block_argmin(const int* key, const unsigned char* in_cache, int n,
                                            int* s_key, int* s_id) {
  return block_argmin_of(key, CachedMask{in_cache}, n, s_key, s_id);
}

// ------------------------------------------------------- int32 as the reference wraps it
// jnp int32 arithmetic wraps; signed overflow is undefined in C++, so these go through
// uint32_t, whose arithmetic wraps, and back.

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_shl(int a, int bits) {
  return static_cast<int>(static_cast<uint32_t>(a) << bits);
}

// a // b rounded toward minus infinity (jnp's and torch's int floor division), for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// ------------------------------------------------------------ byte mode's victim loop
// The reference's `_evict_bytes_loop` (its kernel's `evict_body`): evict the argmin of `key`
// over the cached ids until an object of `size_x` bytes fits in `cap_bytes`, the cache is
// empty, or `max_victims` victims are gone. `want_fits` (thread 0's) is "x wants in and is
// no larger than the whole budget": an object larger than the budget evicts nothing.
// Thread 0 owns `count`, `nbytes` and `credit`. With `destroy` (lfu) a victim's key is
// zeroed; with `ratchet` (gdsf) the credit takes each victim's key.
//
// Each iteration starts with one __syncthreads_or(need): it hands every thread thread 0's
// decision and orders thread 0's writes for the previous victim (in_cache, the zeroed key)
// before the next argmin's reads. `need` can only turn from true to false (nbytes and
// count only fall), so the loop stops at the first iteration without a victim: the
// reference's remaining iterations change nothing. Called by every thread; returns the
// number of victims. Thread 0 calls `on_victim(v)` for each victim (the telemetry's
// per-group eviction count; the default does nothing).
struct NoVictimHook {
  __device__ __forceinline__ void operator()(int) const {}
};

template <class OnVictim = NoVictimHook>
__device__ __forceinline__ int evict_bytes(int* key, unsigned char* in_cache, const int* sizes,
                                           int n, bool want_fits, int size_x, int cap_bytes,
                                           int max_victims, bool destroy, bool ratchet,
                                           int& count, int& nbytes, int& credit, int* s_key,
                                           int* s_id, OnVictim on_victim = OnVictim()) {
  int victims = 0;
  for (; victims < max_victims; ++victims) {
    const bool need = __syncthreads_or(threadIdx.x == 0 && want_fits &&
                                       wrap_add(nbytes, size_x) > cap_bytes && count > 0) != 0;
    if (!need) break;
    const int v = block_argmin(key, in_cache, n, s_key, s_id);
    if (threadIdx.x == 0) {
      if (ratchet) credit = key[v];
      in_cache[v] = 0;
      if (destroy) key[v] = 0;
      --count;
      nbytes = wrap_sub(nbytes, sizes[v]);
      on_victim(v);
    }
  }
  return victims;
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
