// cache_sim/wlfu: S same-shape request traces through Window-LFU, for Hopper (sm_90a).
//
// Replaces the wlfu program of the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py (`wlfu_step` and its loop over the trace): the
// frequency of an id is its count among the last `window` requests, kept by a ring of
// those ids that slides *before* the hit test; every miss inserts, evicting the cached id
// of least window frequency (ties to the lowest id) when the cache is full.
//
// Design, as cache_sim.cu's (one block per sample, state in the zeroed output buffers,
// thread 0 applies the step's writes, one __syncthreads_or a step hands out the hit):
// * The ring (`window` ids, -1 = empty) lives in a device buffer the wrapper fills with
//   -1; only thread 0 touches it. The id leaving the window at step t+1 is loaded right
//   after step t's write, so its latency overlaps the rest of the step.
// * Victim: the block-wide lexicographic argmin of cache_sim_common.cuh over `freq`.
//
// What bounds it on this card: as cache_sim.cu, the chain of T dependent steps, each with
// a block barrier, and N compares an eviction read from L2: latency, not bytes or
// operations.

#include "cache_sim_common.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads)
wlfu_kernel(const int* __restrict__ traces, int trace_len, int n_objects, int capacity,
            int window, int* __restrict__ hits, int* __restrict__ inserts, int* freq_all,
            unsigned char* cache_all, int* ring_all) {
  __shared__ int s_key[kMaxThreads / kWarp];
  __shared__ int s_id[kMaxThreads / kWarp];
  const size_t s = blockIdx.x;
  const int* trace = traces + s * trace_len;
  int* freq = freq_all + s * n_objects;
  unsigned char* in_cache = cache_all + s * n_objects;
  int* ring = ring_all + s * window;

  int count = 0;
  int n_hits = 0;
  int ptr = 0;
  int old = threadIdx.x == 0 ? ring[0] : -1;  // the id that leaves the window this step
  int x_next = trace_len > 0 ? trace[0] : 0;
  for (int t = 0; t < trace_len; ++t) {
    const int x = x_next;
    if (t + 1 < trace_len) x_next = trace[t + 1];
    const int next_ptr = ptr + 1 == window ? 0 : ptr + 1;
    if (threadIdx.x == 0) {
      if (old >= 0) freq[old] -= 1;
      ring[ptr] = x;
      old = ring[next_ptr];  // x itself when window == 1
      freq[x] += 1;
    }
    ptr = next_ptr;
    const bool hit = __syncthreads_or(threadIdx.x == 0 && in_cache[x] != 0) != 0;
    const bool need_evict = !hit && count >= capacity;
    int victim = 0;
    if (need_evict) victim = block_argmin(freq, in_cache, n_objects, s_key, s_id);
    if (threadIdx.x == 0) {
      if (need_evict) in_cache[victim] = 0;
      if (!hit) in_cache[x] = 1;
    }
    count += static_cast<int>(!hit) - static_cast<int>(need_evict);
    n_hits += static_cast<int>(hit);
  }
  if (threadIdx.x == 0) {
    hits[s] = n_hits;
    inserts[s] = trace_len - n_hits;  // every miss inserts
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). `ring` is (n_samples, window) int32
// filled with -1; the other outputs are zeroed by the caller.
extern "C" int wlfu_launch(const int* traces, int* hits, int* inserts, int* freq,
                           unsigned char* in_cache, int* ring, int n_samples, int trace_len,
                           int n_objects, int capacity, int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  wlfu_kernel<<<n_samples, block_threads(n_objects), 0, static_cast<cudaStream_t>(stream)>>>(
      traces, trace_len, n_objects, capacity, window, hits, inserts, freq, in_cache, ring);
  return static_cast<int>(cudaGetLastError());
}
