// cache_sim/tinylfu: S same-shape request traces through TinyLFU, for Hopper (sm_90a).
//
// Replaces the tinylfu program of the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py (`tinylfu_step` with the sketch primitives
// `_bucket_rows`, `_rows_add`, `_rows_estimate`, `_bloom_contains`, `_bloom_set`). Each
// step, in the reference's order:
//   1. sketch add: one counter per row of a 4 x width count-min; with the doorkeeper (a
//      `bloom_bits`-bit bloom filter, 2 hashes) the add happens only if the id was already
//      in the bloom, and the id's bits are then set;
//   2. aging: every `window` requests all counters halve and the bloom clears;
//   3. on a hit freq[x] += 1; on a miss with room the id inserts with freq 1; on a miss
//      into a full cache the id duels the LFU victim (least freq, ties to the lowest id) by
//      post-aging estimate, plus one for post-aging bloom membership with the doorkeeper,
//      and replaces it iff est_x > est_v (the victim's freq is zeroed).
//
// Design (one block per sample; thread 0 owns the step's scalars and writes):
// * Bucket and bloom indices are lowbias32 of the id in uint32_t, computed where needed
//   (x's at the add, the victim's after the argmin): no tables in memory.
// * The sketch rows (4 x width int32) and the bloom (one byte a bit) live in zeroed device
//   buffers: at the paper's N = 100,000 and cap = 25,000 the rows are 1.6 MB a sample, L2-
//   resident but far above a block's shared memory.
// * One __syncthreads_or a step hands every thread whether this step needs a victim (a
//   miss into a full cache); every thread counts `seen` itself, so the aging branch, which
//   holds a block-wide halving pass and a barrier, is uniform across the block.
//
// What bounds it on this card: the victim's O(N) argmin runs on every miss into a full
// cache (not only on evictions, since the duel needs the victim), and the T steps form one
// chain of dependent steps: latency, as for cache_sim.cu.

#include "cache_sim_common.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads)
tinylfu_kernel(const int* __restrict__ traces, int trace_len, int n_objects, int capacity,
               int window, int width, int bloom_bits, int* __restrict__ hits,
               int* __restrict__ inserts, int* freq_all, unsigned char* cache_all,
               int* rows_all, unsigned char* bloom_all) {
  __shared__ int s_key[kMaxThreads / kWarp];
  __shared__ int s_id[kMaxThreads / kWarp];
  const size_t s = blockIdx.x;
  const int* trace = traces + s * trace_len;
  int* freq = freq_all + s * n_objects;
  unsigned char* in_cache = cache_all + s * n_objects;
  int* rows = rows_all + s * kDepth * width;
  unsigned char* bloom = bloom_all + s * bloom_bits;

  int count = 0;  // thread 0's
  int n_hits = 0;
  int n_inserts = 0;
  int seen = 0;  // every thread's: the aging branch must be uniform
  int x_next = trace_len > 0 ? trace[0] : 0;
  for (int t = 0; t < trace_len; ++t) {
    const int x = x_next;
    if (t + 1 < trace_len) x_next = trace[t + 1];
    bool hit = false;
    if (threadIdx.x == 0) {
      bool add = true;
      if (bloom_bits > 0) {
        // doorkeeper: the first touch per window marks the bloom only
        const int b0 = salted_index(x, bloom_salt(0), bloom_bits);
        const int b1 = salted_index(x, bloom_salt(1), bloom_bits);
        add = bloom[b0] != 0 && bloom[b1] != 0;
        bloom[b0] = 1;
        bloom[b1] = 1;
      }
      if (add) sketch_add(rows, width, x);
      hit = in_cache[x] != 0;
    }
    const bool age = ++seen >= window;
    if (age) seen = 0;
    const bool duel = __syncthreads_or(threadIdx.x == 0 && !hit && count >= capacity) != 0;
    if (age) {
      for (int i = threadIdx.x; i < kDepth * width; i += blockDim.x) rows[i] >>= 1;
      for (int i = threadIdx.x; i < bloom_bits; i += blockDim.x) bloom[i] = 0;
      __syncthreads();
    }
    int victim = 0;
    if (duel) victim = block_argmin(freq, in_cache, n_objects, s_key, s_id);
    if (threadIdx.x == 0) {
      if (hit) {
        freq[x] += 1;
        ++n_hits;
      } else {
        bool admit = true;
        if (duel) {
          int est_x = sketch_estimate(rows, width, x);
          int est_v = sketch_estimate(rows, width, victim);
          if (bloom_bits > 0 && !age) {
            // post-aging membership: x's bits were set this step; an aging step cleared all
            est_x += 1;
            est_v += bloom[salted_index(victim, bloom_salt(0), bloom_bits)] != 0 &&
                     bloom[salted_index(victim, bloom_salt(1), bloom_bits)] != 0;
          }
          admit = est_x > est_v;
          if (admit) {
            in_cache[victim] = 0;
            freq[victim] = 0;  // LFU semantics: the victim's count dies with it
            --count;
          }
        }
        if (admit) {
          freq[x] = 1;
          in_cache[x] = 1;
          ++count;
          ++n_inserts;
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    hits[s] = n_hits;
    inserts[s] = n_inserts;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). `rows` is (n_samples, 4, width)
// int32 and `bloom` (n_samples, bloom_bits) bytes (unused when bloom_bits == 0); they and
// the outputs are zeroed by the caller.
extern "C" int tinylfu_launch(const int* traces, int* hits, int* inserts, int* freq,
                              unsigned char* in_cache, int* rows, unsigned char* bloom,
                              int n_samples, int trace_len, int n_objects, int capacity,
                              int window, int width, int bloom_bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  tinylfu_kernel<<<n_samples, block_threads(n_objects), 0, static_cast<cudaStream_t>(stream)>>>(
      traces, trace_len, n_objects, capacity, window, width, bloom_bits, hits, inserts, freq,
      in_cache, rows, bloom);
  return static_cast<int>(cudaGetLastError());
}
