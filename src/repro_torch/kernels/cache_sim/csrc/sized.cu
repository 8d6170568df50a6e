// cache_sim/sized: S same-shape request traces through one size-aware cache policy, for
// Hopper (sm_90a): gdsf in object-count mode, and lru, lfu, plfu, plfua and gdsf under a
// byte budget over a per-object size row.
//
// Replaces the SIZED paths of the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py (`base_step`: the bounded multi-victim
// `evict_body` and gdsf's score row and aging credit). It computes what they compute:
// * gdsf scores a request H = L + (freq << 8) // size after its frequency bump; the victim
//   is the cached id of least score (ties to the lowest id), and the credit L ratchets to
//   each victim's score. All int32, wrapping and flooring as the reference's.
// * Under a byte budget an admitted miss evicts argmins of its policy's key (lru: stamps
//   t+1; lfu/plfu/plfua: freq; gdsf: score) until it fits, the cache is empty or
//   `max_victims` victims are gone, then inserts only if it fits; an object larger than the
//   whole budget evicts nothing. lfu zeroes each victim's count.
//
// Design (one block per sample, as cache_sim.cu):
// * State in device buffers: freq and in_cache (the zeroed outputs) and, for gdsf, the
//   score row in an (S, N) int32 scratch buffer; the (N,) sizes row is read-only input
//   shared by the samples.
// * Thread 0 owns the step's scalars (count, resident bytes, the credit L, the insert
//   count, the bytes of the requests that hit) and its writes. In byte mode each
//   victim-loop iteration starts with one __syncthreads_or(need) (`evict_bytes` in
//   cache_sim_common.cuh), which hands out thread 0's decision and orders its writes
//   before the next argmin; the loop stops at the first iteration without a victim. In
//   object-count mode one __syncthreads_or a step hands out whether an eviction is needed.
//
// What bounds it on this card: as cache_sim.cu, the chain of T dependent steps, each with
// a block barrier, and an O(N) argmin from L2 per victim; byte mode runs one argmin per
// victim, so its time follows evictions, not insertions.

#include "cache_sim_common.cuh"

namespace {

constexpr int kLru = 0;
constexpr int kLfu = 1;
constexpr int kPlfua = 3;  // kPlfu = 2 needs no case of its own
constexpr int kGdsf = 4;
constexpr int kGdsfShift = 8;  // registry.GDSF_SHIFT

template <bool kBytes>
__global__ void __launch_bounds__(kMaxThreads)
sized_kernel(const int* __restrict__ traces, const int* __restrict__ sizes, int trace_len,
             int n_objects, int kind, int capacity, int hot_size, int cap_bytes,
             int max_victims, int* __restrict__ hits, int* __restrict__ inserts,
             long long* __restrict__ hit_bytes, int* freq_all, unsigned char* cache_all,
             int* score_all) {
  __shared__ int s_key[kMaxThreads / kWarp];
  __shared__ int s_id[kMaxThreads / kWarp];
  const size_t s = blockIdx.x;
  const int* trace = traces + s * trace_len;
  int* freq = freq_all + s * n_objects;
  unsigned char* in_cache = cache_all + s * n_objects;
  int* score = kind == kGdsf ? score_all + s * n_objects : nullptr;
  int* key = kind == kGdsf ? score : freq;

  int count = 0;  // thread 0's, as the rest below
  int nbytes = 0;
  int credit = 0;
  int n_hits = 0;
  int n_inserts = 0;
  long long n_hit_bytes = 0;
  int x_next = trace_len > 0 ? trace[0] : 0;
  for (int t = 0; t < trace_len; ++t) {
    const int x = x_next;
    if (t + 1 < trace_len) x_next = trace[t + 1];
    bool hit = false;
    bool admitted = false;
    int size_x = 0;
    if (threadIdx.x == 0) {
      hit = in_cache[x] != 0;
      admitted = kind != kPlfua || x < hot_size;
      size_x = sizes[x];
    }
    const bool want = !hit && admitted;
    bool insert = want;
    if (kBytes) {
      evict_bytes(key, in_cache, sizes, n_objects, want && size_x <= cap_bytes, size_x, cap_bytes,
                  max_victims, kind == kLfu, kind == kGdsf, count, nbytes, credit, s_key, s_id);
      insert = want && wrap_add(nbytes, size_x) <= cap_bytes;
      if (insert) nbytes = wrap_add(nbytes, size_x);
    } else {
      const bool need_evict =
          __syncthreads_or(threadIdx.x == 0 && want && count >= capacity) != 0;
      if (need_evict) {
        const int victim = block_argmin(key, in_cache, n_objects, s_key, s_id);
        if (threadIdx.x == 0) {
          if (kind == kGdsf) credit = score[victim];  // the credit ratchets to the victim's H
          in_cache[victim] = 0;
          if (kind == kLfu) freq[victim] = 0;
          --count;
        }
      }
    }
    if (threadIdx.x == 0) {
      if (kind == kLru) {
        freq[x] = t + 1;
      } else if (hit || admitted) {
        // a hit or an admitted miss bumps; freq of a non-cached id is its parked count
        const int f = freq[x] + 1;
        freq[x] = f;
        // re-price under the post-eviction credit
        if (kind == kGdsf) {
          score[x] = wrap_add(credit, floor_div(wrap_shl(f, kGdsfShift), size_x));
        }
      }
      if (insert) {
        in_cache[x] = 1;
        ++count;
        ++n_inserts;
      }
      n_hits += static_cast<int>(hit);
      if (hit) n_hit_bytes += size_x;
    }
  }
  if (threadIdx.x == 0) {
    hits[s] = n_hits;
    inserts[s] = n_inserts;
    hit_bytes[s] = n_hit_bytes;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). `sizes` is the (n_objects,) int32
// size row (every size >= 1); `score` is (n_samples, n_objects) int32, zeroed (read only by
// gdsf); the outputs are zeroed by the caller, `hit_bytes` (n_samples,) int64 the bytes of
// the requests that hit. cap_bytes > 0 selects byte mode.
extern "C" int sized_launch(const int* traces, const int* sizes, int* hits, int* inserts,
                            long long* hit_bytes, int* freq, unsigned char* in_cache, int* score,
                            int n_samples, int trace_len, int n_objects, int kind, int capacity,
                            int hot_size, int cap_bytes, int max_victims, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_samples);
  const dim3 block(block_threads(n_objects));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap_bytes > 0) {
    sized_kernel<true><<<grid, block, 0, st>>>(traces, sizes, trace_len, n_objects, kind, capacity,
                                               hot_size, cap_bytes, max_victims, hits, inserts,
                                               hit_bytes, freq, in_cache, score);
  } else {
    sized_kernel<false><<<grid, block, 0, st>>>(traces, sizes, trace_len, n_objects, kind,
                                                capacity, hot_size, cap_bytes, max_victims, hits,
                                                inserts, hit_bytes, freq, in_cache, score);
  }
  return static_cast<int>(cudaGetLastError());
}
