// cache_sim/plfua_dyn: S same-shape request traces through PLFU with a sketch-refreshed hot
// set (dynamic PLFUA), for Hopper (sm_90a).
//
// Replaces the plfua_dyn program of the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py (its `base_step` lines for plfua_dyn, the
// chunked loop over the trace, and `_refresh_hot`):
// * Each step feeds the id to a 4 x width count-min sketch, then runs PLFU with admission
//   `hot[x] | hit`: an admitted miss inserts (evicting the least-freq cached id, ties to
//   the lowest id, when full), and hits and admitted misses bump freq[x], which for a
//   non-cached id is its parked count.
// * Under a byte budget (a second entry point, `plfua_dyn_bytes_launch`) an admitted miss
//   evicts least-freq cached ids until it fits, the cache is empty or `max_victims` victims
//   are gone, and inserts only if it fits (the loop `evict_bytes` shared with sized.cu).
// * After every whole `refresh` requests (at step (c+1)*refresh - 1; a partial tail
//   period never refreshes) the hot set becomes the top `hot_k` ids by sketch estimate,
//   estimate descending and ties to the lowest id, and the sketch halves.
//
// Design (one block per sample; thread 0 owns the step's scalars and writes; one
// __syncthreads_or a step hands out whether an eviction is needed, one per victim-loop
// iteration in byte mode):
// * Bucket indices are lowbias32 of the id in uint32_t, computed where needed: no tables.
// * State in device buffers: freq and in_cache (the zeroed outputs), the sketch rows
//   (zeroed, 4 x width int32), the hot mask (one byte an id, set to the prefix
//   [0, hot_k) by the kernel) and an N-int estimate scratch.
// * The exact top-k without a sort: estimate every id into the scratch (and the block
//   max), binary-search the threshold v* = the largest v with #(est >= v) >= hot_k by
//   block-wide counts, then binary-search the id bound b so that the ids with est == v*
//   below b fill the rest of the quota: hot = est > v* or (est == v* and id < b). That is
//   the set a stable sort on -est would take first, in about 2 log2(max(T, N)) passes over
//   the scratch.
//
// * Telemetry (telemetry.cuh) when the template asks for it: a refresh counts in the window
//   of its step, with the hot churn counted while the new mask is written (ungrouped by a
//   block-wide sum, per group by atomicAdd into the series).
//
// What bounds it on this card: the chain of T dependent steps (4 sketch updates, a block
// barrier, an O(N) argmin per eviction) as for cache_sim.cu; each refresh adds about
// 4 + 2 log2 N passes over N ids, read from L2.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

// New hot mask = the top hot_k ids by estimate (descending, ties to the lowest id); then
// the rows halve. Called by every thread at step t; ends with a barrier. With kTel it
// returns the ids whose membership changed (to every thread; per group it adds them to
// the series instead and returns 0).
template <bool kTel, bool kGrouped>
__device__ int refresh_hot(int* rows, int width, unsigned char* hot, int* est, int n_objects,
                           int hot_k, int* s_part, const Telemetry<kTel, kGrouped>& tel, int t) {
  int local_max = 0;
  for (int i = threadIdx.x; i < n_objects; i += blockDim.x) {
    const int e = sketch_estimate(rows, width, i);
    est[i] = e;
    local_max = max(local_max, e);
  }
  // the barrier inside orders every estimate (and every read of the rows) before what follows
  const int est_max = block_reduce(local_max, true, s_part);
  for (int i = threadIdx.x; i < kDepth * width; i += blockDim.x) rows[i] >>= 1;

  int v_star = INT_MAX;  // hot_k <= 0: nothing is hot
  int bound = 0;
  if (hot_k > 0) {
    // #(est >= lo) >= hot_k and #(est >= hi) < hot_k
    int lo = 0;
    int hi = est_max + 1;
    while (hi - lo > 1) {
      const int mid = lo + (hi - lo) / 2;
      int c = 0;
      for (int i = threadIdx.x; i < n_objects; i += blockDim.x) c += est[i] >= mid;
      if (block_reduce(c, false, s_part) >= hot_k) lo = mid; else hi = mid;
    }
    v_star = lo;
    int c = 0;
    for (int i = threadIdx.x; i < n_objects; i += blockDim.x) c += est[i] > v_star;
    const int need = hot_k - block_reduce(c, false, s_part);  // >= 1 by the choice of v*
    // the smallest b with #(est == v*, id < b) >= need: #(.., id < lo) < need <= #(.., id < hi)
    lo = 0;
    hi = n_objects;
    while (hi - lo > 1) {
      const int mid = lo + (hi - lo) / 2;
      int e = 0;
      for (int i = threadIdx.x; i < mid; i += blockDim.x) e += est[i] == v_star;
      if (block_reduce(e, false, s_part) >= need) hi = mid; else lo = mid;
    }
    bound = hi;
  }
  int changed = 0;
  for (int i = threadIdx.x; i < n_objects; i += blockDim.x) {
    const unsigned char now = est[i] > v_star || (est[i] == v_star && i < bound);
    if (kTel && hot[i] != now) {
      if (kGrouped) tel.hot_changed(t, i);
      else ++changed;
    }
    hot[i] = now;
  }
  __syncthreads();
  if (kTel && !kGrouped) return block_reduce(changed, false, s_part);
  return 0;
}

template <bool kBytes, bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kMaxThreads)
plfua_dyn_kernel(const int* __restrict__ traces, const int* __restrict__ sizes, int trace_len,
                 int n_objects, int capacity, int hot_k, int refresh, int width, int cap_bytes,
                 int max_victims, int* __restrict__ hits, int* __restrict__ inserts,
                 long long* __restrict__ hit_bytes, int* freq_all, unsigned char* cache_all,
                 int* rows_all, unsigned char* hot_all, int* est_all, TelArgs tel_args) {
  __shared__ int s_key[kMaxThreads / kWarp];
  __shared__ int s_id[kMaxThreads / kWarp];
  const size_t s = blockIdx.x;
  const int* trace = traces + s * trace_len;
  int* freq = freq_all + s * n_objects;
  unsigned char* in_cache = cache_all + s * n_objects;
  int* rows = rows_all + s * kDepth * width;
  unsigned char* hot = hot_all + s * n_objects;
  int* est = est_all + s * n_objects;
  Telemetry<kTel, kGrouped> tel(tel_args, s, trace_len);

  // the prior hot set: the rank prefix [0, hot_k)
  for (int i = threadIdx.x; i < n_objects; i += blockDim.x) hot[i] = i < hot_k;
  __syncthreads();

  int count = 0;  // thread 0's
  int nbytes = 0;  // thread 0's, as the bytes that hit (byte mode)
  long long n_hit_bytes = 0;
  int n_hits = 0;
  int n_inserts = 0;
  int since = 0;  // every thread's: requests since the last refresh
  int x_next = trace_len > 0 ? trace[0] : 0;
  for (int t = 0; t < trace_len; ++t) {
    const int x = x_next;
    if (t + 1 < trace_len) x_next = trace[t + 1];
    bool hit = false;
    bool admitted = false;
    if (threadIdx.x == 0) {
      sketch_add(rows, width, x);
      hit = in_cache[x] != 0;
      admitted = hit || hot[x] != 0;
    }
    const bool want = !hit && admitted;
    if (kBytes) {
      const int size_x = threadIdx.x == 0 ? sizes[x] : 0;
      int no_credit = 0;
      if (kTel) {
        evict_bytes(freq, in_cache, sizes, n_objects, want && size_x <= cap_bytes, size_x,
                    cap_bytes, max_victims, false, false, count, nbytes, no_credit, s_key, s_id,
                    [&tel](int v, bool cached) { tel.evict(v, cached); });
      } else {
        evict_bytes(freq, in_cache, sizes, n_objects, want && size_x <= cap_bytes, size_x,
                    cap_bytes, max_victims, false, false, count, nbytes, no_credit, s_key, s_id);
      }
      if (threadIdx.x == 0) {
        if (admitted) freq[x] += 1;  // a hit or an admitted miss; parked counts persist
        const bool insert = want && wrap_add(nbytes, size_x) <= cap_bytes;
        if (insert) {
          nbytes = wrap_add(nbytes, size_x);
          in_cache[x] = 1;
          ++count;
          ++n_inserts;
        }
        n_hits += static_cast<int>(hit);
        if (hit) n_hit_bytes += size_x;
        if (kTel) tel.request(x, hit, insert, size_x);
      }
    } else {
      const bool need_evict =
          __syncthreads_or(threadIdx.x == 0 && want && count >= capacity) != 0;
      int victim = 0;
      if (need_evict) victim = block_argmin(freq, in_cache, n_objects, s_key, s_id);
      if (threadIdx.x == 0) {
        if (need_evict) {
          // an empty cache's argmin (capacity <= 0) is id 0, not cached: no group's eviction
          if (kTel) tel.evict(victim, in_cache[victim] != 0);
          in_cache[victim] = 0;
          --count;
        }
        if (admitted) freq[x] += 1;  // a hit or an admitted miss; parked counts persist
        if (want) {
          in_cache[x] = 1;
          ++count;
          ++n_inserts;
        }
        n_hits += static_cast<int>(hit);
        if (kTel) tel.request(x, hit, want, 1);
      }
    }
    if (++since == refresh) {
      since = 0;
      __syncthreads();  // thread 0's sketch add of this step before the estimates
      const int churn = refresh_hot(rows, width, hot, est, n_objects, hot_k, s_key, tel, t);
      if (kTel && threadIdx.x == 0) tel.refresh(x, churn);
    }
    if (kTel && threadIdx.x == 0) tel.end_step(t, count);
  }
  if (threadIdx.x == 0) {
    hits[s] = n_hits;
    inserts[s] = n_inserts;
    if (kBytes) hit_bytes[s] = n_hit_bytes;
  }
}

}  // namespace

// Launches one instance of plfua_dyn_kernel; window 0 = no telemetry, n_groups 0 = ungrouped.
template <bool kBytes>
void launch_plfua_dyn(int n_samples, cudaStream_t st, const int* traces, const int* sizes,
                      int trace_len, int n_objects, int capacity, int hot_k, int refresh,
                      int width, int cap_bytes, int max_victims, int* hits, int* inserts,
                      long long* hit_bytes, int* freq, unsigned char* in_cache, int* rows,
                      unsigned char* hot, int* est, TelArgs tel) {
  const dim3 grid(n_samples);
  const dim3 block(block_threads(n_objects));
  with_telemetry(tel, [&](auto on, auto grouped) {
    plfua_dyn_kernel<kBytes, decltype(on)::value, decltype(grouped)::value><<<grid, block, 0, st>>>(
        traces, sizes, trace_len, n_objects, capacity, hot_k, refresh, width, cap_bytes,
        max_victims, hits, inserts, hit_bytes, freq, in_cache, rows, hot, est, tel);
  });
}

// Launches on `stream` and returns cudaGetLastError(). `rows` is (n_samples, 4, width)
// int32, zeroed; `hot` (n_samples, n_objects) bytes and `est` (n_samples, n_objects) int32
// are scratch the kernel initialises; the outputs are zeroed by the caller. The telemetry's
// arguments are cache_sim_launch's (`window` 0 = off).
extern "C" int plfua_dyn_launch(const int* traces, int* hits, int* inserts, int* freq,
                                unsigned char* in_cache, int* rows, unsigned char* hot, int* est,
                                int* series, const int* groups, int* resident, int n_samples,
                                int trace_len, int n_objects, int capacity, int hot_k,
                                int refresh, int width, int window, int n_groups, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_plfua_dyn<false>(n_samples, static_cast<cudaStream_t>(stream), traces, nullptr,
                          trace_len, n_objects, capacity, hot_k, refresh, width, 0, 0, hits,
                          inserts, nullptr, freq, in_cache, rows, hot, est,
                          TelArgs{series, groups, resident, window, n_groups});
  return static_cast<int>(cudaGetLastError());
}

// The byte-budget variant: `sizes` is the (n_objects,) int32 size row (every size >= 1),
// cap_bytes > 0 the budget, max_victims >= 1 the victim bound, `hit_bytes` (n_samples,)
// int64 the bytes of the requests that hit; the rest as above.
extern "C" int plfua_dyn_bytes_launch(const int* traces, const int* sizes, int* hits,
                                      int* inserts, long long* hit_bytes, int* freq,
                                      unsigned char* in_cache, int* rows,
                                      unsigned char* hot, int* est, int* series,
                                      const int* groups, int* resident, int n_samples,
                                      int trace_len, int n_objects, int capacity, int hot_k,
                                      int refresh, int width, int cap_bytes, int max_victims,
                                      int window, int n_groups, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_plfua_dyn<true>(n_samples, static_cast<cudaStream_t>(stream), traces, sizes, trace_len,
                         n_objects, capacity, hot_k, refresh, width, cap_bytes, max_victims,
                         hits, inserts, hit_bytes, freq, in_cache, rows, hot, est,
                         TelArgs{series, groups, resident, window, n_groups});
  return static_cast<int>(cudaGetLastError());
}
