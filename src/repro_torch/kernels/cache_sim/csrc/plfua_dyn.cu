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
//   are gone, and inserts only if it fits; an object larger than the whole budget evicts
//   nothing.
// * After every whole `refresh` requests (at step (c+1)*refresh - 1; a partial tail
//   period never refreshes) the hot set becomes the top `hot_k` ids by sketch estimate,
//   estimate descending and ties to the lowest id, and the sketch halves.
//
// What bounds it on this card: the T steps of a sample form one chain of dependent steps
// (latency, not bytes or operations); each refresh adds about 4 + 2 log2 N passes of the
// block over N ids. The design follows the reference's own chunks:
//
// * One block of kThreads threads a sample. The block loops over the periods: in each,
//   thread 0 alone runs the period's steps with no barrier, as cache_sim.cu's thread 0 does;
//   then the block meets at one barrier (thread 0's sketch adds before the estimates), runs
//   the refresh, and meets again at its end. Every thread reaches the same barriers.
// * Victims: the top of the residents' heap keyed on freq (ResidentHeap in
//   cache_sim_common.cuh), the reference's masked argmin with its ties to the lowest id; a
//   hit re-keys x, an admitted miss pushes it and a victim is a pop. The byte loop pops
//   until x fits, the cache is empty or `max_victims` victims are gone, and stops at the
//   first iteration without a victim, as the reference's remaining iterations change
//   nothing. A refresh changes the hot mask and the sketch, never a resident's key, so the
//   heap needs nothing then.
// * Dynamic shared memory, as the wrapper's `heap_plan` chose, in its order: the heap's
//   slots, then the sketch rows (4 x width int32, four read-modify-writes a request), then
//   the hot mask (a byte an id), then the rows (pos, freq; 8 B an id), each where it fits;
//   a heap that cannot lie there whole (byte mode's slots) comes after the sketch and takes
//   what is left. What does not fit lies in (S, ...) device buffers that stay in L2, each
//   reached through one pointer chosen at the start. The refresh's estimate scratch (N
//   ints) is a device buffer.
// * Thread 0 loads the next request's slot, count, hot byte, size and buckets a step ahead
//   within a period (lowbias32 of the id in uint32_t: no tables).
// * The exact top-k without a sort: estimate every id into the scratch (and the block
//   max), binary-search the threshold v* = the largest v with #(est >= v) >= hot_k by
//   block-wide counts, then binary-search the id bound b so that the ids with est == v*
//   below b fill the rest of the quota: hot = est > v* or (est == v* and id < b). That is
//   the set a stable sort on -est would take first, in about 2 log2(max(T, N)) passes over
//   the scratch.
// * `in_cache` is written once at the end, from `pos` >= 0; `freq` is copied out when it
//   lived in shared memory.
// * Telemetry (telemetry.cuh) when the template asks for it: a refresh counts in the window
//   of its step, with the hot churn counted while the new mask is written (ungrouped by a
//   block-wide sum, per group by atomicAdd into the series).
//
// It still uses only S of the 132 SMs a launch.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

constexpr int kRows = 2;  // pos, freq
// Thread 0 runs the steps, the whole block the refresh. 256 threads leave thread 0 all the
// registers it can use (__launch_bounds__(1024) would cap it at 64) and still give a refresh
// at N = 100,000 about 391 ids a thread a pass.
constexpr int kThreads = 256;

// The hot mask: a byte an id, in whole warps of bytes (the ids past N stay out of the set).
struct HotMask {
  unsigned char* byte;

  // Bytes of a mask of n ids.
  __host__ __device__ static int bytes(int n) { return (n + kWarp - 1) / kWarp * kWarp; }

  __device__ __forceinline__ bool get(int i) const { return byte[i] != 0; }

  // Called by every lane of a warp, lane l for id base + l (base a multiple of 32): each sets
  // its id to `now` and learns whether it changed.
  __device__ __forceinline__ bool set_warp(int base, bool now) const {
    unsigned char* b = byte + base + threadIdx.x % kWarp;
    const bool was = *b != 0;
    *b = now;
    return was != now;
  }
};

// New hot mask = the top hot_k ids by estimate (descending, ties to the lowest id); then
// the rows halve. Called by every thread at step t; ends with a barrier. With kTel it
// returns the ids whose membership changed (to every thread; per group it adds them to
// the series instead and returns 0).
template <bool kTel, bool kGrouped>
__device__ int refresh_hot(int* rows, int width, HotMask hot, int* est, int n_objects, int hot_k,
                           int* s_part, const Telemetry<kTel, kGrouped>& tel, int t) {
  int local_max = 0;
  for (int i = threadIdx.x; i < n_objects; i += kThreads) {
    const int e = sketch_estimate(rows, width, i);
    est[i] = e;
    local_max = max(local_max, e);
  }
  // the barrier inside orders every estimate (and every read of the rows) before what follows
  const int est_max = block_reduce(local_max, true, s_part);
  for (int i = threadIdx.x; i < kDepth * width; i += kThreads) rows[i] >>= 1;

  int v_star = INT_MAX;  // hot_k <= 0: nothing is hot
  int bound = 0;
  if (hot_k > 0) {
    // #(est >= lo) >= hot_k and #(est >= hi) < hot_k
    int lo = 0;
    int hi = est_max + 1;
    while (hi - lo > 1) {
      const int mid = lo + (hi - lo) / 2;
      int c = 0;
      for (int i = threadIdx.x; i < n_objects; i += kThreads) c += est[i] >= mid;
      if (block_reduce(c, false, s_part) >= hot_k) lo = mid; else hi = mid;
    }
    v_star = lo;
    int c = 0;
    for (int i = threadIdx.x; i < n_objects; i += kThreads) c += est[i] > v_star;
    const int need = hot_k - block_reduce(c, false, s_part);  // >= 1 by the choice of v*
    // the smallest b with #(est == v*, id < b) >= need: #(.., id < lo) < need <= #(.., id < hi)
    lo = 0;
    hi = n_objects;
    while (hi - lo > 1) {
      const int mid = lo + (hi - lo) / 2;
      int e = 0;
      for (int i = threadIdx.x; i < mid; i += kThreads) e += est[i] == v_star;
      if (block_reduce(e, false, s_part) >= need) hi = mid; else lo = mid;
    }
    bound = hi;
  }
  int changed = 0;
  for (int base = threadIdx.x - threadIdx.x % kWarp; base < n_objects; base += kThreads) {
    const int i = base + threadIdx.x % kWarp;
    const bool now = i < n_objects && (est[i] > v_star || (est[i] == v_star && i < bound));
    const bool flipped = hot.set_warp(base, now);  // ids past N stay out of the set
    if (kTel && flipped) {
      if (kGrouped) tel.hot_changed(t, i);
      else ++changed;
    }
  }
  __syncthreads();
  if (kTel && !kGrouped) return block_reduce(changed, false, s_part);
  return 0;
}

template <bool kBytes, bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
plfua_dyn_kernel(const int* __restrict__ traces, const int* __restrict__ sizes, int trace_len,
                 int n_objects, int capacity, int hot_k, int refresh, int width, int cap_bytes,
                 int max_victims, int* __restrict__ hits, int* __restrict__ inserts,
                 long long* __restrict__ hit_bytes, int* freq_all, unsigned char* cache_all,
                 int* pos_all, unsigned long long* device_slots, int* sketch_all,
                 unsigned char* hot_all, int* est_all, HeapLayout layout, int sketch_shared,
                 int hot_shared, TelArgs tel_args) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_part[kThreads / kWarp];
  const size_t s = blockIdx.x;
  const size_t n = n_objects;
  const int cells = kDepth * width;
  const size_t mask_bytes = HotMask::bytes(n_objects);
  const int* trace = traces + s * trace_len;
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(smem);
  int* after_slots = reinterpret_cast<int*>(slots + layout.shared_slots);
  int* pos = layout.rows_shared ? after_slots : pos_all + s * n;
  int* freq = layout.rows_shared ? after_slots + n : freq_all + s * n;
  int* shared_sketch = after_slots + (layout.rows_shared ? kRows * n : 0);
  int* rows = sketch_shared ? shared_sketch : sketch_all + s * cells;
  unsigned char* shared_hot =
      reinterpret_cast<unsigned char*>(shared_sketch + (sketch_shared ? cells : 0));
  const HotMask hot{hot_shared ? shared_hot : hot_all + s * mask_bytes};
  int* est = est_all + s * n;
  for (size_t i = threadIdx.x; i < n; i += kThreads) {
    pos[i] = -1;
    if (layout.rows_shared) freq[i] = 0;
  }
  if (sketch_shared) {
    for (int i = threadIdx.x; i < cells; i += kThreads) rows[i] = 0;
  }
  // the prior hot set: the rank prefix [0, hot_k)
  for (int base = threadIdx.x - threadIdx.x % kWarp; base < n_objects; base += kThreads) {
    const int i = base + threadIdx.x % kWarp;
    hot.set_warp(base, i < n_objects && i < hot_k);
  }
  __syncthreads();

  Telemetry<kTel, kGrouped> tel(tel_args, s, trace_len);
  unsigned long long* device = device_slots ? device_slots + s * layout.slots : nullptr;
  ResidentHeap heap{slots, layout.shared_slots, device, layout.slots, pos};
  int count = 0;  // thread 0's, as the rest of the steps' state
  int nbytes = 0;
  int n_hits = 0;
  int n_inserts = 0;
  long long n_hit_bytes = 0;
  for (int t0 = 0; t0 < trace_len;) {
    const int t1 = refresh < trace_len - t0 ? t0 + refresh : trace_len;
    const bool whole = t1 - t0 == refresh;  // the same in every thread
    if (threadIdx.x == 0) {
      // the next request's id, slot (heap.watch, heap.watch_pos), count, hot byte, size and
      // buckets, a step ahead within the period, and the id after it
      int freq_ahead = freq[trace[t0]];
      bool hot_ahead = hot.get(trace[t0]);
      int size_ahead = kBytes ? __ldg(sizes + trace[t0]) : 1;
      int bx_ahead[kDepth];
      buckets_of(trace[t0], width, bx_ahead);
      heap.look_ahead(trace[t0]);
      int x_after = t0 + 1 < t1 ? __ldg(trace + t0 + 1) : 0;
      for (int t = t0; t < t1; ++t) {
        const int x = heap.watch;
        const int px = heap.watch_pos;
        const int fx = freq_ahead;
        const bool hx = hot_ahead;
        const int size_x = size_ahead;
        int bx[kDepth];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) bx[d] = bx_ahead[d];
        if (t + 1 < t1) {
          heap.look_ahead(x_after);
          freq_ahead = freq[x_after];
          hot_ahead = hot.get(x_after);
          if (kBytes) size_ahead = __ldg(sizes + x_after);
          buckets_of(x_after, width, bx_ahead);
          if (t + 2 < t1) x_after = __ldg(trace + t + 2);
          if ((t & 31) == 0 && t + 512 < trace_len) prefetch_l2(trace + t + 512);
        } else {
          heap.watch = -1;
        }
#pragma unroll
        for (int d = 0; d < kDepth; ++d) rows[bx[d]] += 1;  // the sketch add
        const bool hit = px >= 0;
        const bool admitted = hit || hx;
        const bool want = !hit && admitted;

        // One victim, returned: the heap's top (id 0, not cached, from an empty heap).
        auto evict = [&]() {
          bool cached;
          int key;
          const int victim = heap.victim(cached, key);
          if (cached) heap.pop();
          if (kTel) tel.evict(victim, cached);
          --count;
          return victim;
        };

        bool insert = want;
        if (kBytes) {
          if (want && size_x <= cap_bytes) {
            for (int victims = 0;
                 victims < max_victims && wrap_add(nbytes, size_x) > cap_bytes && count > 0;
                 ++victims) {
              nbytes = wrap_sub(nbytes, __ldg(sizes + evict()));
            }
          }
          insert = want && wrap_add(nbytes, size_x) <= cap_bytes;
          if (insert) nbytes = wrap_add(nbytes, size_x);
        } else if (want && count >= capacity) {
          evict();
        }
        // a hit or an admitted miss bumps; parked counts persist (a victim keeps its count)
        if (admitted) {
          const int key = fx + 1;
          freq[x] = key;
          if (x == heap.watch) freq_ahead = key;
          if (hit) heap.sift_down(px, heap_entry(key, x));
          else if (insert) heap.push(key, x);
        }
        if (insert) {
          ++count;
          ++n_inserts;
        }
        n_hits += static_cast<int>(hit);
        if (kBytes && hit) n_hit_bytes += size_x;
        if (kTel) {
          tel.request(x, hit, insert, size_x);
          // a whole period's last step ends after its refresh
          if (!whole || t + 1 < t1) tel.end_step(t, count);
        }
      }
    }
    if (whole) {
      __syncthreads();  // thread 0's sketch adds of the period before the estimates
      const int churn = refresh_hot(rows, width, hot, est, n_objects, hot_k, s_part, tel, t1 - 1);
      if (kTel && threadIdx.x == 0) {
        tel.refresh(trace[t1 - 1], churn);
        tel.end_step(t1 - 1, count);
      }
    }
    t0 = t1;
  }
  if (threadIdx.x == 0) {
    hits[s] = n_hits;
    inserts[s] = n_inserts;
    if (kBytes) hit_bytes[s] = n_hit_bytes;
  }
  __syncthreads();

  unsigned char* in_cache = cache_all + s * n;
  int* freq_out = freq_all + s * n;
  for (size_t i = threadIdx.x; i < n; i += kThreads) {
    in_cache[i] = pos[i] >= 0;
    if (layout.rows_shared) freq_out[i] = freq[i];
  }
}

// Launches one instance of plfua_dyn_kernel: window 0 = no telemetry, n_groups 0 = ungrouped.
// Returns the first CUDA error.
template <bool kBytes>
int launch_plfua_dyn(int device, void* stream, const int* traces, const int* sizes, int* hits,
                     int* inserts, long long* hit_bytes, int* freq, unsigned char* in_cache,
                     int* pos, unsigned long long* heap, int* sketch_rows, unsigned char* hot,
                     int* est,
                     TelArgs tel, int n_samples, int trace_len, int n_objects, int capacity,
                     int hot_k, int refresh, int width, int cap_bytes, int max_victims,
                     HeapLayout layout, int sketch_shared, int hot_shared) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes =
      heap_shared_bytes(layout, n_objects, kRows) +
      (sketch_shared ? static_cast<size_t>(kDepth) * width * sizeof(int) : 0) +
      (hot_shared ? static_cast<size_t>(HotMask::bytes(n_objects)) : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_telemetry(tel, [&](auto on, auto grouped) {
    err = launch_heap_kernel(
        plfua_dyn_kernel<kBytes, decltype(on)::value, decltype(grouped)::value>, n_samples,
        kThreads, bytes, st, traces, sizes, trace_len, n_objects, capacity, hot_k, refresh, width,
        cap_bytes, max_victims, hits, inserts, hit_bytes, freq, in_cache, pos, heap, sketch_rows,
        hot, est, layout, sketch_shared, hot_shared, tel);
  });
  return static_cast<int>(err);
}

}  // namespace

// Launches on `stream` and returns the first CUDA error: a launch the runtime rejects never
// runs, so the caller must check this code. `heap_slots`, `shared_slots`, `rows_shared`,
// `sketch_shared` and `hot_shared` are the wrapper's `heap_plan`: `pos` is an (n_samples,
// n_objects) int32 scratch where the rows lie in device memory, `heap` an (n_samples,
// heap_slots) uint64 one where a heap can outgrow its shared slots, `rows` the zeroed
// (n_samples, 4, width) int32 sketch where it lies in device memory, and `hot` an
// (n_samples, 32 * ceil(n_objects / 32)) byte scratch where the hot mask does (else each is
// null); `est` is an (n_samples, n_objects) int32 scratch. The kernel initialises every
// scratch but the device sketch; the other outputs are zeroed by the caller. The
// telemetry's arguments are cache_sim_launch's (`window` 0 = off).
extern "C" int plfua_dyn_launch(const int* traces, int* hits, int* inserts, int* freq,
                                unsigned char* in_cache, int* pos, unsigned long long* heap,
                                int* rows, unsigned char* hot, int* est, int* series,
                                const int* groups, int* resident, int n_samples, int trace_len,
                                int n_objects, int capacity, int hot_k, int refresh, int width,
                                int heap_slots, int shared_slots, int rows_shared,
                                int sketch_shared, int hot_shared, int window, int n_groups,
                                int device, void* stream) {
  return launch_plfua_dyn<false>(
      device, stream, traces, nullptr, hits, inserts, nullptr, freq, in_cache, pos, heap, rows,
      hot, est, TelArgs{series, groups, resident, window, n_groups}, n_samples, trace_len,
      n_objects, capacity, hot_k, refresh, width, 0, 0,
      HeapLayout{heap_slots, shared_slots, rows_shared}, sketch_shared, hot_shared);
}

// The byte-budget variant: `sizes` is the (n_objects,) int32 size row (every size >= 1),
// cap_bytes > 0 the budget, max_victims >= 1 the victim bound, `hit_bytes` (n_samples,)
// int64 the bytes of the requests that hit; the rest as above.
extern "C" int plfua_dyn_bytes_launch(const int* traces, const int* sizes, int* hits,
                                      int* inserts, long long* hit_bytes, int* freq,
                                      unsigned char* in_cache, int* pos,
                                      unsigned long long* heap, int* rows, unsigned char* hot,
                                      int* est, int* series, const int* groups, int* resident,
                                      int n_samples, int trace_len, int n_objects, int capacity,
                                      int hot_k, int refresh, int width, int cap_bytes,
                                      int max_victims, int heap_slots, int shared_slots,
                                      int rows_shared, int sketch_shared, int hot_shared,
                                      int window, int n_groups, int device, void* stream) {
  return launch_plfua_dyn<true>(
      device, stream, traces, sizes, hits, inserts, hit_bytes, freq, in_cache, pos, heap, rows,
      hot, est, TelArgs{series, groups, resident, window, n_groups}, n_samples, trace_len,
      n_objects, capacity, hot_k, refresh, width, cap_bytes, max_victims,
      HeapLayout{heap_slots, shared_slots, rows_shared}, sketch_shared, hot_shared);
}
