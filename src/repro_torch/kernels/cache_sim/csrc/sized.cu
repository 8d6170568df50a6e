// cache_sim/sized: S same-shape request traces through one size-aware cache policy, for
// Hopper (sm_90a): gdsf in object-count mode, and lru, lfu, plfu, plfua and gdsf under a
// byte budget over a per-object size row.
//
// Replaces the SIZED paths of the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py:187 (`base_step`, l.320: the bounded multi-victim
// `evict_body`, l.365, and gdsf's score row and aging credit). It computes what they compute:
// * gdsf scores a request H = L + (freq << 8) // size after its frequency bump; the victim
//   is the cached id of least score (ties to the lowest id), and the credit L ratchets to
//   each victim's score. All int32, wrapping and flooring as the reference's.
// * Under a byte budget an admitted miss evicts argmins of its policy's key (lru: stamps
//   t+1; lfu/plfu/plfua: freq; gdsf: score) until it fits, the cache is empty or
//   `max_victims` victims are gone, then inserts only if it fits; an object larger than the
//   whole budget evicts nothing. lfu zeroes each victim's count.
//
// What bounds it on this card: as cache_sim.cu, the chain of T dependent steps; byte mode
// takes one heap pop a victim, so its time follows evictions. The design is cache_sim.cu's:
// * One block of one warp a sample, thread 0 runs the trace with no block barrier in the loop.
// * Victims are pops of the residents' heap (ResidentHeap, cache_sim_common.cuh) keyed by the
//   policy's key; gdsf's re-price of a hit moves its id up or down (a wrapped sum can lower
//   it). The byte loop pops until x fits, the cache is empty or `max_victims` victims are
//   gone, and stops at the first iteration without a victim, as the reference's remaining
//   iterations change nothing. Order within a step: the victims, then x's bump and re-price
//   under the post-eviction credit, then x's push.
// * The heap's slots are the most ids the cache can hold (the wrapper's `heap_plan`: the
//   capacity, or cap_bytes // min(sizes) in byte mode, at most N; N for gdsf, whose scores can
//   reach INT_MAX, where the reference's victim may be an id that is not cached and the cache
//   may then outgrow its count). The heap starts in shared memory and moves to device memory
//   only if it outgrows the slots there (no grid case does); `pos` and `freq` lie in shared
//   memory where all the slots fit beside them, otherwise in device buffers in L2, and thread
//   0 loads the next request's slot, count and size one step ahead.
// * gdsf needs no score row: a cached id's score is its heap key, and the only score of an id
//   not cached that the program reads is id 0's (the victim of an empty heap), which a
//   register keeps.
// * Thread 0 owns the step's scalars (count, resident bytes, the credit L, the insert
//   count, the bytes of the requests that hit). Telemetry (telemetry.cuh) when the template
//   asks for it: hit and miss bytes are the request's size; each victim counts.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

constexpr int kLru = 0;
constexpr int kLfu = 1;
constexpr int kPlfua = 3;  // kPlfu = 2 needs no case of its own
constexpr int kGdsf = 4;
constexpr int kGdsfShift = 8;  // registry.GDSF_SHIFT
constexpr int kRows = 2;       // pos, freq

template <bool kBytes, bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kWarp)
sized_kernel(const int* __restrict__ traces, const int* __restrict__ sizes, int trace_len,
             int n_objects, int kind, int capacity, int hot_size, int cap_bytes,
             int max_victims, int* __restrict__ hits, int* __restrict__ inserts,
             long long* __restrict__ hit_bytes, int* freq_all, unsigned char* cache_all,
             int* pos_all, unsigned long long* device_slots, HeapLayout layout, TelArgs tel_args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t s = blockIdx.x;
  const size_t n = n_objects;
  const int* trace = traces + s * trace_len;
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(smem);
  int* rows = reinterpret_cast<int*>(slots + layout.shared_slots);
  int* pos = layout.rows_shared ? rows : pos_all + s * n;
  int* freq = layout.rows_shared ? rows + n : freq_all + s * n;
  for (size_t i = threadIdx.x; i < n; i += kWarp) {
    pos[i] = -1;
    if (layout.rows_shared) freq[i] = 0;
  }
  __syncwarp();

  if (threadIdx.x == 0) {
    Telemetry<kTel, kGrouped> tel(tel_args, s, trace_len);
    unsigned long long* device = device_slots ? device_slots + s * layout.slots : nullptr;
    ResidentHeap heap{slots, layout.shared_slots, device, layout.slots, pos};
    int count = 0;
    int nbytes = 0;
    int credit = 0;
    int score0 = 0;  // gdsf: id 0's score
    int n_hits = 0;
    int n_inserts = 0;
    long long n_hit_bytes = 0;
    // the next request's id and slot (heap.watch, heap.watch_pos), count and size, loaded a
    // step ahead, and the id after it
    int freq_ahead = 0;
    int size_ahead = 0;
    if (trace_len > 0) {
      heap.look_ahead(trace[0]);
      freq_ahead = freq[trace[0]];
      size_ahead = __ldg(sizes + trace[0]);
    }
    int x_after = trace_len > 1 ? __ldg(trace + 1) : 0;
    for (int t = 0; t < trace_len; ++t) {
      const int x = heap.watch;
      const int px = heap.watch_pos;
      const int size_x = size_ahead;
      int fx = freq_ahead;
      if (t + 1 < trace_len) {
        heap.look_ahead(x_after);
        freq_ahead = freq[x_after];
        size_ahead = __ldg(sizes + x_after);
        if (t + 2 < trace_len) x_after = __ldg(trace + t + 2);
        if ((t & 31) == 0 && t + 512 < trace_len) prefetch_l2(trace + t + 512);
      } else {
        heap.watch = -1;
      }
      const bool hit = px >= 0;
      const bool admitted = kind != kPlfua || x < hot_size;
      const bool want = !hit && admitted;

      // One victim: the credit ratchets to its score (gdsf), lfu destroys its count. Returns
      // the victim.
      auto evict = [&]() {
        bool cached;
        int key;
        const int victim = heap.victim(cached, key);
        if (cached) heap.pop();
        if (kind == kGdsf) credit = cached ? key : score0;
        if (kind == kLfu) {
          freq[victim] = 0;
          if (victim == heap.watch) freq_ahead = 0;
          if (victim == x) fx = 0;
        }
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

      // a hit or an admitted miss bumps (freq of a non-cached id is its parked count); lru
      // stamps every request; a non-hot plfua miss neither inserts nor bumps
      if (kind == kLru || hit || admitted) {
        int key = kind == kLru ? t + 1 : fx + 1;
        freq[x] = key;
        if (x == heap.watch) freq_ahead = key;
        if (kind == kGdsf) {
          // re-price under the post-eviction credit
          key = wrap_add(credit, floor_div(wrap_shl(key, kGdsfShift), size_x));
          if (x == 0) score0 = key;
        }
        if (hit) heap.rekey(px, key, x);
        else if (insert) heap.push(key, x);
      }
      if (insert) {
        ++count;
        ++n_inserts;
      }
      n_hits += static_cast<int>(hit);
      if (hit) n_hit_bytes += size_x;
      if (kTel) {
        tel.request(x, hit, insert, size_x);
        tel.end_step(t, count);
      }
    }
    hits[s] = n_hits;
    inserts[s] = n_inserts;
    hit_bytes[s] = n_hit_bytes;
  }
  __syncwarp();

  unsigned char* in_cache = cache_all + s * n;
  int* freq_out = freq_all + s * n;
  for (size_t i = threadIdx.x; i < n; i += kWarp) {
    in_cache[i] = pos[i] >= 0;
    if (layout.rows_shared) freq_out[i] = freq[i];
  }
}

}  // namespace

// Launches on `stream` and returns the first CUDA error. `sizes` is the (n_objects,) int32
// size row (every size >= 1); the outputs are zeroed by the caller, `hit_bytes`
// (n_samples,) int64 the bytes of the requests that hit. cap_bytes > 0 selects byte mode.
// `pos`, `heap`, `heap_slots`, `shared_slots` and `rows_shared` are cache_sim_launch's; the
// telemetry's arguments too (`window` 0 = off).
extern "C" int sized_launch(const int* traces, const int* sizes, int* hits, int* inserts,
                            long long* hit_bytes, int* freq, unsigned char* in_cache, int* pos,
                            unsigned long long* heap, int* series, const int* groups,
                            int* resident, int n_samples, int trace_len, int n_objects, int kind,
                            int capacity, int hot_size, int cap_bytes, int max_victims,
                            int heap_slots, int shared_slots, int rows_shared, int window,
                            int n_groups, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TelArgs tel{series, groups, resident, window, n_groups};
  const HeapLayout layout{heap_slots, shared_slots, rows_shared};
  const size_t bytes = heap_shared_bytes(layout, n_objects, kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto in_bytes) {
    with_telemetry(tel, [&](auto on, auto grouped) {
      err = launch_heap_kernel(
          sized_kernel<decltype(in_bytes)::value, decltype(on)::value, decltype(grouped)::value>,
          n_samples, kWarp, bytes, st, traces, sizes, trace_len, n_objects, kind, capacity,
          hot_size, cap_bytes, max_victims, hits, inserts, hit_bytes, freq, in_cache, pos, heap,
          layout, tel);
    });
  };
  if (cap_bytes > 0) launch(std::true_type{});
  else launch(std::false_type{});
  return static_cast<int>(err);
}
