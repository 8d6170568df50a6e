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
// What bounds it on this card: the T steps of a sample form one chain of dependent steps
// (latency, not bytes or operations). The design, as cache_sim.cu's lfu:
//
// * One block of one warp a sample; thread 0 runs the trace with no block barrier in the
//   loop. Every lane counts `seen`, so the aging branch is uniform: the warp halves the
//   rows and clears the bloom together, between two __syncwarp.
// * Victim: the top of a binary min-heap of the cached ids keyed on freq (ResidentHeap in
//   cache_sim_common.cuh), the reference's masked argmin with its ties to the lowest id. A
//   hit re-keys x; the duel reads the top without taking it, since a lost duel leaves the
//   cache as it was; a won duel replaces the top by x with count 1 (one sift from the top
//   in place of a pop and a push). An empty heap (capacity <= 0, nothing cached yet) names
//   id 0, not cached: x is pushed and the cache's count trails its residents, as the
//   reference's does. The heap never holds more than max(capacity, 1) ids (the wrapper's
//   `heap_plan`).
// * Dynamic shared memory, as the wrapper's `heap_plan` chose: the heap's slots first,
//   then the sketch rows (4 x width int32) with the bloom (a byte a bit) and the rows
//   (pos, freq; 8 B an id), each where it fits, in the plan's order; what does not fit
//   lies in (S, ...) device buffers that stay in L2. Each is reached through one pointer
//   chosen at the start.
// * Bucket and bloom indices are lowbias32 of the id in uint32_t; the next request's are
//   computed a step ahead, with its slot and count. The victim is known when the step
//   starts, so its four bucket loads start then, beside x's read-modify-writes (a
//   bucket x shares takes x's add). Aging's halving commutes with the estimates' min, so
//   the duel takes the post-aging estimates as the pre-aging ones shifted; the warp ages
//   the memory after the duel.
// * `in_cache` is written once at the end, from `pos` >= 0; `freq` is copied out when it
//   lived in shared memory.
//
// * Telemetry (telemetry.cuh) when the template asks for it: an aging step is a refresh,
//   in the window of the request that completed the aging window; an empty cache's id 0
//   is an eviction in the ungrouped series (the reference's count) and in no group.
//
// It still uses only S of the 132 SMs a launch.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

constexpr int kRows = 2;  // pos, freq

template <bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kWarp)
tinylfu_kernel(const int* __restrict__ traces, int trace_len, int n_objects, int capacity,
               int window, int width, int bloom_bits, int* __restrict__ hits,
               int* __restrict__ inserts, int* freq_all, unsigned char* cache_all, int* pos_all,
               unsigned long long* device_slots, int* rows_all, unsigned char* bloom_all,
               HeapLayout layout, int sketch_shared, TelArgs tel_args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t s = blockIdx.x;
  const size_t n = n_objects;
  const int cells = kDepth * width;
  const int* trace = traces + s * trace_len;
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(smem);
  int* after_slots = reinterpret_cast<int*>(slots + layout.shared_slots);
  int* pos = layout.rows_shared ? after_slots : pos_all + s * n;
  int* freq = layout.rows_shared ? after_slots + n : freq_all + s * n;
  int* shared_sketch = after_slots + (layout.rows_shared ? kRows * n : 0);
  int* rows = sketch_shared ? shared_sketch : rows_all + s * cells;
  unsigned char* bloom = sketch_shared ? reinterpret_cast<unsigned char*>(shared_sketch + cells)
                                       : bloom_all + s * bloom_bits;
  for (size_t i = threadIdx.x; i < n; i += kWarp) {
    pos[i] = -1;
    if (layout.rows_shared) freq[i] = 0;
  }
  if (sketch_shared) {
    for (int i = threadIdx.x; i < cells; i += kWarp) rows[i] = 0;
    for (int i = threadIdx.x; i < bloom_bits; i += kWarp) bloom[i] = 0;
  }
  __syncwarp();

  Telemetry<kTel, kGrouped> tel(tel_args, s, trace_len);
  unsigned long long* device = device_slots ? device_slots + s * layout.slots : nullptr;
  ResidentHeap heap{slots, layout.shared_slots, device, layout.slots, pos};
  int count = 0;  // thread 0's, as the rest of the step's state
  int n_hits = 0;
  int n_inserts = 0;
  // the next request's id, slot (heap.watch, heap.watch_pos), count, buckets and bloom bits,
  // a step ahead, and the id after it
  int freq_ahead = 0;
  int bx_ahead[kDepth] = {0, 0, 0, 0};
  int kx_ahead[kBloomDepth] = {0, 0};
  int x_after = 0;
  if (threadIdx.x == 0 && trace_len > 0) {
    heap.look_ahead(trace[0]);
    freq_ahead = freq[trace[0]];
    buckets_of(trace[0], width, bx_ahead);
    if (bloom_bits > 0) {
      kx_ahead[0] = salted_index(trace[0], bloom_salt(0), bloom_bits);
      kx_ahead[1] = salted_index(trace[0], bloom_salt(1), bloom_bits);
    }
    x_after = trace_len > 1 ? __ldg(trace + 1) : 0;
  }
  int seen = 0;  // every lane's: the aging branch must be uniform
  for (int t = 0; t < trace_len; ++t) {
    const bool age = ++seen >= window;
    if (age) seen = 0;
    if (threadIdx.x == 0) {
      const int x = heap.watch;
      const int px = heap.watch_pos;
      int fx = freq_ahead;
      int bx[kDepth];
      int kx[kBloomDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) bx[d] = bx_ahead[d];
      kx[0] = kx_ahead[0];
      kx[1] = kx_ahead[1];
      if (t + 1 < trace_len) {
        heap.look_ahead(x_after);
        freq_ahead = freq[x_after];
        buckets_of(x_after, width, bx_ahead);
        if (bloom_bits > 0) {
          kx_ahead[0] = salted_index(x_after, bloom_salt(0), bloom_bits);
          kx_ahead[1] = salted_index(x_after, bloom_salt(1), bloom_bits);
        }
        if (t + 2 < trace_len) x_after = __ldg(trace + t + 2);
        if ((t & 31) == 0 && t + 512 < trace_len) prefetch_l2(trace + t + 512);
      } else {
        heap.watch = -1;
      }
      const bool hit = px >= 0;
      const bool duel = !hit && count >= capacity;
      bool cached = false;
      int victim = 0;
      int bv[kDepth];
      int rv[kDepth];
      if (duel) {
        int key;
        victim = heap.victim(cached, key);
        buckets_of(victim, width, bv);
#pragma unroll
        for (int d = 0; d < kDepth; ++d) rv[d] = rows[bv[d]];
      }
      // 1. sketch add, gated by the doorkeeper
      bool add = true;
      if (bloom_bits > 0) {
        add = bloom[kx[0]] != 0 && bloom[kx[1]] != 0;
        bloom[kx[0]] = 1;
        bloom[kx[1]] = 1;
      }
      int est_x = INT_MAX;
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int v = rows[bx[d]] + static_cast<int>(add);
        rows[bx[d]] = v;
        est_x = min(est_x, v);
      }
      bool filled = false;
      if (hit) {
        // 3. a hit counts
        const int key = fx + 1;
        freq[x] = key;
        if (x == heap.watch) freq_ahead = key;
        heap.rekey(px, key, x);
        ++n_hits;
      } else {
        bool admit = true;
        if (duel) {
          // 2.-3. the duel on post-aging estimates: aging halves every counter
          int est_v = INT_MAX;
#pragma unroll
          for (int d = 0; d < kDepth; ++d) {
            est_v = min(est_v, rv[d] + static_cast<int>(add && bv[d] == bx[d]));
          }
          est_x >>= static_cast<int>(age);
          est_v >>= static_cast<int>(age);
          if (bloom_bits > 0 && !age) {
            // post-aging membership: x's bits were set this step; an aging step clears all
            est_x += 1;
            est_v += bloom[salted_index(victim, bloom_salt(0), bloom_bits)] != 0 &&
                     bloom[salted_index(victim, bloom_salt(1), bloom_bits)] != 0;
          }
          admit = est_x > est_v;
          if (admit) {
            freq[victim] = 0;  // LFU semantics: the victim's count dies with it
            if (victim == heap.watch) freq_ahead = 0;
            if (kTel) tel.evict(victim, cached);
          }
        }
        if (admit) {
          freq[x] = 1;
          if (x == heap.watch) freq_ahead = 1;
          if (duel && cached) heap.replace_top(1, x);
          else heap.push(1, x);
          count += static_cast<int>(!duel);  // a won duel evicts as it inserts
          ++n_inserts;
          filled = true;
        }
      }
      if (kTel) {
        tel.request(x, hit, filled, 1);
        if (age) tel.refresh(x, 0);
        tel.end_step(t, count);
      }
    }
    if (age) {
      __syncwarp();  // thread 0's add and bloom bits of this step before the halving
      for (int i = threadIdx.x; i < cells; i += kWarp) rows[i] >>= 1;
      for (int i = threadIdx.x; i < bloom_bits; i += kWarp) bloom[i] = 0;
      __syncwarp();
    }
  }
  if (threadIdx.x == 0) {
    hits[s] = n_hits;
    inserts[s] = n_inserts;
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

// Launches on `stream` and returns the first CUDA error: a launch the runtime rejects never
// runs, so the caller must check this code. `heap_slots`, `shared_slots`, `rows_shared` and
// `sketch_shared` are the wrapper's `heap_plan`: `pos` is an (n_samples, n_objects) int32
// scratch where the rows lie in device memory, `heap` an (n_samples, heap_slots) uint64 one
// where a heap can outgrow its shared slots, and `rows` ((n_samples, 4, width) int32) and
// `bloom` ((n_samples, bloom_bits) bytes; bloom_bits 0 = no doorkeeper) the zeroed sketch
// where it lies in device memory (else each is null). The other outputs are zeroed by the
// caller. The telemetry's arguments are cache_sim_launch's (`tel_window` 0 = off).
extern "C" int tinylfu_launch(const int* traces, int* hits, int* inserts, int* freq,
                              unsigned char* in_cache, int* pos, unsigned long long* heap,
                              int* rows, unsigned char* bloom, int* series, const int* groups,
                              int* resident, int n_samples, int trace_len, int n_objects,
                              int capacity, int window, int width, int bloom_bits, int heap_slots,
                              int shared_slots, int rows_shared, int sketch_shared,
                              int tel_window, int n_groups, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TelArgs tel{series, groups, resident, tel_window, n_groups};
  const HeapLayout layout{heap_slots, shared_slots, rows_shared};
  const size_t bytes =
      heap_shared_bytes(layout, n_objects, kRows) +
      (sketch_shared ? static_cast<size_t>(kDepth) * width * sizeof(int) + bloom_bits : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_telemetry(tel, [&](auto on, auto grouped) {
    err = launch_heap_kernel(tinylfu_kernel<decltype(on)::value, decltype(grouped)::value>,
                             n_samples, kWarp, bytes, st, traces, trace_len, n_objects, capacity,
                             window, width, bloom_bits, hits, inserts, freq, in_cache, pos, heap,
                             rows, bloom, layout, sketch_shared, tel);
  });
  return static_cast<int>(err);
}
