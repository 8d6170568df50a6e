// cache_sim/wlfu: S same-shape request traces through Window-LFU, for Hopper (sm_90a).
//
// Replaces the wlfu program of the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py (`wlfu_step` and its loop over the trace): the
// frequency of an id is its count among the last `window` requests, kept by a ring of
// those ids that slides *before* the hit test; every miss inserts, evicting the cached id
// of least window frequency (ties to the lowest id) when the cache is full.
//
// What bounds it on this card: the T steps of a sample form one chain of dependent steps
// (latency, not bytes or operations). The design is cache_sim.cu's:
//
// * One block of one warp a sample; thread 0 runs the whole trace with no block barrier in
//   the loop. The other lanes initialise the rows and copy them into the outputs at the end.
// * No ring: a run starts empty, so the id that leaves the window at step t is the request
//   of step t - window (none before step `window`), read again from the trace row.
// * Victim: the top of the residents' heap keyed on the window count (ResidentHeap in
//   cache_sim_common.cuh), the reference's masked argmin with its ties to the lowest id. Two
//   residents can change count in a step: x (+1 on a hit, a sift down) and the id leaving
//   the window (-1, a sift up). The reference picks its victim from the counts after the
//   slide; the departing id's -1 changes nothing else the reference reads in between, so
//   the program applies it at the end of the step before (x's +1 after it gives the same
//   counts when the two ids are one). The heap takes max(capacity, 1) slots: window counts
//   stay below INT_MAX, so a full heap's top is always cached, and an empty heap
//   (capacity <= 0) names id 0, not cached, as the reference's argmin does.
// * Shared memory holds the heap's slots and, where they fit beside them, the rows `pos`
//   (each id's slot, or -1: the hit test) and `freq` (every id's window count, the output);
//   otherwise the rows are device buffers that stay in L2. Thread 0 loads the next
//   request's slot and count, and the next departing id's, a step ahead (the heap watches
//   both slots); every write keeps those registers true.
// * Telemetry (telemetry.cuh) when the template asks for it: every miss fills.
//
// It still uses only S of the 132 SMs a launch.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

constexpr int kRows = 2;  // pos, freq

template <bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kWarp)
wlfu_kernel(const int* __restrict__ traces, int trace_len, int n_objects, int capacity, int window,
            int* __restrict__ hits, int* __restrict__ inserts, int* freq_all,
            unsigned char* cache_all, int* pos_all, unsigned long long* device_slots,
            HeapLayout layout, TelArgs tel_args) {
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
    ResidentHeapOf<2> heap{slots, layout.shared_slots, device, layout.slots, pos};
    int count = 0;
    int n_hits = 0;
    // the next request's id, slot (heap.watch, heap.watch_pos) and count, and the next step's
    // departing id, slot (heap.watch2, heap.watch2_pos) and count, loaded a step ahead; the
    // ids after them
    int freq_ahead = 0;
    int old_freq_ahead = 0;
    if (trace_len > 0) {
      heap.look_ahead(trace[0]);
      freq_ahead = freq[trace[0]];
    }
    int x_after = trace_len > 1 ? __ldg(trace + 1) : 0;
    // the id that leaves the window a step after the next one (at step 1 here): trace[1 - window]
    int old_after = window <= 1 && trace_len > 0 ? __ldg(trace) : 0;
    for (int t = 0; t < trace_len; ++t) {
      const int x = heap.watch;
      const int px = heap.watch_pos;
      const int fx_loaded = freq_ahead;
      const bool departs = t + 1 < trace_len && t + 1 >= window;  // trace[t + 1 - window] leaves
      if (t + 1 < trace_len) {
        heap.look_ahead(x_after);
        freq_ahead = freq[x_after];
        if (departs) {
          heap.look_ahead2(old_after);
          old_freq_ahead = freq[old_after];
        }
        if (t + 2 < trace_len) {
          x_after = __ldg(trace + t + 2);
          if (t + 2 >= window) old_after = __ldg(trace + t + 2 - window);
        }
        if ((t & 31) == 0 && t + 512 < trace_len) prefetch_l2(trace + t + 512);
      } else {
        heap.watch = -1;
      }
      // the slide's +1 (the -1 of the id that left the window at this step came at the end of
      // the step before)
      const int fx = fx_loaded + 1;
      freq[x] = fx;
      if (x == heap.watch) freq_ahead = fx;
      if (x == heap.watch2) old_freq_ahead = fx;
      const bool hit = px >= 0;
      const bool need_evict = !hit && count >= capacity;
      if (hit) {
        heap.sift_down(px, heap_entry(fx, x));  // x's count rose by one
      } else {
        if (need_evict) {
          bool cached;
          int key;
          const int victim = heap.victim(cached, key);
          if (cached) heap.pop();
          if (kTel) tel.evict(victim, cached);
        }
        heap.push(fx, x);
      }
      count += static_cast<int>(!hit) - static_cast<int>(need_evict);
      n_hits += static_cast<int>(hit);
      if (kTel) {
        tel.request(x, hit, !hit, 1);
        tel.end_step(t, count);
      }
      // the slide's -1 of step t + 1: the id leaving the window then is in it now, so its
      // count is at least 1
      if (departs) {
        const int old = heap.watch2;
        const int fo = old_freq_ahead - 1;
        freq[old] = fo;
        if (old == heap.watch) freq_ahead = fo;
        if (heap.watch2_pos >= 0) heap.sift_up(heap.watch2_pos, heap_entry(fo, old));
      }
    }
    hits[s] = n_hits;
    inserts[s] = trace_len - n_hits;  // every miss inserts
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
// runs, so the caller must check this code. `heap_slots`, `shared_slots` and `rows_shared` are
// the wrapper's `heap_plan`; `pos` is an (n_samples, n_objects) int32 scratch, used where the
// rows lie in device memory, and `heap` an (n_samples, heap_slots) uint64 one, where a heap can
// outgrow its shared slots (else each is null). The other outputs are zeroed by the caller.
// The telemetry's arguments are cache_sim_launch's (`tel_window` 0 = off).
extern "C" int wlfu_launch(const int* traces, int* hits, int* inserts, int* freq,
                           unsigned char* in_cache, int* pos, unsigned long long* heap,
                           int* series, const int* groups, int* resident, int n_samples,
                           int trace_len, int n_objects, int capacity, int window, int heap_slots,
                           int shared_slots, int rows_shared, int tel_window, int n_groups,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TelArgs tel{series, groups, resident, tel_window, n_groups};
  const HeapLayout layout{heap_slots, shared_slots, rows_shared};
  const size_t bytes = heap_shared_bytes(layout, n_objects, kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_telemetry(tel, [&](auto on, auto grouped) {
    err = launch_heap_kernel(wlfu_kernel<decltype(on)::value, decltype(grouped)::value>,
                             n_samples, kWarp, bytes, st, traces, trace_len, n_objects, capacity,
                             window, hits, inserts, freq, in_cache, pos, heap, layout, tel);
  });
  return static_cast<int>(err);
}
