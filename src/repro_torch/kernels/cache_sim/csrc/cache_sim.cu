// cache_sim: S same-shape request traces through one cache policy, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py:187 (built by `cache_sim_pallas`), for the program
// that kernel runs for lru, lfu, plfu and plfua in object-count mode (`base_step`, l.320, and
// the loop over the trace), with or without the windowed telemetry of telemetry.cuh; wlfu.cu,
// tinylfu.cu, plfua_dyn.cu, sized.cu and arc.cu hold its other programs, and
// cache_sim_common.cuh the helpers they share (the residents' heap among them). It computes
// what that program computes, not block by block.
//
// What bounds it on this card: the T steps of a sample form one chain of dependent steps, so
// the program is latency-bound, not bandwidth- or compute-bound; its time is T times a step's
// latency. The design shortens the step:
//
// * One block of one warp a sample; thread 0 runs the whole trace, with no block barrier in
//   the loop. The other lanes initialise the rows and copy them into the outputs at the end.
// * Victim: the top of a binary min-heap of the cached ids by (key, id) (ResidentHeap in
//   cache_sim_common.cuh), which is the reference's masked argmin with its ties to the lowest
//   id; the key is the policy's own (lru: stamps t+1; lfu, plfu, plfua: freq). A hit re-keys
//   x, an insert pushes it and an eviction pops the top: ceil(log2 capacity) levels at most,
//   in place of a scan of all N ids from L2 and two block barriers.
// * Rows in shared memory where they fit: the heap's max(capacity, 1) slots first (8 B each;
//   past 29,056 slots the heap moves to device memory), then, if they fit beside them, `pos`
//   (each id's slot, or -1: the hit test) and `freq`, 8 B an id (N <= 21,544 on the paper's
//   grid). Otherwise the rows are device buffers that stay in L2, and thread 0 loads the next
//   request's entries (its slot and count) one step ahead, so that their latency overlaps the
//   step. Each row and the heap are reached through one pointer chosen at the start, with no
//   test on each access.
// * `in_cache` is written once at the end, from `pos` >= 0; `freq` is copied out when it
//   lived in shared memory.
//
// It still uses only S of the 132 SMs a launch (12 for the paper's replication): batching
// several cases in one launch is later work.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

constexpr int kLru = 0;
constexpr int kLfu = 1;
constexpr int kPlfua = 3;  // kPlfu = 2 needs no case of its own
constexpr int kRows = 2;   // pos, freq

// With kTel thread 0 also records the step's telemetry (telemetry.cuh).
template <bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kWarp)
cache_sim_kernel(const int* __restrict__ traces, int trace_len, int n_objects, int kind,
                 int capacity, int hot_size, int* __restrict__ hits, int* freq_all,
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
    ResidentHeap heap{slots, layout.shared_slots, device, layout.slots, pos};
    int count = 0;
    int n_hits = 0;
    // the next request's id, slot (heap.watch, heap.watch_pos) and count, loaded a step ahead,
    // and the id after it
    int freq_ahead = 0;
    if (trace_len > 0) {
      heap.look_ahead(trace[0]);
      freq_ahead = freq[trace[0]];
    }
    int x_after = trace_len > 1 ? __ldg(trace + 1) : 0;
    for (int t = 0; t < trace_len; ++t) {
      const int x = heap.watch;
      const int px = heap.watch_pos;
      int fx = freq_ahead;
      if (t + 1 < trace_len) {
        heap.look_ahead(x_after);
        freq_ahead = freq[x_after];
        if (t + 2 < trace_len) x_after = __ldg(trace + t + 2);
        if ((t & 31) == 0 && t + 512 < trace_len) prefetch_l2(trace + t + 512);
      } else {
        heap.watch = -1;
      }
      const bool hit = px >= 0;
      const bool admitted = kind != kPlfua || x < hot_size;
      const bool want = !hit && admitted;
      const bool need_evict = want && count >= capacity;
      if (need_evict) {
        bool cached;
        int key;
        const int victim = heap.victim(cached, key);
        if (cached) heap.pop();
        // in-memory LFU: eviction destroys the victim's count, before x's bump
        if (kind == kLfu) {
          freq[victim] = 0;
          if (victim == heap.watch) freq_ahead = 0;
          if (victim == x) fx = 0;
        }
        if (kTel) tel.evict(victim, cached);
      }
      // a non-hot plfua miss neither inserts nor bumps
      if (kind == kLru || hit || admitted) {
        const int key = kind == kLru ? t + 1 : fx + 1;
        freq[x] = key;
        if (x == heap.watch) freq_ahead = key;
        if (hit) heap.rekey(px, key, x);
        else if (want) heap.push(key, x);
      }
      count += static_cast<int>(want) - static_cast<int>(need_evict);
      n_hits += static_cast<int>(hit);
      if (kTel) {
        tel.request(x, hit, want, 1);
        tel.end_step(t, count);
      }
    }
    hits[s] = n_hits;
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

// Launches on `stream` (PyTorch's current stream) and returns the first CUDA error: a
// launch the runtime rejects never runs, so the caller must check this code. `heap_slots`,
// `shared_slots` and `rows_shared` are the wrapper's `heap_plan`; `pos` is an (n_samples,
// n_objects) int32 scratch, used where the rows lie in device memory, and `heap` an
// (n_samples, heap_slots) uint64 one, where a heap can outgrow its shared slots (else each is
// null). `series`, `groups`,
// `resident`, `window` and `n_groups` are the telemetry's (TelArgs; window 0 = off, n_groups
// 0 = ungrouped).
extern "C" int cache_sim_launch(const int* traces, int* hits, int* freq,
                                unsigned char* in_cache, int* pos, unsigned long long* heap,
                                int* series, const int* groups, int* resident, int n_samples,
                                int trace_len, int n_objects, int kind, int capacity,
                                int hot_size, int heap_slots, int shared_slots, int rows_shared,
                                int window, int n_groups, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TelArgs tel{series, groups, resident, window, n_groups};
  const HeapLayout layout{heap_slots, shared_slots, rows_shared};
  const size_t bytes = heap_shared_bytes(layout, n_objects, kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_telemetry(tel, [&](auto on, auto grouped) {
    err = launch_heap_kernel(cache_sim_kernel<decltype(on)::value, decltype(grouped)::value>,
                             n_samples, kWarp, bytes, st, traces, trace_len, n_objects, kind,
                             capacity, hot_size, hits, freq, in_cache, pos, heap, layout, tel);
  });
  return static_cast<int>(err);
}
