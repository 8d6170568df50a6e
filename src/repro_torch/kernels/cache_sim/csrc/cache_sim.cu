// cache_sim: S same-shape request traces through one cache policy, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py (built by `cache_sim_pallas`), for the program
// that kernel runs for lru, lfu, plfu and plfua in object-count mode (`base_step` and the
// loop over the trace), with or without the windowed telemetry of telemetry.cuh; wlfu.cu,
// tinylfu.cu, plfua_dyn.cu, sized.cu and arc.cu hold its other programs, and
// cache_sim_common.cuh the helpers they share (the victim's block argmin among them). It
// computes what that program computes, not block by block:
//
// * One thread block per sample. The steps of one sample are strictly sequential, so a
//   loop over t inside the block takes the place of the TPU's in-kernel `fori_loop`.
// * The state lives in the zeroed output buffers in device memory: `freq` (int32; lru
//   keeps stamps t+1 there, 0 = never requested) and `in_cache` (one byte per id). At the
//   paper's N = 100,000 that is 500 KB a sample, more than the 227 KB of shared memory a
//   block can have, and 6 MB for 12 samples, which stays resident in the 50 MB L2.
// * Hit test: a direct read of in_cache[x] (the TPU's one-hot compare was its way around
//   gathers).
// * Victim: only when an eviction is needed, a block-wide masked argmin over (key, id)
//   compared lexicographically -- strided scan, warp shuffles, then shared memory across
//   warps -- so ties go to the lowest id exactly as the reference's argmin does.
// * Thread 0 reads in_cache[x] and applies the step's few writes; one block barrier a
//   step (__syncthreads_or, which also hands out the hit) orders them against the other
//   threads' reads.
//
// What bounds it on this card: each eviction reads N keys and N flags (N compares), and
// the T steps of a sample form one chain of dependent steps, each ending in a block
// barrier, so the kernel is latency-bound, not bandwidth- or compute-bound. It uses only
// S of the 132 SMs per launch (12 for the paper's replication). Batching several cases in
// one launch, keeping small-N state in shared memory, and an ordered structure in place of
// the O(N) argmin are later work.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

constexpr int kLru = 0;
constexpr int kLfu = 1;
constexpr int kPlfua = 3;  // kPlfu = 2 needs no case of its own

// One barrier a step (two with an eviction). It orders thread 0's writes of step t-1
// before every read of step t, and every read of step t-1 before thread 0's writes of
// step t; and it hands all threads thread 0's read of in_cache[x]. Every thread then
// computes the step's scalars (hit, count, ...) from the same values, so the branch on
// need_evict, which holds the reduction's barrier, is uniform. With kTel thread 0 also
// records the step's telemetry (telemetry.cuh).
template <bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kMaxThreads)
cache_sim_kernel(const int* __restrict__ traces, int trace_len, int n_objects, int kind,
                 int capacity, int hot_size, int* __restrict__ hits, int* freq_all,
                 unsigned char* cache_all, TelArgs tel_args) {
  __shared__ int s_key[kMaxThreads / kWarp];
  __shared__ int s_id[kMaxThreads / kWarp];
  const size_t s = blockIdx.x;
  const int* trace = traces + s * trace_len;
  int* freq = freq_all + s * n_objects;
  unsigned char* in_cache = cache_all + s * n_objects;
  Telemetry<kTel, kGrouped> tel(tel_args, s, trace_len);

  int count = 0;
  int n_hits = 0;
  int x_next = trace_len > 0 ? trace[0] : 0;
  for (int t = 0; t < trace_len; ++t) {
    const int x = x_next;
    // the next id does not depend on the state: its load overlaps this step
    if (t + 1 < trace_len) x_next = trace[t + 1];
    const bool hit = __syncthreads_or(threadIdx.x == 0 && in_cache[x] != 0) != 0;
    const bool admitted = kind != kPlfua || x < hot_size;
    const bool want = !hit && admitted;
    const bool need_evict = want && count >= capacity;
    int victim = 0;
    if (need_evict) victim = block_argmin(freq, in_cache, n_objects, s_key, s_id);
    if (threadIdx.x == 0) {
      if (need_evict) {
        in_cache[victim] = 0;
        // in-memory LFU: eviction destroys the victim's count, before x's bump
        if (kind == kLfu) freq[victim] = 0;
      }
      if (kind == kLru) {
        freq[x] = t + 1;
      } else if (hit || admitted) {
        // a non-hot plfua miss neither inserts nor bumps
        freq[x] += 1;
      }
      if (want) in_cache[x] = 1;
    }
    count += static_cast<int>(want) - static_cast<int>(need_evict);
    n_hits += static_cast<int>(hit);
    if (kTel && threadIdx.x == 0) {
      tel.request(x, hit, want, 1);
      if (need_evict) tel.evict(victim);
      tel.end_step(t, count);
    }
  }
  if (threadIdx.x == 0) hits[s] = n_hits;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns cudaGetLastError(): a
// launch the runtime rejects never runs, so the caller must check this code. `series`,
// `groups`, `resident`, `window` and `n_groups` are the telemetry's (TelArgs; window 0 =
// off, n_groups 0 = ungrouped).
extern "C" int cache_sim_launch(const int* traces, int* hits, int* freq,
                                unsigned char* in_cache, int* series, const int* groups,
                                int* resident, int n_samples, int trace_len, int n_objects,
                                int kind, int capacity, int hot_size, int window, int n_groups,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TelArgs tel{series, groups, resident, window, n_groups};
  const dim3 grid(n_samples);
  const dim3 block(block_threads(n_objects));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_telemetry(tel, [&](auto on, auto grouped) {
    cache_sim_kernel<decltype(on)::value, decltype(grouped)::value><<<grid, block, 0, st>>>(
        traces, trace_len, n_objects, kind, capacity, hot_size, hits, freq, in_cache, tel);
  });
  return static_cast<int>(cudaGetLastError());
}
