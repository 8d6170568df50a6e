// cache_sim/arc: S same-shape request traces through ARC (the Adaptive Replacement Cache),
// for Hopper (sm_90a).
//
// Replaces the arc program of the TPU kernel `_cache_sim_kernel` in
// src/repro/kernels/cache_sim/cache_sim.py (`arc_step`). It computes what that program
// computes:
// * Each id carries a list tag (0 untracked, T1, T2, B1, B2) and a stamp; a list's LRU is
//   its least-stamped member (ties to the lowest id; an empty list's argmin is id 0, and
//   a write to it follows the tag it really overwrites).
// * A ghost hit adapts the target p: a B1 hit grows it by max(1, |B2| / max(1, |B1|)) up
//   to the capacity, a B2 hit shrinks it by max(1, |B1| / max(1, |B2|)) down to 0.
// * A cold miss trims first (Case IV): B1's LRU goes when |T1| + |B1| >= c (T1's LRU is
//   dropped outright when B1 is empty), else B2's LRU when the directory holds 2c ids and
//   B2 is not empty.
// * A miss into a full cache (|T1| + |T2| >= c) demotes T1's LRU to B1 (when |T1| > p, or
//   == p on a B2 hit, or T2 is empty) or T2's LRU to B2, stamped with this step.
// * x lands at T2's MRU on any hit or ghost hit and at T1's MRU on a cold miss, stamped t.
//
// Design (one block per sample, as cache_sim.cu):
// * State in device buffers: the tags in an (S, N) byte scratch buffer, the stamps in the
//   zeroed freq output (stamps are t, as the reference kernel's), and in_cache written from
//   the tags once at the end.
// * Thread 0 keeps the four list sizes and p as scalars, updated from each step's writes
//   (by the tag each write replaces) rather than summed over N every step as the
//   reference does, and decides the step. It hands its decisions to the block through a
//   double-buffered shared word and one block barrier a step. A step then runs at most
//   two argmins over the stamps, each only when needed: B1's or B2's LRU for a trim, and
//   T1's or T2's LRU for an eviction. Thread 0 applies all the step's writes after them:
//   a trim changes only ghost tags, which no T-list argmin reads.
// * Thread 0 also writes each sample's directory size (ids with a tag) and the number of
//   argmins it ran.
//
// * Telemetry (telemetry.cuh) when the template asks for it: every miss fills (a cold miss
//   into T1, a ghost hit into T2); a resident demoted to B1/B2 or dropped from T1 is an
//   eviction, a ghost trimmed from B1/B2 is not; the occupancy is |T1| + |T2|.
//
// What bounds it on this card: as cache_sim.cu, the chain of T dependent steps, each with
// a block barrier, and an O(N) argmin from L2 per trim or demotion; a cold miss into a
// full cache runs two.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

constexpr unsigned char kT1 = 1;
constexpr unsigned char kT2 = 2;
constexpr unsigned char kB1 = 3;
constexpr unsigned char kB2 = 4;

// The decisions thread 0 hands out each step.
constexpr int kTrim = 1;     // a ghost list's LRU goes
constexpr int kTrimB2 = 2;   // ... from B2 (else B1)
constexpr int kEvict = 4;    // a resident's LRU leaves T1 or T2
constexpr int kFromT1 = 8;   // ... from T1 (else T2)

struct ListSizes {
  int t1 = 0;
  int t2 = 0;
  int b1 = 0;
  int b2 = 0;

  __device__ __forceinline__ void add(int tag, int delta) {
    if (tag == kT1) t1 += delta;
    else if (tag == kT2) t2 += delta;
    else if (tag == kB1) b1 += delta;
    else if (tag == kB2) b2 += delta;
  }
};

// lst[id] = tag, keeping the sizes by the tag the write replaces.
__device__ __forceinline__ void retag(unsigned char* lst, int id, unsigned char tag,
                                      ListSizes& n) {
  n.add(lst[id], -1);
  n.add(tag, 1);
  lst[id] = tag;
}

template <bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kMaxThreads)
arc_kernel(const int* __restrict__ traces, int trace_len, int n_objects, int capacity,
           int* __restrict__ hits, int* __restrict__ dir_size, int* __restrict__ argmins,
           int* stamp_all, unsigned char* cache_all, unsigned char* lst_all, TelArgs tel_args) {
  __shared__ int s_key[kMaxThreads / kWarp];
  __shared__ int s_id[kMaxThreads / kWarp];
  __shared__ int s_plan[2];
  const size_t s = blockIdx.x;
  const int* trace = traces + s * trace_len;
  int* stamp = stamp_all + s * n_objects;
  unsigned char* in_cache = cache_all + s * n_objects;
  unsigned char* lst = lst_all + s * n_objects;
  Telemetry<kTel, kGrouped> tel(tel_args, s, trace_len);

  ListSizes n;  // thread 0's, as the rest below
  int p = 0;
  int n_hits = 0;
  int n_argmins = 0;
  int x_next = trace_len > 0 ? trace[0] : 0;
  for (int t = 0; t < trace_len; ++t) {
    const int x = x_next;
    if (t + 1 < trace_len) x_next = trace[t + 1];
    bool hit = false;
    bool ghost = false;
    bool need_evict = false;
    bool hard_t1 = false;
    bool from_t1 = false;
    if (threadIdx.x == 0) {
      const int lx = lst[x];
      hit = lx == kT1 || lx == kT2;
      const bool g2 = lx == kB2;
      ghost = lx == kB1 || g2;
      const bool cold = lx == 0;
      if (lx == kB1) {
        p = min(capacity, wrap_add(p, max(1, n.b2 / max(1, n.b1))));
      } else if (g2) {
        p = max(0, wrap_sub(p, max(1, n.b1 / max(1, n.b2))));
      }
      const bool case_a = cold && n.t1 + n.b1 >= capacity;
      hard_t1 = case_a && n.b1 == 0;
      const bool gone_b1 = case_a && n.b1 > 0;
      const bool gone_b2 = cold && !case_a &&
                           n.t1 + n.t2 + n.b1 + n.b2 >= wrap_add(capacity, capacity) && n.b2 > 0;
      need_evict = !hit && !hard_t1 && n.t1 + n.t2 >= capacity;
      from_t1 = n.t1 >= 1 && ((g2 && n.t1 == p) || n.t1 > p || n.t2 == 0);
      s_plan[t & 1] = (gone_b1 || gone_b2 ? kTrim : 0) | (gone_b2 ? kTrimB2 : 0) |
                      (need_evict || hard_t1 ? kEvict : 0) | (hard_t1 || from_t1 ? kFromT1 : 0);
    }
    // hands out the plan, and orders thread 0's writes of the last step before the argmins
    __syncthreads();
    const int plan = s_plan[t & 1];
    int trimmed = 0;
    int victim = 0;
    if (plan & kTrim) {
      trimmed = block_argmin_of(stamp, TagMask{lst, (plan & kTrimB2) ? kB2 : kB1}, n_objects,
                                s_key, s_id);
      // warp 0 reads the first search's partial minima from s_key/s_id after its barrier;
      // the second search must not write them before it has
      if (plan & kEvict) __syncthreads();
    }
    if (plan & kEvict) {
      victim = block_argmin_of(stamp, TagMask{lst, (plan & kFromT1) ? kT1 : kT2}, n_objects,
                               s_key, s_id);
    }
    if (threadIdx.x == 0) {
      if (plan & kTrim) {
        retag(lst, trimmed, 0, n);
        ++n_argmins;
      }
      if (plan & kEvict) {
        retag(lst, victim, hard_t1 ? 0 : from_t1 ? kB1 : kB2, n);
        if (need_evict) stamp[victim] = t;
        ++n_argmins;
      }
      retag(lst, x, hit || ghost ? kT2 : kT1, n);
      stamp[x] = t;
      n_hits += static_cast<int>(hit);
      if (kTel) {
        tel.request(x, hit, !hit, 1);
        if (plan & kEvict) tel.evict(victim);
        tel.end_step(t, n.t1 + n.t2);
      }
    }
  }
  __syncthreads();  // thread 0's last writes before the tags are read
  for (int i = threadIdx.x; i < n_objects; i += blockDim.x) {
    in_cache[i] = lst[i] == kT1 || lst[i] == kT2;
  }
  if (threadIdx.x == 0) {
    hits[s] = n_hits;
    dir_size[s] = n.t1 + n.t2 + n.b1 + n.b2;
    argmins[s] = n_argmins;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). `stamp` (the freq output) and the
// tag scratch `lst` ((n_samples, n_objects) bytes) are zeroed by the caller, as are the
// other outputs; `dir_size` and `argmins` are (n_samples,) int32. The telemetry's arguments
// are cache_sim_launch's (`window` 0 = off).
extern "C" int arc_launch(const int* traces, int* hits, int* dir_size, int* argmins, int* stamp,
                          unsigned char* in_cache, unsigned char* lst, int* series,
                          const int* groups, int* resident, int n_samples, int trace_len,
                          int n_objects, int capacity, int window, int n_groups, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TelArgs tel{series, groups, resident, window, n_groups};
  const dim3 grid(n_samples);
  const dim3 block(block_threads(n_objects));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_telemetry(tel, [&](auto on, auto grouped) {
    arc_kernel<decltype(on)::value, decltype(grouped)::value><<<grid, block, 0, st>>>(
        traces, trace_len, n_objects, capacity, hits, dir_size, argmins, stamp, in_cache, lst, tel);
  });
  return static_cast<int>(cudaGetLastError());
}
