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
// What bounds it on this card: the T steps of a sample form one chain of dependent steps
// (latency, not bytes or operations). The design shortens the step:
//
// * Each list is an intrusive doubly linked list in stamp order. Every write that puts an
//   id into a list stamps it with the step's t (x into T1 or T2, a demoted victim into B1
//   or B2), and a step puts at most one id into each list, so a list's order of entry is
//   its stamp order, without ties: the reference's LRU is the list's head. An empty list
//   names id 0, which may sit in another list or in none; its retag unlinks it from
//   wherever it is, as the reference's write of lst[0] does. A step makes at most two
//   head lookups and three unlink/link moves; no scan of the N ids is left.
// * One block of one warp a sample; thread 0 runs the whole trace with no block barrier
//   in the loop, keeping the lists' heads, tails and sizes, each head's successor and p in
//   registers. The other lanes initialise the tags and write in_cache from them at the end.
// * Per id a tag byte and (prev, next) links. Both lie in dynamic shared memory when they
//   fit (9 B an id: N <= 25,827), as the wrapper's `arc_plan` chose; otherwise both lie in
//   (S, N) device buffers that stay in L2. Each row is reached through one pointer chosen at
//   the start.
// * The next request's tag and links are loaded a step ahead, and each head's successor
//   when the head changes, so that no load waits on the step's chain but the speculative
//   ones; every write of a tag or link keeps those registers true. x leaves its list first:
//   a victim comes from a T list and a trim from a B list only when x is a ghost or cold,
//   so x's links touch neither, and the lists end as the reference's. Stamps go to the freq
//   output and are never read.
// * Thread 0 also writes each sample's directory size (ids with a tag) and the number of
//   list-head lookups (a trim or a demotion each), the old argmin count.
//
// * Telemetry (telemetry.cuh) when the template asks for it: every miss fills (a cold miss
//   into T1, a ghost hit into T2); a resident demoted to B1/B2 or dropped from T1 is an
//   eviction, a ghost trimmed from B1/B2 is not, nor an empty list's id 0 while it is not
//   cached (the cache counts its residents); the occupancy is |T1| + |T2|.
//
// It still uses only S of the 132 SMs a launch.

#include "cache_sim_common.cuh"
#include "telemetry.cuh"

namespace {

constexpr int kT1 = 1;
constexpr int kT2 = 2;
constexpr int kB1 = 3;
constexpr int kB2 = 4;

// A register per list (T1, T2, B1, B2), chosen by tag with selects: an array indexed at run
// time would live in local memory.
struct PerList {
  int t1, t2, b1, b2;

  __device__ __forceinline__ int get(int tag) const {
    return tag == kT1 ? t1 : tag == kT2 ? t2 : tag == kB1 ? b1 : b2;
  }
  __device__ __forceinline__ void set(int tag, int v) {
    t1 = tag == kT1 ? v : t1;
    t2 = tag == kT2 ? v : t2;
    b1 = tag == kB1 ? v : b1;
    b2 = tag == kB2 ? v : b2;
  }
};

// Thread 0's lists. `tag` and `link` are the sample's rows (shared or device memory); each
// tagged id's link is (prev, next) toward its list's head and tail, -1 at an end.
struct ArcLists {
  unsigned char* tag;
  int2* link;
  PerList head{-1, -1, -1, -1};
  PerList tail{-1, -1, -1, -1};
  PerList next_of_head{-1, -1, -1, -1};  // each head's successor, loaded when the head changes
  PerList size{0, 0, 0, 0};
  int watch = -1;  // the next request's id, its tag and its links
  int watch_tag = 0;
  int2 watch_link = make_int2(-1, -1);

  // Load `id`'s tag and links ahead of the step that requests it.
  __device__ __forceinline__ void look_ahead(int id) {
    watch = id;
    watch_tag = tag[id];
    watch_link = link[id];
  }

  __device__ __forceinline__ void set_tag(int id, int t) {
    tag[id] = static_cast<unsigned char>(t);
    if (id == watch) watch_tag = t;
  }
  __device__ __forceinline__ void set_prev(int id, int v) {
    link[id].x = v;
    if (id == watch) watch_link.x = v;
  }
  // id is a member of list `lst`
  __device__ __forceinline__ void set_next(int lst, int id, int v) {
    link[id].y = v;
    if (id == watch) watch_link.y = v;
    if (id == head.get(lst)) next_of_head.set(lst, v);
  }
  __device__ __forceinline__ void set_head(int lst, int id) {
    head.set(lst, id);
    next_of_head.set(lst, id >= 0 ? link[id].y : -1);
  }

  // Take `id`, whose links are `l`, out of list `lst`.
  __device__ __forceinline__ void unlink(int lst, int id, int2 l) {
    if (l.x >= 0) set_next(lst, l.x, l.y);
    else set_head(lst, l.y);
    if (l.y >= 0) set_prev(l.y, l.x);
    else tail.set(lst, l.x);
    size.set(lst, size.get(lst) - 1);
  }

  // Append `id` (in no list) to list `lst`.
  __device__ __forceinline__ void append(int lst, int id) {
    const int last = tail.get(lst);
    link[id] = make_int2(last, -1);
    if (id == watch) watch_link = make_int2(last, -1);
    if (last >= 0) {
      set_next(lst, last, id);
    } else {
      head.set(lst, id);
      next_of_head.set(lst, -1);
    }
    tail.set(lst, id);
    size.set(lst, size.get(lst) + 1);
  }

  // Remove list `lst`'s head (its LRU; the list is not empty) and give it `to` (0 or
  // another list).
  __device__ __forceinline__ int move_head(int lst, int to) {
    const int h = head.get(lst);
    unlink(lst, h, make_int2(-1, next_of_head.get(lst)));
    set_tag(h, to);
    if (to) append(to, h);
    return h;
  }

  // Give `id`, whose tag is `from` (0 = in no list) and links `l`, the tag `to`.
  __device__ __forceinline__ void retag(int id, int from, int2 l, int to) {
    if (from) unlink(from, id, l);
    set_tag(id, to);
    if (to) append(to, id);
  }
};

template <bool kTel, bool kGrouped>
__global__ void __launch_bounds__(kWarp)
arc_kernel(const int* __restrict__ traces, int trace_len, int n_objects, int capacity,
           int* __restrict__ hits, int* __restrict__ dir_size, int* __restrict__ argmins,
           int* stamp_all, unsigned char* cache_all, unsigned char* tags_all, int2* links_all,
           int shared, TelArgs tel_args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t s = blockIdx.x;
  const size_t n = n_objects;
  const int* trace = traces + s * trace_len;
  unsigned char* tag = shared ? smem : tags_all + s * n;
  int2* link = shared ? reinterpret_cast<int2*>(smem + (n + 7) / 8 * 8) : links_all + s * n;
  for (size_t i = threadIdx.x; i < n; i += kWarp) tag[i] = 0;
  __syncwarp();

  ArcLists L{tag, link};
  if (threadIdx.x == 0) {
    Telemetry<kTel, kGrouped> tel(tel_args, s, trace_len);
    int* stamp = stamp_all + s * n;
    int p = 0;
    int n_hits = 0;
    int n_lookups = 0;
    if (trace_len > 0) L.look_ahead(trace[0]);
    int x_after = trace_len > 1 ? __ldg(trace + 1) : 0;
    for (int t = 0; t < trace_len; ++t) {
      const int x = L.watch;
      const int lx = L.watch_tag;
      const int2 lk = L.watch_link;
      if (t + 1 < trace_len) {
        L.look_ahead(x_after);
        if (t + 2 < trace_len) x_after = __ldg(trace + t + 2);
        if ((t & 31) == 0 && t + 512 < trace_len) prefetch_l2(trace + t + 512);
      } else {
        L.watch = -1;
      }
      const int n1 = L.size.t1, n2 = L.size.t2, n3 = L.size.b1, n4 = L.size.b2;
      const bool hit = lx == kT1 || lx == kT2;
      const bool g2 = lx == kB2;
      const bool ghost = lx == kB1 || g2;
      const bool cold = lx == 0;
      if (lx == kB1) {
        p = min(capacity, wrap_add(p, max(1, n4 / max(1, n3))));
      } else if (g2) {
        p = max(0, wrap_sub(p, max(1, n3 / max(1, n4))));
      }
      const bool case_a = cold && n1 + n3 >= capacity;
      const bool hard_t1 = case_a && n3 == 0;
      const bool gone_b1 = case_a && n3 > 0;
      const bool gone_b2 =
          cold && !case_a && n1 + n2 + n3 + n4 >= wrap_add(capacity, capacity) && n4 > 0;
      const bool need_evict = !hit && !hard_t1 && n1 + n2 >= capacity;
      const bool from_t1 = n1 >= 1 && ((g2 && n1 == p) || n1 > p || n2 == 0);

      // x leaves its list first (see the note above); it rejoins one at the end
      if (!cold) L.unlink(lx, x, lk);
      if (gone_b1 || gone_b2) {
        L.move_head(gone_b1 ? kB1 : kB2, 0);
        ++n_lookups;
      }
      if (need_evict || hard_t1) {
        const int from = hard_t1 || from_t1 ? kT1 : kT2;
        const int to = hard_t1 ? 0 : from_t1 ? kB1 : kB2;
        int victim;
        bool cached;
        if (L.head.get(from) >= 0) {
          cached = true;
          victim = L.move_head(from, to);
        } else {
          // an empty list names id 0, wherever it is; as x it is in no list now, and its own
          // retag below overwrites this one
          victim = 0;
          const int from0 = x == 0 ? 0 : L.tag[0];
          cached = from0 == kT1 || from0 == kT2;
          if (x != 0) L.retag(0, from0, L.link[0], to);
        }
        if (need_evict) stamp[victim] = t;
        ++n_lookups;
        // the plain version's count: arc's cache counts its residents, so a victim that was
        // not cached is no eviction in either series
        if (kTel && cached) tel.evict(victim, cached);
      }
      L.set_tag(x, hit || ghost ? kT2 : kT1);
      L.append(hit || ghost ? kT2 : kT1, x);
      stamp[x] = t;
      n_hits += static_cast<int>(hit);
      if (kTel) {
        tel.request(x, hit, !hit, 1);
        tel.end_step(t, L.size.t1 + L.size.t2);
      }
    }
    hits[s] = n_hits;
    dir_size[s] = L.size.t1 + L.size.t2 + L.size.b1 + L.size.b2;
    argmins[s] = n_lookups;
  }
  __syncwarp();

  unsigned char* in_cache = cache_all + s * n;
  for (size_t i = threadIdx.x; i < n; i += kWarp) in_cache[i] = tag[i] == kT1 || tag[i] == kT2;
}

}  // namespace

// Launches on `stream` and returns the first CUDA error: a launch the runtime rejects never
// runs, so the caller must check this code. `stamp` (the freq output) and the other outputs
// are zeroed by the caller; `dir_size` and `argmins` are (n_samples,) int32. `shared` is the
// wrapper's `arc_plan`: without it `tags` is an (n_samples, n_objects) byte scratch and `links`
// an (n_samples, n_objects, 2) int32 one (with it both are null); neither needs zeroing. The
// telemetry's arguments are cache_sim_launch's (`window` 0 = off).
extern "C" int arc_launch(const int* traces, int* hits, int* dir_size, int* argmins, int* stamp,
                          unsigned char* in_cache, unsigned char* tags, int* links, int* series,
                          const int* groups, int* resident, int n_samples, int trace_len,
                          int n_objects, int capacity, int shared, int window, int n_groups,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TelArgs tel{series, groups, resident, window, n_groups};
  const size_t n = n_objects;
  const size_t bytes = shared ? (n + 7) / 8 * 8 + n * sizeof(int2) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_telemetry(tel, [&](auto on, auto grouped) {
    err = launch_heap_kernel(arc_kernel<decltype(on)::value, decltype(grouped)::value>,
                             n_samples, kWarp, bytes, st, traces, trace_len, n_objects, capacity,
                             hits, dir_size, argmins, stamp, in_cache, tags,
                             reinterpret_cast<int2*>(links), shared, tel);
  });
  return static_cast<int>(err);
}
