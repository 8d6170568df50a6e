// The windowed telemetry every cache_sim program records when it is asked to: the 11
// counters of telemetry.spec.METRICS per window of W requests, for each sample, ungrouped
// (S, n_w, 11) or per tenant group (S, n_w, G, 11), int32. Replaces `tel_update` and the
// refresh/churn rows of the TPU kernel `_cache_sim_kernel`
// (src/repro/kernels/cache_sim/cache_sim.py); it computes what they compute:
//
// * requests, hits, fills (a miss that stored), evictions (every victim; byte mode evicts
//   several for one insert) and the bytes of the hits and of the misses (the request's
//   size in a size-aware program, else 1) add up over the window; misses = requests - hits
//   and fill_offers = misses (a flat cache offers every miss);
// * occupancy is the cached-object count after the window's last request;
// * refreshes (a tinylfu aging step, a plfua_dyn hot-set refresh) and hot churn (the
//   ids that joined or left plfua_dyn's hot set) land in the window of the request that
//   completed the period.
// * Grouped: request metrics go to the requester's group, an eviction to its victim's,
//   occupancy is each group's cached count, churn each group's changed ids.
//
// Design. Thread 0 owns every step's scalars, so it owns the accumulator:
// * Ungrouped, the window's counters are registers of thread 0, written to the series once
//   a window (with occupancy from the count it already keeps): no memory traffic is added
//   to the per-request chain.
// * Grouped (any G >= 1), thread 0 adds into the series row of (window, group) in device
//   memory, and keeps each group's cached count in a zeroed (S, G) scratch, updated on each
//   fill and victim; a window's end writes each group's misses, offers and occupancy.
//   Churn per group is added by every thread of the refresh with atomicAdd.
// * Sums are int32 and wrap as the reference's (jnp int32) sums do.
//
// Each program takes the telemetry as template parameters <kTel, kGrouped>: with kTel false
// every member below compiles to nothing, so the instance without telemetry is the program
// as it was.

#pragma once

#include <type_traits>

#include "cache_sim_common.cuh"

namespace {

constexpr int kMetrics = 11;  // telemetry.spec.N_METRICS, in its order:
constexpr int kRequests = 0;
constexpr int kHits = 1;
constexpr int kMisses = 2;
constexpr int kFills = 3;
constexpr int kEvictions = 4;
constexpr int kOffers = 5;
constexpr int kOccupancy = 6;
constexpr int kRefreshes = 7;
constexpr int kChurn = 8;
constexpr int kHitBytes = 9;
constexpr int kMissBytes = 10;

// What a launch hands the kernel: the zeroed series (S, n_w, [G,] 11), the (N,) group row
// (values in [0, G)) and the zeroed (S, G) resident-count scratch of a grouped run, the
// window W (0 = off) and G (0 = ungrouped).
struct TelArgs {
  int* series;
  const int* groups;
  int* resident;
  int window;
  int n_groups;
};

// Calls launch(on, grouped) with the std::bool_constant pair of the instance `tel` asks for:
// no telemetry (window 0), ungrouped (n_groups 0) or grouped.
template <class Launch>
void with_telemetry(const TelArgs& tel, Launch launch) {
  if (tel.window == 0) launch(std::false_type{}, std::false_type{});
  else if (tel.n_groups == 0) launch(std::true_type{}, std::false_type{});
  else launch(std::true_type{}, std::true_type{});
}

template <bool kTel, bool kGrouped>
struct Telemetry {
  int* series;      // this sample's
  const int* groups;
  int* resident;    // this sample's G counts
  int window;
  int n_groups;
  int trace_len;
  int w = 0;        // the current window
  int left = 0;     // its requests still to come
  // thread 0's counters of the current window (ungrouped)
  int requests = 0, hits = 0, fills = 0, evictions = 0, refreshes = 0, churn = 0;
  int hit_bytes = 0, miss_bytes = 0;

  __device__ Telemetry(const TelArgs& a, size_t sample, int trace_len_)
      : series(nullptr), groups(nullptr), resident(nullptr), window(1), n_groups(1),
        trace_len(trace_len_) {
    if constexpr (kTel) {
      window = a.window;
      left = a.window;
      n_groups = kGrouped ? a.n_groups : 1;
      const int n_w = (trace_len_ + a.window - 1) / a.window;
      series = a.series + sample * static_cast<size_t>(n_w) * n_groups * kMetrics;
      if constexpr (kGrouped) {
        groups = a.groups;
        resident = a.resident + sample * static_cast<size_t>(n_groups);
      }
    }
  }

  // The series row of window `win` and group `g` (g = 0 ungrouped).
  __device__ __forceinline__ int* row(int win, int g) const {
    return series + (static_cast<size_t>(win) * n_groups + g) * kMetrics;
  }

  // Thread 0: one request of id x, whether it hit, whether a miss stored it, its bytes.
  __device__ __forceinline__ void request(int x, bool hit, bool fill, int size) {
    if constexpr (kTel) {
      if constexpr (kGrouped) {
        const int g = groups[x];
        int* r = row(w, g);
        r[kRequests] += 1;
        r[kHits] += hit;
        r[kFills] += fill;
        if (hit) r[kHitBytes] = wrap_add(r[kHitBytes], size);
        else r[kMissBytes] = wrap_add(r[kMissBytes], size);
        if (fill) resident[g] += 1;
      } else {
        requests += 1;
        hits += hit;
        fills += fill;
        if (hit) hit_bytes = wrap_add(hit_bytes, size);
        else miss_bytes = wrap_add(miss_bytes, size);
      }
    }
  }

  // Thread 0: `victim` was evicted; `cached` is whether it was cached before. The ungrouped
  // count follows the cache's count; a group's counts follow its cached ids, so a victim
  // that was not cached (the reference's argmin over an empty cache names id 0) counts in no
  // group.
  __device__ __forceinline__ void evict(int victim, bool cached) {
    if constexpr (kTel) {
      if constexpr (kGrouped) {
        if (!cached) return;
        const int g = groups[victim];
        row(w, g)[kEvictions] += 1;
        resident[g] -= 1;
      } else {
        evictions += 1;
      }
    }
  }

  // Thread 0: a refresh (tinylfu aging, plfua_dyn's hot set) completed by a request of x;
  // `churn_ids` is the ungrouped hot churn (grouped churn is added by hot_changed).
  __device__ __forceinline__ void refresh(int x, int churn_ids) {
    if constexpr (kTel) {
      if constexpr (kGrouped) {
        row(w, groups[x])[kRefreshes] += 1;
      } else {
        refreshes += 1;
        churn += churn_ids;
      }
    }
  }

  // Any thread, during plfua_dyn's refresh at step t (grouped): id i left or joined the
  // hot set.
  __device__ __forceinline__ void hot_changed(int t, int i) const {
    if constexpr (kTel && kGrouped) atomicAdd(row(t / window, groups[i]) + kChurn, 1);
  }

  // Thread 0, after everything of step t: at the window's last request write what is
  // left of the window, with `count` (the cached objects now) as its occupancy.
  __device__ __forceinline__ void end_step(int t, int count) {
    if constexpr (kTel) {
      if (--left != 0 && t + 1 != trace_len) return;
      if constexpr (kGrouped) {
        for (int g = 0; g < n_groups; ++g) {
          int* r = row(w, g);
          r[kMisses] = r[kRequests] - r[kHits];
          r[kOffers] = r[kMisses];
          r[kOccupancy] = resident[g];
        }
      } else {
        int* r = row(w, 0);
        r[kRequests] = requests;
        r[kHits] = hits;
        r[kMisses] = requests - hits;
        r[kFills] = fills;
        r[kEvictions] = evictions;
        r[kOffers] = requests - hits;
        r[kOccupancy] = count;
        r[kRefreshes] = refreshes;
        r[kChurn] = churn;
        r[kHitBytes] = hit_bytes;
        r[kMissBytes] = miss_bytes;
        requests = hits = fills = evictions = refreshes = churn = hit_bytes = miss_bytes = 0;
      }
      ++w;
      left = window;
    }
  }
};

}  // namespace
