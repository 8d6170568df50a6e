// Device helpers shared by the cache_sim programs (cache_sim.cu, wlfu.cu, tinylfu.cu,
// plfua_dyn.cu, sized.cu, arc.cu): the residents' heap that gives every program but arc its
// victims, the launch helper every program launches through, block-wide sums (plfua_dyn's
// refresh), int32 arithmetic that wraps as the reference's, and the count-min sketch's
// lowbias32 hashing. arc.cu keeps its lists itself.
//
// What bounds a program on this card is its chain of T dependent steps, not bytes or
// operations: thread 0 runs the trace, and a victim costs the heap's ceil(log2 slots) levels
// of dependent reads in shared memory. The heap is one thread's; block_reduce is called from
// all threads of a block (it holds __syncthreads()).

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

// ------------------------------------------------------------------ the residents' heap
// A binary min-heap of the cached ids, ordered by (key, id): smaller key, then lower id, so its
// top is the reference's victim: the argmin of where(cached, key, INT_MAX), ties to the lowest
// id. One thread owns it. Each slot is one 64-bit word, ((uint32)key ^ 0x80000000) << 32 | id,
// so that one unsigned compare is the lexicographic one, for signed and wrapped keys alike.
// `pos[id]` is the id's slot, or -1 for an id that is not cached: the hit test.
//
// The slots lie in shared memory; a heap that would outgrow them moves, once, into a device
// buffer that holds every slot the cache can need (no grid case does). Every access goes
// through that one pointer: a test on each access (shared or device slot?) costs the step
// more than generic addressing does (experiments/cache_sim_variants.py).
//
// The program keeps each cached id's key in its slot: only a request's id, the victims and
// (wlfu) the id leaving the window change a key within a step, and it re-keys, pushes or pops
// them. The heap also keeps one id's slot in a register (`watch`, `watch_pos`): the next
// request's, loaded a step ahead so that its latency overlaps the step; with kWatches = 2 a
// second (`watch2`, `watch2_pos`: wlfu's next departing id). Every write of a slot keeps
// both registers true.

__device__ __forceinline__ unsigned long long heap_entry(int key, int id) {
  return static_cast<unsigned long long>(static_cast<uint32_t>(key) ^ 0x80000000u) << 32 |
         static_cast<uint32_t>(id);
}

__device__ __forceinline__ int entry_id(unsigned long long e) {
  return static_cast<int>(static_cast<uint32_t>(e));
}

__device__ __forceinline__ int entry_key(unsigned long long e) {
  return static_cast<int>(static_cast<uint32_t>(e >> 32) ^ 0x80000000u);
}

template <int kWatches>
struct ResidentHeapOf {
  static_assert(kWatches == 1 || kWatches == 2, "one or two watched ids");
  unsigned long long* slot;    // shared memory, or `device` once the heap has moved there
  int capacity;                // the slots at `slot`
  unsigned long long* device;  // `device_capacity` slots in device memory, or null
  int device_capacity;
  int* pos;
  int size = 0;
  int watch = -1;     // the next request's id
  int watch_pos = -1; // and its slot
  int watch2 = -1;    // kWatches == 2: a second id
  int watch2_pos = -1;

  __device__ __forceinline__ void set_pos(int id, int i) {
    pos[id] = i;
    if (id == watch) watch_pos = i;
    if (kWatches == 2 && id == watch2) watch2_pos = i;
  }

  // Load `id`'s slot ahead of the step that requests it.
  __device__ __forceinline__ void look_ahead(int id) {
    watch = id;
    watch_pos = pos[id];
  }

  // Load the second watched id's slot ahead of the step that needs it.
  __device__ __forceinline__ void look_ahead2(int id) {
    watch2 = id;
    watch2_pos = pos[id];
  }

  __device__ __forceinline__ void put(int i, unsigned long long e) {
    slot[i] = e;
    set_pos(entry_id(e), i);
  }

  __device__ void sift_up(int i, unsigned long long e) {
    while (i > 0) {
      const int parent = (i - 1) / 2;
      const unsigned long long pe = slot[parent];
      if (pe < e) break;
      put(i, pe);
      i = parent;
    }
    put(i, e);
  }

  __device__ void sift_down(int i, unsigned long long e) {
    for (;;) {
      int c = 2 * i + 1;
      if (c >= size) break;
      unsigned long long ce = slot[c];
      if (c + 1 < size) {
        const unsigned long long c2 = slot[c + 1];
        if (c2 < ce) {
          ce = c2;
          ++c;
        }
      }
      if (e < ce) break;
      put(i, ce);
      i = c;
    }
    put(i, e);
  }

  __device__ void push(int key, int id) {
    if (size == capacity) {
      // outgrown shared memory: the slots move to the device buffer (positions stay)
      for (int i = 0; i < size; ++i) device[i] = slot[i];
      slot = device;
      capacity = device_capacity;
    }
    sift_up(size++, heap_entry(key, id));
  }

  // The cached id at slot i takes `key`: up or down (a gdsf re-price can lower a key).
  __device__ __forceinline__ void rekey(int i, int key, int id) {
    const unsigned long long e = heap_entry(key, id);
    if (e < slot[i]) sift_up(i, e);
    else sift_down(i, e);
  }

  // The reference's victim, without removing it: the top, with `cached` set and its key in
  // `key`. Two cases keep the argmin exact where the top is not its answer, both id 0, not
  // cached: an empty heap (capacity <= 0 before anything is cached), and a top at INT_MAX that
  // is not id 0, where every id's masked key is INT_MAX (no grid case reaches it: lru's stamps
  // and the counts stay below T, and only a gdsf score that wraps can land on INT_MAX).
  __device__ __forceinline__ int victim(bool& cached, int& key) const {
    if (size > 0) {
      const unsigned long long top = slot[0];
      key = entry_key(top);
      cached = key != INT_MAX || entry_id(top) == 0;
      if (cached) return entry_id(top);
    }
    cached = false;
    return 0;
  }

  // Remove the top (the victim `victim` named, when cached).
  __device__ __forceinline__ void pop() {
    set_pos(entry_id(slot[0]), -1);
    if (--size > 0) sift_down(0, slot[size]);
  }

  // Replace the top (a cached victim) by `id` with `key`: a pop and a push in one sift.
  __device__ __forceinline__ void replace_top(int key, int id) {
    set_pos(entry_id(slot[0]), -1);
    sift_down(0, heap_entry(key, id));
  }
};

using ResidentHeap = ResidentHeapOf<1>;

// Where a heap program keeps its heap and rows, as the wrapper's `heap_plan` chose them:
// dynamic shared memory holds `shared_slots` heap slots, then, with `rows_shared`, `n_rows`
// int rows of n_objects ids (pos first); otherwise the rows are the sample's rows of device
// buffers. A sample's heap can need `slots` slots; past `shared_slots` it moves to its row of
// an (S, slots) device buffer.
struct HeapLayout {
  int slots;
  int shared_slots;
  int rows_shared;
};

// Bytes of dynamic shared memory a block of `layout` takes.
inline size_t heap_shared_bytes(const HeapLayout& layout, int n_objects, int n_rows) {
  return static_cast<size_t>(layout.shared_slots) * sizeof(unsigned long long) +
         (layout.rows_shared ? static_cast<size_t>(n_rows) * n_objects * sizeof(int) : 0);
}

// Thread 0 of each block keeps the trace's next lines coming into L2 ahead of its loads.
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// Set the instance's dynamic shared memory limit to `bytes`, prefer the most L1 that leaves
// its block that much shared memory (the runtime's default split was as fast or slower for
// every program: experiments/cache_sim_variants.py), and launch it: one block of `threads`
// threads a sample (kWarp for the one-warp programs). Returns the first CUDA error (a refused
// limit, preference or launch).
template <class Kernel, class... Args>
cudaError_t launch_heap_kernel(Kernel kernel, int n_samples, int threads, size_t bytes,
                               cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return err;
  kernel<<<n_samples, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// ------------------------------------------------------- int32 as the reference wraps it
// jnp int32 arithmetic wraps; signed overflow is undefined in C++, so these go through
// uint32_t, whose arithmetic wraps, and back.

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_shl(int a, int bits) {
  return static_cast<int>(static_cast<uint32_t>(a) << bits);
}

// a // b rounded toward minus infinity (jnp's and torch's int floor division), for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Sum (max when `take_max`) of one int per thread, returned to every thread. `s_part`
// holds an int per warp of the block. The barrier before the return lets the next call reuse
// `s_part`, and orders every thread's memory writes before the call against every
// thread's reads after it.
__device__ int block_reduce(int v, bool take_max, int* s_part) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const int o = __shfl_down_sync(0xffffffffu, v, off);
    v = take_max ? max(v, o) : v + o;
  }
  if (threadIdx.x % kWarp == 0) s_part[threadIdx.x / kWarp] = v;
  __syncthreads();
  int total = s_part[0];
  for (int w = 1; w < static_cast<int>(blockDim.x) / kWarp; ++w) {
    total = take_max ? max(total, s_part[w]) : total + s_part[w];
  }
  __syncthreads();
  return total;
}

// ------------------------------------------------------------ count-min sketch hashing
// The reference's sketch module computes these tables host-side in numpy uint32; uint32_t
// arithmetic wraps the same way, so the kernels hash the id where they need a bucket.

constexpr int kDepth = 4;       // sketch rows
constexpr int kBloomDepth = 2;  // doorkeeper hashes

__device__ __forceinline__ uint32_t sketch_salt(int d) {
  return d == 0 ? 0x9E3779B9u : d == 1 ? 0x85EBCA6Bu : d == 2 ? 0xC2B2AE35u : 0x27D4EB2Fu;
}

__device__ __forceinline__ uint32_t bloom_salt(int d) {
  return d == 0 ? 0xB5297A4Du : 0x68E31DA4u;
}

// lowbias32 finalizer (hash-prospector constants).
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// mix32((id + 1) * salt) % modulus: one entry of bucket_table / bloom_table.
__device__ __forceinline__ int salted_index(int id, uint32_t salt, int modulus) {
  return static_cast<int>(mix32((static_cast<uint32_t>(id) + 1u) * salt) %
                          static_cast<uint32_t>(modulus));
}

// Count-min estimate of `id`: min over the kDepth rows (row d at rows + d * width).
__device__ __forceinline__ int sketch_estimate(const int* rows, int width, int id) {
  int est = INT_MAX;
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    est = min(est, rows[d * width + salted_index(id, sketch_salt(d), width)]);
  }
  return est;
}

// The kDepth buckets of `id` in a sketch of `width` counters a row (row d at d * width).
__device__ __forceinline__ void buckets_of(int id, int width, int (&b)[kDepth]) {
#pragma unroll
  for (int d = 0; d < kDepth; ++d) b[d] = d * width + salted_index(id, sketch_salt(d), width);
}

}  // namespace

// Every library of the cache_sim programs exports this, for the wrapper's error message
// (each library is built from one source that includes this header once).
extern "C" const char* cache_sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
