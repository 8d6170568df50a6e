// flash_attention: blocked online-softmax attention with GQA, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (built by `flash_attention_pallas`).
// It computes that kernel's function, not its block schedule: for each (b, h, query row) a
// softmax, with f32 accumulation, over the live keys of kv head h / (H / KH) (GQA: no K/V
// repeat), then the weighted sum of V, written in the input's type. A key is live if
// col < kv_len and, when causal, col <= row (top-left aligned). The scale defaults to
// 1 / sqrt(D) in the wrapper.
//
// * One block of 128 threads per (b * H + h, tile of query rows). The TPU's sequential
//   ("arbitrary") kv grid axis, which carried acc/m/l in VMEM scratch, becomes a loop over
//   kv tiles inside the block; the running max, sum and accumulator live in registers.
// * Each query row is split over P = D / 32 threads (P = 1 for D <= 32), each holding 32
//   (or D) dims of q and of the accumulator; a score is their partial dot products summed
//   by warp shuffles. Prefill mode: one row per P threads, 128 / P rows a block. Decode
//   mode (few query rows): one row a block, its keys spread over 128 / P key lanes, each
//   with its own running max and sum, merged through shared memory at the end.
// * Each kv tile (128 / P keys) is staged in shared memory as f32, rows padded to D + 4
//   floats and each thread's 32-dim slice rotated by its part, so that the 16-byte reads
//   of one quarter-warp fall in distinct banks in both modes. A thread issues 16 loads of K
//   and 16 of V before it stores any, so that their latencies overlap.
// * Masking matches the reference's finite -1e30: a masked key adds exactly 0 once its row
//   has seen a live key (exp of -1e30 minus a live max underflows to 0 in f32), so masked
//   keys are skipped, and so are causal tiles past the block's last row and tiles at or
//   past kv_len. A row with no live key writes 0 (the reference kernel's l == 0 case); every
//   path of the model has kv_len >= 1, where each row has one.
// * Scores are kept in the log2 domain (q is pre-multiplied by scale * log2 e) and
//   exponentiated with exp2f.
//
// What bounds it on this card: prefill is bound by operations (4 * D flops a live (row,
// key) pair, which the tensor cores could do at 989 TFLOP/s in bf16); this kernel does
// them on the f32 CUDA cores (67 TFLOP/s peak), a simple first design. Decode (one query
// row) is bound by the bytes of the KV cache; decode mode spreads one row's keys over the
// whole block so that each block streams its kv head's cache with 128 threads, but it runs
// only B * H blocks. wgmma on TMA-staged bf16 tiles for prefill, and for decode splitting a
// row's keys over several blocks and packing the H / KH query heads of one kv head into one
// block (each K/V byte then read once, not H / KH times), are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;  // element strides; the last dim is contiguous
};

template <int D, bool kDecode>
struct Shape {
  static constexpr int kSlice = D < 32 ? D : 32;          // dims a thread holds
  static constexpr int kParts = D / kSlice;               // threads a row is split over
  static constexpr int kLanes = kDecode ? kThreads / kParts : 1;  // key lanes a row
  static constexpr int kRows = kThreads / (kParts * kLanes);      // query rows a block
  static constexpr int kTile = kThreads / kParts;                 // keys a kv tile
  static constexpr int kPerLane = kTile / kLanes;                 // keys a thread a tile
  static constexpr int kChunk = kPerLane < 32 ? kPerLane : 32;    // scores in registers
  static constexpr int kStride = D + 4;                           // smem floats a key
  static constexpr int kRotate = kParts > 1 ? 32 / kParts : 0;    // bank rotation a part
  static constexpr int kSmemFloats = 2 * kTile * kStride;
  static constexpr int kRowsPerPass = kThreads / D;          // keys the block stages a pass
  static constexpr int kLoads = kTile / kRowsPerPass;        // K (and V) elements a thread stages
  static constexpr int kBatch = kLoads < 16 ? kLoads : 16;   // loads in flight, of each
  static_assert(kThreads % D == 0 && kLoads % kBatch == 0, "a tile splits evenly over the threads");

  // shared-memory index of dim d of tile key j
  __device__ static __forceinline__ int index(int j, int d) {
    const int part = d / kSlice;
    const int dl = d % kSlice;
    return j * kStride + part * kSlice + ((dl + part * kRotate) & (kSlice - 1));
  }

  // dims 4i .. 4i + 3 of part `part` of tile key j: contiguous and 16-byte aligned, as
  // the rotation moves aligned groups of 4
  __device__ static __forceinline__ float4 load4(const float* tile, int j, int part, int i) {
    return *reinterpret_cast<const float4*>(tile + index(j, part * kSlice + 4 * i));
  }
};

template <typename T, int D, bool kDecode>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int n_heads,
             int group, int sq, int skv, int kv_len, int causal, float scale_log2) {
  using S = Shape<D, kDecode>;
  constexpr int kSlice = S::kSlice, kParts = S::kParts, kLanes = S::kLanes;
  __shared__ __align__(16) float smem[S::kSmemFloats];
  float* k_s = smem;
  float* v_s = smem + S::kTile * S::kStride;

  const int t = threadIdx.x;
  const int part = t % kParts;
  const int lane = (t / kParts) % kLanes;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads, kh = h / group;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * S::kRows;
  const int row = q0 + t / (kParts * kLanes);
  const bool row_ok = row < sq;
  const int kv_live = kv_len < skv ? kv_len : skv;
  int kv_end = kv_live;
  if (causal) {
    const int last = (q0 + S::kRows < sq ? q0 + S::kRows : sq);  // one past the last row
    kv_end = kv_end < last ? kv_end : last;
  }
  const int row_end = causal ? (row + 1 < kv_live ? row + 1 : kv_live) : kv_live;

  float q_r[kSlice];
  float acc[kSlice];
  const T* q_row = q + b * qs.b + h * qs.h + (long long)(row_ok ? row : 0) * qs.s + part * kSlice;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    q_r[i] = row_ok ? to_float(q_row[i]) * scale_log2 : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const T* k_head = k + b * ks.b + kh * ks.h;
  const T* v_head = v + b * vs.b + kh * vs.h;
  const int ld = t % D, lr = t / D;  // the dim and first key this thread stages
  for (int k0 = 0; k0 < kv_end; k0 += S::kTile) {
    __syncthreads();  // the previous tile's readers are done
    // each thread stages dim `ld` of every kRowsPerPass-th key from `lr`, kBatch of K and kBatch
    // of V in flight at a time (the loop over batches stays rolled, to spare registers)
    const T* k_col = k_head + (long long)(k0 + lr) * ks.s + ld;
    const T* v_col = v_head + (long long)(k0 + lr) * vs.s + ld;
#pragma unroll 1
    for (int i0 = 0; i0 < S::kLoads; i0 += S::kBatch) {
      float kx[S::kBatch], vx[S::kBatch];
#pragma unroll
      for (int i = 0; i < S::kBatch; ++i) {
        const int r = (i0 + i) * S::kRowsPerPass;
        const bool in = k0 + lr + r < skv;
        kx[i] = in ? to_float(k_col[(long long)r * ks.s]) : 0.f;
        vx[i] = in ? to_float(v_col[(long long)r * vs.s]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < S::kBatch; ++i) {
        const int j = lr + (i0 + i) * S::kRowsPerPass;
        k_s[S::index(j, ld)] = kx[i];
        v_s[S::index(j, ld)] = vx[i];
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < S::kPerLane; c0 += S::kChunk) {
      float s[S::kChunk];
      float m_chunk = kNeg;
#pragma unroll
      for (int c = 0; c < S::kChunk; ++c) {
        const int j = (c0 + c) * kLanes + lane;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kSlice / 4; ++i) {
          const float4 kv4 = S::load4(k_s, j, part, i);
          dot += q_r[4 * i] * kv4.x + q_r[4 * i + 1] * kv4.y + q_r[4 * i + 2] * kv4.z +
                 q_r[4 * i + 3] * kv4.w;
        }
#pragma unroll
        for (int off = kParts / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int col = k0 + j;
        const bool live = row_ok && col < row_end;
        s[c] = live ? dot : kNeg;
        m_chunk = fmaxf(m_chunk, s[c]);
      }
      const float m_new = fmaxf(m, m_chunk);
      const float alpha = exp2f(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < S::kChunk; ++c) {
        if (s[c] == kNeg) continue;  // masked: adds exactly 0
        const float p = exp2f(s[c] - m);
        l += p;
        const int j = (c0 + c) * kLanes + lane;
#pragma unroll
        for (int i = 0; i < kSlice / 4; ++i) {
          const float4 vv = S::load4(v_s, j, part, i);
          acc[4 * i] += p * vv.x;
          acc[4 * i + 1] += p * vv.y;
          acc[4 * i + 2] += p * vv.z;
          acc[4 * i + 3] += p * vv.w;
        }
      }
    }
  }

  T* o_row = o + b * os.b + h * os.h + (long long)row * os.s;
  if constexpr (kLanes == 1) {
    if (row_ok) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int i = 0; i < kSlice; ++i) store(o_row + part * kSlice + i, acc[i] * inv);
    }
  } else {
    // merge the key lanes' partial softmax states of the block's one row
    __syncthreads();
    float* red = smem;                     // kLanes x (D + 1) accumulators
    float* ml = smem + kLanes * (D + 1);   // kLanes x (m, l)
#pragma unroll
    for (int i = 0; i < kSlice; ++i) red[lane * (D + 1) + part * kSlice + i] = acc[i];
    if (part == 0) {
      ml[2 * lane] = m;
      ml[2 * lane + 1] = l;
    }
    __syncthreads();
    if (t < D && row_ok) {
      float m_all = kNeg;
      for (int r = 0; r < kLanes; ++r) m_all = fmaxf(m_all, ml[2 * r]);
      float l_all = 0.f, a = 0.f;
      for (int r = 0; r < kLanes; ++r) {
        const float w = exp2f(ml[2 * r] - m_all);
        l_all += ml[2 * r + 1] * w;
        a += red[r * (D + 1) + t] * w;
      }
      store(o_row + t, a / (l_all == 0.f ? 1.f : l_all));
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, Strides qs, Strides ks,
                     Strides vs, Strides os, int batch, int n_heads, int n_kv_heads, int sq,
                     int skv, int kv_len, int causal, float scale_log2, int decode,
                     cudaStream_t stream) {
  const int group = n_heads / n_kv_heads;
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  auto* ot = static_cast<T*>(o);
  if (decode) {
    const dim3 grid(sq, batch * n_heads);
    flash_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(qt, kt, vt, ot, qs, ks, vs, os, n_heads,
                                                            group, sq, skv, kv_len, causal, scale_log2);
  } else {
    constexpr int rows = Shape<D, false>::kRows;
    const dim3 grid((sq + rows - 1) / rows, batch * n_heads);
    flash_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(qt, kt, vt, ot, qs, ks, vs, os, n_heads,
                                                             group, sq, skv, kv_len, causal, scale_log2);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int head_dim, const void* q, const void* k, const void* v, void* o, Strides qs,
                     Strides ks, Strides vs, Strides os, int batch, int n_heads, int n_kv_heads,
                     int sq, int skv, int kv_len, int causal, float scale_log2, int decode,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len,
                             causal, scale_log2, decode, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len,
                             causal, scale_log2, decode, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len,
                             causal, scale_log2, decode, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len,
                              causal, scale_log2, decode, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns cudaGetLastError(): a launch
// the runtime rejects never runs, so the caller must check this code. q/o are (B, H, Sq, D)
// and k/v (B, KH, Skv, D), each given by its element strides for the first three dims (the
// last is contiguous); dtype 0 = float32, 1 = bfloat16; decode 1 = one query row a block.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      long long q_sb, long long q_sh, long long q_ss,
                                      long long k_sb, long long k_sh, long long k_ss,
                                      long long v_sb, long long v_sh, long long v_ss,
                                      long long o_sb, long long o_sh, long long o_ss, int batch,
                                      int n_heads, int n_kv_heads, int sq, int skv, int head_dim,
                                      int kv_len, int causal, float scale, int dtype, int decode,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_t<float>(head_dim, q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv,
                          kv_len, causal, scale_log2, decode, st);
  } else if (dtype == 1) {
    err = launch_t<__nv_bfloat16>(head_dim, q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads,
                                  sq, skv, kv_len, causal, scale_log2, decode, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
