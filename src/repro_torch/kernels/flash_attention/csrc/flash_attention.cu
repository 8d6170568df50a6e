// flash_attention: blocked online-softmax attention with GQA, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (built by `flash_attention_pallas`).
// It computes that kernel's function, not its block schedule: for each (b, h, query row) a
// softmax, with f32 accumulation, over the live keys of kv head h / (H / KH) (GQA: no K/V
// repeat), then the weighted sum of V, written in the input's type. A key is live if
// col < kv_len and, when causal, col <= row (top-left aligned). The scale defaults to
// 1 / sqrt(D) in the wrapper. Masking matches the reference's finite -1e30: a masked key
// adds exactly 0 once its row has seen a live key, and a row with no live key writes 0 (the
// reference kernel's l == 0 case); every path of the model has kv_len >= 1.
//
// Three kernels behind one C entry, chosen by the wrapper's instance and the dtype:
//
// * prefill, bf16 (`prefill_tc_kernel`): bound by operations (4 D flops a live (row, key)
//   pair), so it runs on the tensor cores. A block takes 128 query rows of one (b, h): two
//   consumer warpgroups of 64 rows and one producer warp. The producer copies the Q tile
//   once and the K and V tiles (64 keys) into a ring of two stages with TMA, through 4-d
//   tensor maps (D, S, heads, B) built from the element strides, so the model's transposed
//   views load as they lie; rows past Sq or Skv arrive as zeros. Rows of more than 128 bytes
//   are 64-column boxes, D / 64 of them (two at D = 128, three at MLA's D = 192: Q 48 KB and
//   a K/V stage 48 KB, 145 KB with two stages); each box is swizzled at its row width (32,
//   64 or 128 B). Each consumer runs S = Q K^T as wgmma (both operands K-major in shared memory, f32
//   accumulator), scales by scale * log2 e after the product, masks, and keeps the online
//   max and sum in f32 (2^x by the SFU's ex2.approx). P V is two wgmmas into one f32
//   accumulator, P_hi = bf16(p) and P_lo = bf16(p - P_hi) from registers (the S
//   accumulator's fragment is the A fragment's layout) and V from shared memory, MN-major
//   (the transpose bit), one m64n64 product a 64-column box of V (three at D = 192: N = 192
//   in all, a 96-float accumulator a thread): p keeps about 16 bits, where one bf16 rounding
//   of p would break the kernel's tolerance of one output rounding. That costs 6 D flops a
//   pair, not 4 D. Each
//   warpgroup runs its tile's S, softmax and P V in turn; the two warpgroups overlap each
//   other. Causal tiles past the block's last row are skipped, and the heaviest row tiles
//   start first.
// * prefill, f32 (`prefill_f32_kernel`): on the CUDA cores, as the kernel's first design;
//   TF32 tensor cores would miss the f32 tolerance (2e-5). Each query row is split over
//   P = D / 32 threads (P = 1 for D <= 32), 128 / P rows a block, each kv tile (128 / P keys)
//   staged in shared memory as f32, rows padded to D + 4 floats and each thread's 32-dim
//   slice rotated by its part, so that 16-byte reads of one quarter-warp fall in distinct
//   banks. At D = 192 a row is split over P = 4 threads of 48 dims (32 rows a block: six
//   parts would neither divide the block nor reduce by shuffles), and a kv tile is 16 keys,
//   so that two tiles fit the 48 KB of static shared memory.
// * decode, both dtypes (`decode_kernel`, at most 16 query rows): bound by the bytes of the
//   KV cache. A block takes all G * Sq query rows of one kv head (G = H / KH; in groups of
//   32 rows beyond that), so each K/V byte is read once and not G times, over one contiguous
//   split of the live keys; the wrapper picks the splits so that the blocks fill the SMs. K
//   and V rows come in with 16-byte cp.async copies into a two-stage ring (rows padded by 16
//   bytes: conflict-free row reads; 128, 64 or 32 keys a tile by the row's bytes, so that
//   the ring fits shared memory up to f32 at D = 192); scores, softmax and P V on the CUDA
//   cores in f32. Each
//   block writes its partial (m, l, acc) for each row to an f32 scratch; the last block of a
//   (b, kv head, row group), found by a counter that it resets to 0 for the next launch,
//   merges them. With one split the block writes the output itself.

#include <cuda.h>  // CUtensorMap and the driver's enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;  // element strides; the last dim is contiguous
};

// ============================================================ prefill, f32: CUDA cores
namespace f32 {

constexpr int kThreads = 128;

template <int D>
struct Shape {
  static constexpr int kSlice = D < 32 ? D : D == 192 ? 48 : 32;  // dims a thread holds
  static constexpr int kParts = D / kSlice;               // threads a row is split over (a power of 2)
  static constexpr int kRows = kThreads / kParts;         // query rows a block
  static constexpr int kStride = D + 4;                   // smem floats a key
  // keys a kv tile: as many as the block has rows, halved where two tiles would pass 48 KB
  static constexpr int kTile = 2 * kRows * kStride * 4 <= 48 * 1024 ? kRows : kRows / 2;
  static constexpr int kChunk = kTile < 32 ? kTile : 32;  // scores in registers
  static constexpr int kRotate = kParts > 1 ? 32 / kParts : 0;  // bank rotation a part
  static constexpr int kSmemFloats = 2 * kTile * kStride;
  static constexpr int kLoads = kTile * D / kThreads;        // K (and V) elements a thread stages
  static constexpr int kBatch = kLoads % 16 == 0 ? 16 : 8;   // loads in flight, of each
  static_assert((kParts & (kParts - 1)) == 0 && kSlice % 4 == 0, "a row splits into 16-byte groups");
  static_assert(kTile * D % kThreads == 0 && kLoads % kBatch == 0, "a tile splits evenly over the threads");

  // shared-memory index of dim d of tile key j
  __device__ static __forceinline__ int index(int j, int d) {
    const int part = d / kSlice;
    const int dl = d % kSlice;
    return j * kStride + part * kSlice + (dl + part * kRotate) % kSlice;
  }

  // dims 4i .. 4i + 3 of part `part` of tile key j: contiguous and 16-byte aligned, as
  // the rotation moves aligned groups of 4
  __device__ static __forceinline__ float4 load4(const float* tile, int j, int part, int i) {
    return *reinterpret_cast<const float4*>(tile + index(j, part * kSlice + 4 * i));
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   float* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int n_heads, int group,
                   int sq, int kv_live, int causal, float scale_log2) {
  using S = Shape<D>;
  constexpr int kSlice = S::kSlice, kParts = S::kParts;
  __shared__ __align__(16) float smem[S::kSmemFloats];
  float* k_s = smem;
  float* v_s = smem + S::kTile * S::kStride;

  const int t = threadIdx.x;
  const int part = t % kParts;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads, kh = h / group;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * S::kRows;
  const int row = q0 + t / kParts;
  const bool row_ok = row < sq;
  int kv_end = kv_live;
  if (causal) {
    const int last = (q0 + S::kRows < sq ? q0 + S::kRows : sq);  // one past the last row
    kv_end = kv_end < last ? kv_end : last;
  }
  const int row_end = causal ? (row + 1 < kv_live ? row + 1 : kv_live) : kv_live;

  float q_r[kSlice];
  float acc[kSlice];
  const float* q_row = q + b * qs.b + h * qs.h + (long long)(row_ok ? row : 0) * qs.s + part * kSlice;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    q_r[i] = row_ok ? q_row[i] * scale_log2 : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const float* k_head = k + b * ks.b + kh * ks.h;
  const float* v_head = v + b * vs.b + kh * vs.h;
  for (int k0 = 0; k0 < kv_end; k0 += S::kTile) {
    __syncthreads();  // the previous tile's readers are done
    // the block stages the tile's elements in order, element x = t + n * kThreads (key x / D,
    // dim x % D), kBatch of K and kBatch of V in flight at a time (the loop over batches stays
    // rolled, to spare registers)
#pragma unroll 1
    for (int i0 = 0; i0 < S::kLoads; i0 += S::kBatch) {
      float kx[S::kBatch], vx[S::kBatch];
#pragma unroll
      for (int i = 0; i < S::kBatch; ++i) {
        const int x = t + (i0 + i) * kThreads, j = x / D, d = x % D;
        const bool in = k0 + j < kv_live;
        kx[i] = in ? k_head[(long long)(k0 + j) * ks.s + d] : 0.f;
        vx[i] = in ? v_head[(long long)(k0 + j) * vs.s + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < S::kBatch; ++i) {
        const int x = t + (i0 + i) * kThreads;
        k_s[S::index(x / D, x % D)] = kx[i];
        v_s[S::index(x / D, x % D)] = vx[i];
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < S::kTile; c0 += S::kChunk) {
      float s[S::kChunk];
      float m_chunk = kNeg;
#pragma unroll
      for (int c = 0; c < S::kChunk; ++c) {
        const int j = c0 + c;
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
        const int j = c0 + c;
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

  if (row_ok) {
    float* o_row = o + b * os.b + h * os.h + (long long)row * os.s;
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) o_row[part * kSlice + i] = acc[i] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs, Strides ks, Strides vs,
                   Strides os, int batch, int n_heads, int group, int sq, int kv_live, int causal,
                   float scale_log2, cudaStream_t stream) {
  constexpr int rows = Shape<D>::kRows;
  const dim3 grid((sq + rows - 1) / rows, batch * n_heads);
  prefill_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), qs, ks, vs, os, n_heads, group, sq, kv_live, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace f32

// ============================================================ prefill, bf16: wgmma on TMA tiles
namespace tc {

constexpr int kRows = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int kKeys = 64;        // keys a kv tile: S is one m64n64 wgmma a k step
constexpr int kStages = 2;       // K/V tiles in flight
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;  // and one producer warp

template <int D>
struct Cfg {
  static constexpr int kSub = D > 64 ? D / 64 : 1;  // 64-column boxes a row
  static constexpr int kCols = D / kSub;            // columns a box
  static constexpr int kRowBytes = kCols * 2;       // 32, 64 or 128: the swizzle span
  static constexpr int kQSub = kRows * kRowBytes;   // bytes of one Q box
  static constexpr int kKVSub = kKeys * kRowBytes;  // bytes of one K (or V) box
  static constexpr int kQBytes = kSub * kQSub;
  static constexpr int kKVBytes = kSub * kKVSub;    // one K (or V) tile
  static constexpr int kBarriers = 1 + 2 * kStages; // Q full; each stage's full and empty
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;  // descriptor swizzle
  static constexpr uint32_t kAtom = 8 * kRowBytes;  // bytes between 8-row groups (the SBO)
  static_assert(kQSub % 1024 == 0 && kKVSub % 1024 == 0, "tiles stay aligned to the 1,024-byte swizzle atom");
  static_assert(kSub * kCols == D && kSmem <= 232448, "a row is whole boxes, and the tiles fit shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
prefill_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, Strides os,
                  int n_heads, int group, int sq, int kv_live, int causal, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // [box] of kRows rows
  const uint32_t k_s = q_s + C::kQBytes;                      // [stage][box] of kKeys rows
  const uint32_t v_s = k_s + kStages * C::kKVBytes;
  const uint32_t bars = v_s + kStages * C::kKVBytes;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads, kh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // the heaviest causal tiles first
  const int q_last = min(q0 + kRows, sq);                 // one past the block's last row
  const int kv_end = causal ? min(kv_live, q_last) : kv_live;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // the producer warp: one thread issues every copy
    if (threadIdx.x == kConsumers * 128) {
      mbar_arrive_expect_tx(q_full, C::kQBytes);
      for (int s = 0; s < C::kSub; ++s) tma_load_4d(q_s + s * C::kQSub, &q_map, q_full, s * C::kCols, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty(st), (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(full(st), 2 * C::kKVBytes);
        for (int s = 0; s < C::kSub; ++s) {
          const uint32_t off = st * C::kKVBytes + s * C::kKVSub;
          tma_load_4d(k_s + off, &k_map, full(st), s * C::kCols, i * kKeys, kh, b);
          tma_load_4d(v_s + off, &v_map, full(st), s * C::kCols, i * kKeys, kh, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; thread t holds rows r0 and r0 + 8 of its warp's 16,
  // and in each 8-column block of S (and O) the columns cq and cq + 1
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int wg_row0 = q0 + wg * 64;
  const int r0 = wg_row0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  // the keys this warpgroup's rows see (none if its rows are all past Sq)
  const int wg_end = wg_row0 >= sq ? 0 : causal ? min(kv_live, min(wg_row0 + 64, sq)) : kv_live;
  const uint32_t q_wg = q_s + wg * 64 * C::kRowBytes;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sums

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int n0 = i * kKeys;
    mbar_wait(full(st), (i / kStages) & 1);
    if (n0 < wg_end) {
      // S = Q K^T: 64 x kKeys, f32
      float s[kKeys / 2];
#pragma unroll
      for (int j = 0; j < kKeys / 2; ++j) s[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < C::kSub; ++sub) {
#pragma unroll
        for (int kk = 0; kk < C::kCols / 16; ++kk) {
          const uint64_t da = smem_desc(q_wg + sub * C::kQSub + kk * 32, 16, C::kAtom, C::kLayout);
          const uint64_t db = smem_desc(k_s + st * C::kKVBytes + sub * C::kKVSub + kk * 32, 16, C::kAtom, C::kLayout);
          wgmma_ss_n64(s, da, db, (sub | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kKeys / 2>(s);

      // scale, mask (only tiles that cross kv_live or the diagonal), online max and sum
      const bool edge = n0 + kKeys > kv_live || (causal && n0 + kKeys - 1 > wg_row0);
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int j = 0; j < kKeys / 2; ++j) {
        float x = s[j] * scale_log2;
        if (edge) {
          const int col = n0 + 8 * (j / 4) + cq + (j & 1);
          const int row = (j & 2) ? r1 : r0;
          if (col >= kv_live || (causal && col > row)) x = -INFINITY;
        }
        s[j] = x;
        if (j & 2) {
          mx1 = fmaxf(mx1, x);
        } else {
          mx0 = fmaxf(mx0, x);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;

      // p = 2^(s - m) as P_hi + P_lo, packed into the A fragments of P V: pair j / 2 holds
      // (row r0 or r1, columns cq, cq + 1 of block j / 4), so k chunk c (keys 16c .. 16c + 15)
      // is pairs 4c .. 4c + 3
      uint32_t hi[kKeys / 4], lo[kKeys / 4];
#pragma unroll
      for (int j = 0; j < kKeys / 2; j += 2) {
        const float m = (j & 2) ? m1 : m0;
        const float pa = fast_exp2(s[j] - m), pb = fast_exp2(s[j + 1] - m);
        if (j & 2) {
          l1 += pa + pb;
        } else {
          l0 += pa + pb;
        }
        const __nv_bfloat162 ph = __floats2bfloat162_rn(pa, pb);
        const float2 back = __bfloat1622float2(ph);
        const __nv_bfloat162 pl = __floats2bfloat162_rn(pa - back.x, pb - back.y);
        hi[j / 2] = *reinterpret_cast<const uint32_t*>(&ph);
        lo[j / 2] = *reinterpret_cast<const uint32_t*>(&pl);
      }

      // O += P_hi V + P_lo V
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kKeys / 16; ++c) {
#pragma unroll
        for (int sub = 0; sub < C::kSub; ++sub) {
          const uint64_t dv = smem_desc(v_s + st * C::kKVBytes + sub * C::kKVSub + c * 16 * C::kRowBytes,
                                        C::kKVSub, C::kAtom, C::kLayout);
          wgmma_rs<C::kCols>(acc + sub * (C::kCols / 2), hi + 4 * c, dv);
          wgmma_rs<C::kCols>(acc + sub * (C::kCols / 2), lo + 4 * c, dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
  }

  // the row sums over the 4 threads of a row; O / l (l == 0 -> 1), rounded to bf16 once
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* o0 = o + b * os.b + h * os.h + (long long)r0 * os.s + cq;
  __nv_bfloat16* o1 = o0 + 8 * os.s;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * i) = __floats2bfloat162_rn(acc[4 * i] / d0, acc[4 * i + 1] / d0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no link against libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a bf16 tensor (B, heads, S, D) with element strides `st` as a 4-d map (D, S, heads, B) with a
// (box_cols, box_rows, 1, 1) box, swizzled at box_cols * 2 bytes. A dim of size 1 has no
// stride to speak of; it gets one TMA takes.
bool encode_map(CUtensorMap* map, const void* base, int d, int s, int heads, int batch, Strides st, int box_cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t whole = ((cuuint64_t)d * s * heads * batch * 2 + 15) / 16 * 16;
  auto stride = [&](long long elems, int size) { return size == 1 ? whole : (cuuint64_t)elems * 2; };
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {stride(st.s, s), stride(st.h, heads), stride(st.b, batch)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs, Strides ks, Strides vs,
                   Strides os, int batch, int n_heads, int n_kv_heads, int sq, int skv, int kv_live, int causal,
                   float scale_log2, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, D, sq, n_heads, batch, qs, C::kCols, kRows) ||
      !encode_map(&k_map, k, D, skv, n_kv_heads, batch, ks, C::kCols, kKeys) ||
      !encode_map(&v_map, v, D, skv, n_kv_heads, batch, vs, C::kCols, kKeys))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(prefill_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + kRows - 1) / kRows);
  prefill_tc_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), os,
                                                             n_heads, n_heads / n_kv_heads, sq, kv_live, causal,
                                                             scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

// ============================================================ decode: split keys, a kv head a block
namespace dec {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // query rows a block holds: G * Sq of one kv head, in row groups beyond
constexpr int kMaxSplits = 128;  // splits of a launch at most (the merge's weights fill the K/V tiles)
constexpr int kMergeBatch = 8;   // partials the merge loads at once

template <typename T, int D>
struct Cfg {
  static constexpr int kKeys = sizeof(T) * D <= 256 ? 128 : sizeof(T) * D <= 512 ? 64 : 32;  // keys a tile
  static constexpr int kVec = 16 / sizeof(T);                      // elements a 16-byte copy
  static constexpr int kStride = D + kVec;   // smem elements a key row: a 16-byte shift a row
  static constexpr int kVecs = D / kVec;     // 16-byte copies a key row
  static constexpr int kLanes = kThreads / kKeys;       // row lanes of the score phase
  static constexpr int kRowsPerLane = kRows / kLanes;
  static constexpr int kOut = kRows * D / kThreads;     // (row, dim) outputs a thread
  static constexpr int kTileElems = kKeys * kStride;    // one K (or V) tile
  static constexpr int kSmem = 4 * kTileElems * (int)sizeof(T) + (kRows * D + kRows * kKeys + 3 * kRows) * 4;
  static_assert(4 * kTileElems * (int)sizeof(T) >= kMaxSplits * kRows * 4, "the merge's weights fit the tiles");
  static_assert(kSmem <= 232448, "the ring and the row state fit shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
              Strides qs, Strides ks, Strides vs, Strides os, int n_kv_heads, int group, int sq, int kv_end,
              int causal, float scale_log2, int row_groups, int split_keys, float* __restrict__ part,
              int* __restrict__ counters) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);  // [stage][K, V][kKeys][kStride]
  float* q_s = reinterpret_cast<float*>(smem_raw + 4 * C::kTileElems * sizeof(T));  // [kRows][D]
  float* p_s = q_s + kRows * D;     // [kRows][kKeys]: scores, then weights
  float* m_s = p_s + kRows * C::kKeys;  // running max (log2 domain)
  float* l_s = m_s + kRows;             // running sum
  float* a_s = l_s + kRows;             // this tile's rescale
  __shared__ int last;

  const int t = threadIdx.x, lane = t % 32;
  const int blk = blockIdx.x;  // (b, kv head, row group)
  const int rg = blk % row_groups, kh = blk / row_groups % n_kv_heads, b = blk / row_groups / n_kv_heads;
  const int row0 = rg * kRows;
  const int n_rows = min(kRows, group * sq - row0);
  const int k_begin = blockIdx.y * split_keys;
  const int k_end = min(k_begin + split_keys, kv_end);  // the wrapper launches no empty split
  // row r of the block is query row qi of head kh * group + g
  auto head_of = [&](int r) { return kh * group + (row0 + r) / sq; };
  auto qi_of = [&](int r) { return (row0 + r) % sq; };

  for (int x = t; x < n_rows * D; x += kThreads) {
    const int r = x / D, d = x % D;
    q_s[x] = to_float(q[b * qs.b + head_of(r) * qs.h + (long long)qi_of(r) * qs.s + d]);
  }
  if (t < kRows) {
    m_s[t] = kNeg;
    l_s[t] = 0.f;
  }

  const T* k_head = k + b * ks.b + kh * ks.h;
  const T* v_head = v + b * vs.b + kh * vs.h;
  const int n_tiles = (k_end - k_begin + C::kKeys - 1) / C::kKeys;
  auto load = [&](int i) {
    const int k0 = k_begin + i * C::kKeys;
    const int nk = min(C::kKeys, k_end - k0);
    T* kt = kv_s + (i & 1) * 2 * C::kTileElems;
    T* vt = kt + C::kTileElems;
    for (int x = t; x < nk * C::kVecs; x += kThreads) {
      const int j = x / C::kVecs, c = x % C::kVecs * C::kVec;
      cp_async16(kt + j * C::kStride + c, k_head + (long long)(k0 + j) * ks.s + c);
      cp_async16(vt + j * C::kStride + c, v_head + (long long)(k0 + j) * vs.s + c);
    }
    cp_async_commit();
  };

  float acc[C::kOut];
#pragma unroll
  for (int u = 0; u < C::kOut; ++u) acc[u] = 0.f;

  load(0);
  for (int i = 0; i < n_tiles; ++i) {
    __syncthreads();  // the previous tile's readers are done with the other stage and p_s
    if (i + 1 < n_tiles) {
      load(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i (and q_s, m_s, l_s) visible to every thread
    const int k0 = k_begin + i * C::kKeys;
    const int nk = min(C::kKeys, k_end - k0);
    const T* kt = kv_s + (i & 1) * 2 * C::kTileElems;
    const T* vt = kt + C::kTileElems;

    // scores: thread t takes key t % kKeys and every kLanes-th row from t / kKeys
    {
      const int j = t % C::kKeys;
      for (int r = t / C::kKeys; r < n_rows; r += C::kLanes) {
        float dot = 0.f;
        if (j < nk) {
          const float* qr = q_s + r * D;
#pragma unroll
          for (int c = 0; c < D; c += C::kVec) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kt + j * C::kStride + c);
            const T* kx = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int e = 0; e < C::kVec; ++e) dot += qr[c + e] * to_float(kx[e]);
          }
        }
        const bool live = j < nk && (!causal || k0 + j <= qi_of(r));
        p_s[r * C::kKeys + j] = live ? dot * scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    // online max and sum: a warp a row
    for (int r = t / 32; r < n_rows; r += kThreads / 32) {
      float x[C::kKeys / 32];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < C::kKeys / 32; ++c) {
        x[c] = p_s[r * C::kKeys + lane + 32 * c];
        mx = fmaxf(mx, x[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < C::kKeys / 32; ++c) {
        const float p = exp2f(x[c] - m_new);  // masked: 2^-inf = 0
        p_s[r * C::kKeys + lane + 32 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread t holds outputs (r, d) = divmod(t + u * kThreads, D)
#pragma unroll
    for (int u = 0; u < C::kOut; ++u) {
      const int x = t + u * kThreads, r = x / D, d = x % D;
      if (r < n_rows) {
        const float* pr = p_s + r * C::kKeys;
        float a = acc[u] * a_s[r];
#pragma unroll 8
        for (int j = 0; j < nk; ++j) a += pr[j] * to_float(vt[j * C::kStride + d]);
        acc[u] = a;
      }
    }
  }

  const int n_split = gridDim.y;
  if (n_split == 1) {
#pragma unroll
    for (int u = 0; u < C::kOut; ++u) {
      const int x = t + u * kThreads, r = x / D, d = x % D;
      if (r < n_rows) {
        const float l = l_s[r];
        store(o + b * os.b + head_of(r) * os.h + (long long)qi_of(r) * os.s + d, acc[u] / (l == 0.f ? 1.f : l));
      }
    }
    return;
  }

  // this split's partial: for each row, acc[D], then m and l
  constexpr int kPart = D + 2;
  float* mine = part + ((long long)blk * n_split + blockIdx.y) * kRows * kPart;
#pragma unroll
  for (int u = 0; u < C::kOut; ++u) {
    const int x = t + u * kThreads, r = x / D, d = x % D;
    if (r < n_rows) mine[r * kPart + d] = acc[u];
  }
  if (t < n_rows) {
    mine[t * kPart + D] = m_s[t];
    mine[t * kPart + D + 1] = l_s[t];
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(counters + blk, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;

  // the last block of (b, kv head, row group) merges every split's partial: each split's
  // weight for each row, 2^(m - max m), in shared memory (over the K/V tiles), then for each
  // output the weighted sums of acc and l, their loads batched
  __threadfence();
  const float* all = part + (long long)blk * n_split * kRows * kPart;
  float* w_s = reinterpret_cast<float*>(kv_s);  // [split][kRows]
  for (int x = t; x < n_split * n_rows; x += kThreads) {
    const int sp = x / n_rows, r = x % n_rows;
    w_s[sp * kRows + r] = __ldcg(all + (sp * kRows + r) * kPart + D);
  }
  __syncthreads();
  if (t < n_rows) {
    float m_all = kNeg;
    for (int sp = 0; sp < n_split; ++sp) m_all = fmaxf(m_all, w_s[sp * kRows + t]);
    m_s[t] = m_all;
  }
  __syncthreads();
  for (int x = t; x < n_split * n_rows; x += kThreads) {
    const int sp = x / n_rows, r = x % n_rows;
    w_s[sp * kRows + r] = exp2f(w_s[sp * kRows + r] - m_s[r]);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < C::kOut; ++u) {
    const int x = t + u * kThreads, r = x / D, d = x % D;
    if (r < n_rows) {
      float l_all = 0.f, a_all = 0.f;
      for (int s0 = 0; s0 < n_split; s0 += kMergeBatch) {
        float ax[kMergeBatch], lx[kMergeBatch];
#pragma unroll
        for (int i = 0; i < kMergeBatch; ++i) {
          const float* ps = all + ((s0 + i) * kRows + r) * kPart;
          ax[i] = s0 + i < n_split ? __ldcg(ps + d) : 0.f;
          lx[i] = s0 + i < n_split ? __ldcg(ps + D + 1) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kMergeBatch; ++i) {
          const float w = s0 + i < n_split ? w_s[(s0 + i) * kRows + r] : 0.f;
          a_all += ax[i] * w;
          l_all += lx[i] * w;
        }
      }
      store(o + b * os.b + head_of(r) * os.h + (long long)qi_of(r) * os.s + d, a_all / (l_all == 0.f ? 1.f : l_all));
    }
  }
  if (t == 0) counters[blk] = 0;  // ready for the next launch
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs, Strides ks, Strides vs,
                   Strides os, int batch, int n_heads, int n_kv_heads, int sq, int kv_live, int causal,
                   float scale_log2, int n_split, int split_keys, void* scratch, void* counters,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  const int group = n_heads / n_kv_heads;
  const int row_groups = (group * sq + kRows - 1) / kRows;
  const int kv_end = causal && sq < kv_live ? sq : kv_live;
  // every split holds at least one live key, and none starts at or past kv_end
  if (n_split < 1 || n_split > kMaxSplits || split_keys < 1 || (long long)(n_split - 1) * split_keys >= kv_end ||
      (long long)n_split * split_keys < kv_end || (n_split > 1 && (scratch == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_kv_heads * row_groups, n_split);
  decode_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs,
      os, n_kv_heads, group, sq, kv_end, causal, scale_log2, row_groups, split_keys, static_cast<float*>(scratch),
      static_cast<int*>(counters));
  return cudaGetLastError();
}

}  // namespace dec

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, Strides qs, Strides ks, Strides vs,
                     Strides os, int batch, int n_heads, int n_kv_heads, int sq, int skv, int kv_len, int causal,
                     float scale_log2, int dtype, int decode, int n_split, int split_keys, void* scratch,
                     void* counters, cudaStream_t stream) {
  const int kv_live = kv_len < skv ? kv_len : skv;
  if (decode) {
    if (dtype == 0)
      return dec::launch<float, D>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, kv_live, causal,
                                   scale_log2, n_split, split_keys, scratch, counters, stream);
    return dec::launch<__nv_bfloat16, D>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, kv_live,
                                         causal, scale_log2, n_split, split_keys, scratch, counters, stream);
  }
  if (dtype == 0)
    return f32::launch<D>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_heads / n_kv_heads, sq, kv_live, causal,
                          scale_log2, stream);
  return tc::launch<D>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_live, causal, scale_log2,
                       stream);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns cudaGetLastError(): a launch
// the runtime rejects never runs, so the caller must check this code. q/o are (B, H, Sq, D)
// and k/v (B, KH, Skv, D), each given by its element strides for the first three dims (the
// last is contiguous); dtype 0 = float32, 1 = bfloat16. decode 1 runs the decode kernel over
// n_split splits of split_keys live keys each, with an f32 scratch of (B * KH * row groups *
// n_split * 32 * (D + 2)) floats and B * KH * row groups int counters, zero before the first
// launch and left at zero (both unused with one split); decode 0 runs the prefill kernel of
// the dtype. The bf16 prefill reads q, k and v through TMA: 16-byte aligned bases and strides.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      long long q_sb, long long q_sh, long long q_ss,
                                      long long k_sb, long long k_sh, long long k_ss,
                                      long long v_sb, long long v_sh, long long v_ss,
                                      long long o_sb, long long o_sh, long long o_ss, int batch,
                                      int n_heads, int n_kv_heads, int sq, int skv, int head_dim,
                                      int kv_len, int causal, float scale, int dtype, int decode,
                                      int n_split, int split_keys, void* scratch, void* counters,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      err = launch_d<16>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len, causal, scale_log2,
                         dtype, decode, n_split, split_keys, scratch, counters, st);
      break;
    case 32:
      err = launch_d<32>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len, causal, scale_log2,
                         dtype, decode, n_split, split_keys, scratch, counters, st);
      break;
    case 64:
      err = launch_d<64>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len, causal, scale_log2,
                         dtype, decode, n_split, split_keys, scratch, counters, st);
      break;
    case 128:
      err = launch_d<128>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len, causal,
                          scale_log2, dtype, decode, n_split, split_keys, scratch, counters, st);
      break;
    case 192:  // MLA's nope + rope (deepseek-v2)
      err = launch_d<192>(q, k, v, o, qs, ks, vs, os, batch, n_heads, n_kv_heads, sq, skv, kv_len, causal,
                          scale_log2, dtype, decode, n_split, split_keys, scratch, counters, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
