// Paged GQA decode attention (T = 1) for Hopper (sm_90a); KV pool in bf16,
// int8 with per-(slot, kv head) scales, or fp8 e4m3.
//
// Replaces the TPU kernels rtp_llm_tpu/ops/attention/pallas_decode.py
// _fullrow_kernel (contexts <= 2048 bucketed tokens) and _decode_kernel
// (longer contexts): one kernel serves both contracts, for any context up to
// max_seq_len. It also replaces _fullrow_kernel's quant mode
// (pallas_decode.py:225-240: an int8 pool whose dequantization is two
// multiplies, the K scale on the scores and the V scale on the
// probabilities) and its fp8 pool (:326-335, storage only, upcast on read).
// The element type is a template parameter; the three entries
// paged_decode_bf16 / _i8 / _e4m3 share one body.
//
// What it computes: for every row b and query head h,
//   out[b, h] = softmax_p( q[b, h] . K[p] * sm_scale ) @ V[p]
// over the row's cached positions p in [max(kv_len - window, 0), cached),
// cached = kv_len - 1 when the current token arrives in cur_k / cur_v (it is
// then folded in as one more column at position kv_len - 1), else kv_len.
// K[p] / V[p] live in the paged pool [NS, Hkv*D] at slot
// block_table[b, p / block_size] * block_size + p % block_size, read at kv
// head h / G (G = Hq / Hkv). Rows with kv_len == 0 give zeros.
// With an int8 pool, ks[p] / vs[p] being the bf16 scales of that slot and kv
// head,
//   out[b, h] = sum_p softmax_p( q . K8[p] * ks[p] * sm_scale ) * vs[p] * V8[p]
// where the softmax normaliser sums the unscaled probabilities. The deferred
// current token always arrives in bf16, unquantized.
//
// What bounds it on the H100: bytes. Every K and V row of the live context
// is read once per kv head (2 * Hkv * D * 2 B per token and layer); the
// arithmetic is ~2 FLOP per byte, far below the card's ~295 FLOP/B ridge.
// A 1-byte pool halves those bytes (plus 2 * Hkv * 2 B of scales a token for
// int8) and doubles the operations per byte, still far below the ridge.
//
// What the design does about it:
//  * one thread block per (row, kv head, context split) handles all G query
//    heads of that kv head, so each K/V row is read from device memory once
//    (no per-query-head re-reads, no zero-expanded query as on the TPU);
//  * 64-token tiles are staged in shared memory with 16-byte loads, each
//    thread issuing all of its tile loads before any use (memory-level
//    parallelism), neighbouring threads on neighbouring addresses;
//  * the block reads its own block-table entries; only tiles inside the
//    live (and windowed) range are loaded, and rows of a tile outside that
//    range are zero-filled in shared memory, so a zero probability is never
//    multiplied by an unread or stale V row (the pool may hold garbage);
//  * the context is split across blocks when rows * kv heads alone would not
//    fill the 132 SMs; a second small kernel merges the splits' f32 online-
//    softmax partials (m, l, acc);
//  * scores and the online softmax are f32, in the exp2 domain;
//  * int8: the scales are [NS, Hkv] views of the pool's scale tensor, read
//    through the block table like the data: a block owns one kv head, so it
//    loads one K and one V scale per live tile row (two scalar loads; rows
//    outside the live range are never read, their slots may hold NaN). The
//    score of row r is multiplied by ks[r]; the probability is multiplied by
//    vs[r] after the tile's sum went into l, so l sums p and acc sums
//    p * vs * v across tiles and splits. No gathered [B, S, Hkv] scale
//    operand and no one-hot head expansion as on the TPU;
//  * a 16-byte load carries 16 one-byte elements: the staging loop, the K
//    tile's row pitch (16 B of padding, whatever the element) and the
//    unpacking follow the element size.
// Not yet: wgmma / TMA / cp.async pipelining, CUDA graphs (later PRs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 128;        // head dim (the wrapper rejects others)
constexpr int TILE = 64;      // context tokens per shared-memory tile
constexpr int THREADS = 128;  // one thread per output dim in the PV phase
constexpr int MAXG = 8;       // max query heads per kv head
constexpr int PAD_BYTES = 16; // K tile row padding: keeps 16 B row reads conflict-free
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// How a pool element is stored and upcast. S is what shared memory holds.
template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static __device__ __forceinline__ float f(S v) { return __bfloat162float(v); }
};
template <> struct Elem<int8_t> {
  using S = int8_t;
  static __device__ __forceinline__ float f(S v) { return static_cast<float>(v); }
};
template <> struct Elem<__nv_fp8_e4m3> {
  using S = __nv_fp8_storage_t;
  static __device__ __forceinline__ float f(S v) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, __NV_E4M3)));
  }
};

// the elements of one 16-byte chunk as floats: 8 (bf16) or 16 (one byte each)
template <typename T> __device__ __forceinline__ void unpack16(const uint4 &u, float *f) {
  using S = typename Elem<T>::S;
  const S *e = reinterpret_cast<const S *>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(S); ++i) f[i] = Elem<T>::f(e[i]);
}
// e4m3 converts in pairs (one cvt.rn.f16x2.e4m3x2 for two elements)
template <> __device__ __forceinline__ void unpack16<__nv_fp8_e4m3>(const uint4 &u, float *f) {
  const __nv_fp8x2_storage_t *e = reinterpret_cast<const __nv_fp8x2_storage_t *>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float2 t = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(e[i], __NV_E4M3)));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4 &u, float *f) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16 *__restrict__ q,        // [B, Hq, D]
                    const T *__restrict__ k_cache,              // rows of k_stride elems
                    const T *__restrict__ v_cache,
                    long long k_stride, long long v_stride,
                    const __nv_bfloat16 *__restrict__ k_scale,  // int8: rows of scale_stride
                    const __nv_bfloat16 *__restrict__ v_scale,  // elems, [.., Hkv]; else null
                    long long scale_stride,
                    const int *__restrict__ block_tables, int bt_stride,
                    const int *__restrict__ kv_lens,
                    const __nv_bfloat16 *__restrict__ cur_k,    // [B, cur_stride] or null
                    const __nv_bfloat16 *__restrict__ cur_v,
                    long long cur_stride,
                    __nv_bfloat16 *__restrict__ out,            // [B, Hq, D]
                    float *__restrict__ ws_o,                   // [B, Hq, S, D] (S > 1)
                    float *__restrict__ ws_ml,                  // [B, Hq, S, 2]
                    int Hq, int Hkv, int block_size, int window,
                    float scale_log2, int num_splits) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = Hq / Hkv;
  const int h0 = kvh * G;
  using S = typename Elem<T>::S;
  constexpr bool SCALED = std::is_same<T, int8_t>::value;
  constexpr int EPC = 16 / (int)sizeof(S);        // elements per 16-byte chunk
  constexpr int CPR = D / EPC;                    // chunks per row
  constexpr int LOADS = TILE * CPR / THREADS;     // chunks per thread and tile
  constexpr int KPITCH = D + PAD_BYTES / (int)sizeof(S);

  __shared__ __align__(16) float q_s[MAXG][D];
  __shared__ __align__(16) S k_s[TILE][KPITCH];
  __shared__ __align__(16) S v_s[TILE][D];
  __shared__ float p_s[MAXG][TILE];
  __shared__ float ks_s[TILE], vs_s[TILE];        // int8: the tile rows' scales
  __shared__ float m_s[MAXG], l_s[MAXG], a_s[MAXG];

  const int kv_len = kv_lens[b];
  const bool has_cur = cur_k != nullptr;
  const int cached = has_cur ? max(kv_len - 1, 0) : kv_len;
  const int lo = window > 0 ? max(kv_len - window, 0) : 0;
  const int tile_lo = lo / TILE;
  const int tile_hi = cached > lo ? (cached + TILE - 1) / TILE : tile_lo;
  const int per = (tile_hi - tile_lo + num_splits - 1) / num_splits;
  const int t0 = tile_lo + split * per;
  const int t1 = min(t0 + per, tile_hi);

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    q_s[g][d] = __bfloat162float(q[((size_t)b * Hq + h0 + g) * D + d]) * scale_log2;
  }
  if (tid < MAXG) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  __syncthreads();

  const int *bt = block_tables + (size_t)b * bt_stride;
  for (int tile = t0; tile < t1; ++tile) {
    const int base = tile * TILE;
    const int v0 = max(lo, base) - base;          // first live row of the tile
    const int v1 = min(cached, base + TILE) - base;  // one past the last

    // ---- stage K and V rows [v0, v1) in shared memory; zero the rest ----
    uint4 kr[LOADS], vr[LOADS];
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int c = tid + it * THREADS;
      const int r = c / CPR, col = (c % CPR) * EPC;
      kr[it] = make_uint4(0, 0, 0, 0);
      vr[it] = make_uint4(0, 0, 0, 0);
      if (r >= v0 && r < v1) {
        const int pos = base + r;
        const long long slot =
            (long long)bt[pos / block_size] * block_size + pos % block_size;
        kr[it] = *reinterpret_cast<const uint4 *>(k_cache + slot * k_stride + kvh * D + col);
        vr[it] = *reinterpret_cast<const uint4 *>(v_cache + slot * v_stride + kvh * D + col);
      }
    }
    if (SCALED && tid < TILE) {
      // one K and one V scale per live row; a dead row's slot is never read
      float ks = 0.f, vs = 0.f;
      if (tid >= v0 && tid < v1) {
        const int pos = base + tid;
        const long long slot =
            (long long)bt[pos / block_size] * block_size + pos % block_size;
        ks = __bfloat162float(k_scale[slot * scale_stride + kvh]);
        vs = __bfloat162float(v_scale[slot * scale_stride + kvh]);
      }
      ks_s[tid] = ks;
      vs_s[tid] = vs;
    }
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int c = tid + it * THREADS;
      const int r = c / CPR, col = (c % CPR) * EPC;
      *reinterpret_cast<uint4 *>(&k_s[r][col]) = kr[it];
      *reinterpret_cast<uint4 *>(&v_s[r][col]) = vr[it];
    }
    __syncthreads();

    // ---- scores: thread -> row r, query heads gh, gh + 2, gh + 4, gh + 6 ----
    {
      const int r = tid & (TILE - 1);
      const int gh = tid / TILE;
      const bool live = r >= v0 && r < v1;
      float s[MAXG / 2];
#pragma unroll
      for (int j = 0; j < MAXG / 2; ++j) s[j] = 0.f;
      if (live) {
#pragma unroll
        for (int i = 0; i < CPR; ++i) {
          float kf[EPC];
          unpack16<T>(*reinterpret_cast<const uint4 *>(&k_s[r][i * EPC]), kf);
#pragma unroll
          for (int j = 0; j < MAXG / 2; ++j) {
            const int g = gh + 2 * j;
            if (g < G) {
#pragma unroll
              for (int c = 0; c < EPC; c += 8) {
                const float4 qa = *reinterpret_cast<const float4 *>(&q_s[g][i * EPC + c]);
                const float4 qb = *reinterpret_cast<const float4 *>(&q_s[g][i * EPC + c + 4]);
                s[j] += qa.x * kf[c] + qa.y * kf[c + 1] + qa.z * kf[c + 2] + qa.w * kf[c + 3] +
                        qb.x * kf[c + 4] + qb.y * kf[c + 5] + qb.z * kf[c + 6] + qb.w * kf[c + 7];
              }
            }
          }
        }
        if (SCALED) {  // K dequant: one multiply on the score
          const float ks = ks_s[r];
#pragma unroll
          for (int j = 0; j < MAXG / 2; ++j) s[j] *= ks;
        }
      }
#pragma unroll
      for (int j = 0; j < MAXG / 2; ++j) {
        const int g = gh + 2 * j;
        if (g < G) p_s[g][r] = live ? s[j] : NEG;
      }
    }
    __syncthreads();

    // ---- online softmax over the tile: one warp per query head ----
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = p_s[g][lane], s1 = p_s[g][lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = s0 > 0.5f * NEG ? exp2f(s0 - m_new) : 0.f;
      const float p1 = s1 > 0.5f * NEG ? exp2f(s1 - m_new) : 0.f;
      // V dequant: the scale goes on the probability the PV phase reads,
      // after the unscaled p went into the normaliser
      p_s[g][lane] = SCALED ? p0 * vs_s[lane] : p0;
      p_s[g][lane + 32] = SCALED ? p1 * vs_s[lane + 32] : p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- P @ V: thread -> output dim tid, all G heads ----
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] *= a_s[g];
    for (int r = v0; r < v1; ++r) {
      const float vv = Elem<T>::f(v_s[r][tid]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] += p_s[g][r] * vv;
    }
    __syncthreads();
  }

  // ---- deferred current token: one more column at position kv_len - 1 ----
  if (has_cur && split == num_splits - 1 && kv_len > 0) {
    const __nv_bfloat16 *ck = cur_k + (size_t)b * cur_stride + kvh * D;
    for (int g = warp; g < G; g += THREADS / 32) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += q_s[g][d] * __bfloat162float(ck[d]);
      const float sc = warp_sum(part);
      if (lane == 0) {
        const float m_new = fmaxf(m_s[g], sc);
        const float alpha = exp2f(m_s[g] - m_new);
        const float pc = exp2f(sc - m_new);
        l_s[g] = l_s[g] * alpha + pc;
        m_s[g] = m_new;
        a_s[g] = alpha;
        p_s[g][0] = pc;
      }
    }
    __syncthreads();
    const float cv = __bfloat162float(cur_v[(size_t)b * cur_stride + kvh * D + tid]);
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] = acc[g] * a_s[g] + p_s[g][0] * cv;
  }

  if (num_splits == 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float l = l_s[g];
        const float o = (kv_len > 0 && l > 0.f) ? acc[g] / l : 0.f;
        out[((size_t)b * Hq + h0 + g) * D + tid] = __float2bfloat16(o);
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const size_t hs = ((size_t)b * Hq + h0 + g) * num_splits + split;
        ws_o[hs * D + tid] = acc[g];
        if (tid == 0) {
          ws_ml[hs * 2] = m_s[g];
          ws_ml[hs * 2 + 1] = l_s[g];
        }
      }
    }
  }
}

// Merge the context splits' partial online-softmax states.
__global__ void __launch_bounds__(D)
paged_decode_combine(const float *__restrict__ ws_o, const float *__restrict__ ws_ml,
                     const int *__restrict__ kv_lens, __nv_bfloat16 *__restrict__ out,
                     int Hq, int num_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t base = ((size_t)b * Hq + h) * num_splits;
  float M = NEG;
  for (int s = 0; s < num_splits; ++s) M = fmaxf(M, ws_ml[(base + s) * 2]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const float w = exp2f(ws_ml[(base + s) * 2] - M);
    L += ws_ml[(base + s) * 2 + 1] * w;
    o += ws_o[(base + s) * D + d] * w;
  }
  const float r = (kv_lens[b] > 0 && L > 0.f) ? o / L : 0.f;
  out[((size_t)b * Hq + h) * D + d] = __float2bfloat16(r);
}

template <typename T>
int launch_decode(const void *q, const void *k_cache, const void *v_cache, long long k_stride,
                  long long v_stride, const void *k_scale, const void *v_scale,
                  long long scale_stride, const void *block_tables, int bt_stride,
                  const void *kv_lens, const void *cur_k, const void *cur_v,
                  long long cur_stride, void *out, void *ws_o, void *ws_ml, int B, int Hq,
                  int Hkv, int block_size, int window, float sm_scale, int num_splits,
                  void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  dim3 grid(num_splits, Hkv, B);
  paged_decode_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16 *>(q), static_cast<const T *>(k_cache),
      static_cast<const T *>(v_cache), k_stride, v_stride,
      static_cast<const __nv_bfloat16 *>(k_scale), static_cast<const __nv_bfloat16 *>(v_scale),
      scale_stride, static_cast<const int *>(block_tables), bt_stride,
      static_cast<const int *>(kv_lens), static_cast<const __nv_bfloat16 *>(cur_k),
      static_cast<const __nv_bfloat16 *>(cur_v), cur_stride, static_cast<__nv_bfloat16 *>(out),
      static_cast<float *>(ws_o), static_cast<float *>(ws_ml), Hq, Hkv, block_size, window,
      scale_log2, num_splits);
  if (num_splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    paged_decode_combine<<<dim3(Hq, B), D, 0, st>>>(
        static_cast<const float *>(ws_o), static_cast<const float *>(ws_ml),
        static_cast<const int *>(kv_lens), static_cast<__nv_bfloat16 *>(out), Hq, num_splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry per pool element type, one signature. k_scale / v_scale are read
// by the int8 entry only; the others ignore them.
#define DECODE_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const void *q, const void *k_cache, const void *v_cache,                 \
                      long long k_stride, long long v_stride, const void *k_scale,             \
                      const void *v_scale, long long scale_stride, const void *block_tables,   \
                      int bt_stride, const void *kv_lens, const void *cur_k, const void *cur_v, \
                      long long cur_stride, void *out, void *ws_o, void *ws_ml, int B, int Hq,  \
                      int Hkv, int block_size, int window, float sm_scale, int num_splits,      \
                      void *stream) {                                                           \
    return launch_decode<T>(q, k_cache, v_cache, k_stride, v_stride, k_scale, v_scale,          \
                            scale_stride, block_tables, bt_stride, kv_lens, cur_k, cur_v,       \
                            cur_stride, out, ws_o, ws_ml, B, Hq, Hkv, block_size, window,       \
                            sm_scale, num_splits, stream);                                      \
  }

DECODE_ENTRY(paged_decode_bf16, __nv_bfloat16)
DECODE_ENTRY(paged_decode_i8, int8_t)
DECODE_ENTRY(paged_decode_e4m3, __nv_fp8_e4m3)
