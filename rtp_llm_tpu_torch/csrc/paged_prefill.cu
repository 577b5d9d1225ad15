// Paged causal GQA prefill attention for Hopper (sm_90a); KV pool in bf16,
// int8 with per-(slot, kv head) scales, or fp8 e4m3.
//
// Replaces the TPU kernel rtp_llm_tpu/ops/attention/pallas_prefill.py
// _prefill_kernel (paged_prefill_attention). In the port it is *the* prefill
// attention on the GPU, and it takes B rows at once with per-row scalars.
// The JAX package sends prefill over a quantized pool through its plain XLA
// path; here a CUDA tensor never takes the plain version, so this kernel
// reads the quantized pool itself, with the same dequantization as the
// decode kernel's quant mode (pallas_decode.py:225-240: K scale on the
// score, V scale on the probability after the normaliser). A reused prefix
// or an earlier chunk is thus read back quantized. The element type is a
// template parameter; entries paged_prefill_bf16 / _i8 / _e4m3 share one body.
//
// What it computes: for row b, query token t (absolute position
// q_pos = q_offsets[b] + t) and query head h,
//   out[b, t, h] = softmax_p( q[b, t, h] . K[p] * sm_scale ) @ V[p]
// over p <= q_pos, p < kv_lens[b] (and p > q_pos - window with a sliding
// window). kv_lens[b] counts the whole context including this chunk, whose
// KV is already in the pool; q_offsets[b] is the reused-prefix length.
// Padded bucket-tail rows (q_pos >= kv_len) output exact zeros. With an int8
// pool the score is q . K8[p] * ks[p] * sm_scale and the sum runs over
// softmax_p * vs[p] * V8[p], the normaliser over the unscaled probabilities.
//
// What bounds it on the H100: operations. A T-token chunk does ~4 * T * S *
// Hq * D FLOP for ~2 * S * Hkv * D * 2 bytes of KV (S = context length), far
// above the bytes/FLOP ridge for the prompt lengths served.
//
// What the design does about it (plain FMA in f32, simple first):
//  * one block per (16-token query tile, kv head, row) computes all G query
//    heads of that kv head: 16 * G query rows share every K/V tile staged in
//    shared memory, so the pool is read once per query tile and kv head;
//  * K/V tiles (32 keys) are converted to f32 once when staged, not once per
//    query row; four threads own a query row, each holding 32 of its dims of
//    q and of the accumulator in registers, and reduce the dot product with
//    two shuffles;
//  * each thread's dims are 16-byte chunks part, part+4, ... so the four
//    threads of a row read 64 contiguous bytes: conflict-free, broadcast
//    across the rows of a warp;
//  * the causal span bounds the key loop per query tile; key rows past the
//    span are zero-filled, never read from the pool, so masked (zero)
//    probabilities never meet garbage V rows;
//  * f32 online softmax in the exp2 domain;
//  * int8: one K and one V scale per staged key row, read through the block
//    table beside the row (never for a row past the span: its slot may hold
//    NaN), multiplied onto the row's score and onto its probability after
//    that went into l. A 16-byte load carries 16 one-byte elements, so a
//    row is 8 chunks instead of 16.
// Not yet: tensor cores (mma / wgmma), TMA, pipelined loads (later PRs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 128;  // head dim (the wrapper rejects others)
constexpr int QT = 16;  // query tokens per block
constexpr int KT = 32;  // keys per shared-memory tile
constexpr int MAXG = 8; // max query heads per kv head
constexpr float NEG = -1e30f;

__device__ __forceinline__ void unpack4(const uint2 &u, float *f) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
  float2 a = __bfloat1622float2(h[0]), c = __bfloat1622float2(h[1]);
  f[0] = a.x; f[1] = a.y; f[2] = c.x; f[3] = c.y;
}

// the elements of one 16-byte chunk of the pool as floats: 8 bf16, or 16
// one-byte elements (int8, or e4m3 through its f16 conversion)
template <typename T> __device__ __forceinline__ void unpack16(const uint4 &u, float *f);
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4 &u, float *f) {
  unpack4(make_uint2(u.x, u.y), f);
  unpack4(make_uint2(u.z, u.w), f + 4);
}
template <> __device__ __forceinline__ void unpack16<int8_t>(const uint4 &u, float *f) {
  const int8_t *e = reinterpret_cast<const int8_t *>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(e[i]);
}
template <> __device__ __forceinline__ void unpack16<__nv_fp8_e4m3>(const uint4 &u, float *f) {
  // in pairs: one cvt.rn.f16x2.e4m3x2 for two elements
  const __nv_fp8x2_storage_t *e = reinterpret_cast<const __nv_fp8x2_storage_t *>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float2 t = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(e[i], __NV_E4M3)));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename E>
__global__ void __launch_bounds__(4 * QT * MAXG)
paged_prefill_kernel(const __nv_bfloat16 *__restrict__ q,        // [B, T, Hq, D]
                     const E *__restrict__ k_cache,              // rows of k_stride elems
                     const E *__restrict__ v_cache,
                     long long k_stride, long long v_stride,
                     const __nv_bfloat16 *__restrict__ k_scale,  // int8: rows of scale_stride
                     const __nv_bfloat16 *__restrict__ v_scale,  // elems, [.., Hkv]; else null
                     long long scale_stride,
                     const int *__restrict__ block_tables, int bt_stride,
                     const int *__restrict__ q_offsets, const int *__restrict__ kv_lens,
                     __nv_bfloat16 *__restrict__ out,            // [B, T, Hq, D]
                     int T, int Hq, int Hkv, int block_size, int window,
                     float scale_log2) {
  const int qtile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int tok = row / G, g = row % G;
  const int t_idx = qtile * QT + tok;
  const int h = kvh * G + g;
  const int q_off = q_offsets[b], kv_len = kv_lens[b];
  const int q_pos = q_off + t_idx;
  const bool row_in = t_idx < T;

  constexpr bool SCALED = std::is_same<E, int8_t>::value;
  constexpr int EPC = 16 / (int)sizeof(E);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks per row

  __shared__ __align__(16) float k_s[KT][D];
  __shared__ __align__(16) float v_s[KT][D];
  __shared__ float ks_s[KT], vs_s[KT];      // int8: the staged rows' scales

  // my dims: float4 chunks c = part + 4 * i, i.e. dims 4c .. 4c + 3
  float qr[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) { qr[i] = 0.f; acc[i] = 0.f; }
  if (row_in) {
    const __nv_bfloat16 *qp = q + (((size_t)b * T + t_idx) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      unpack4(*reinterpret_cast<const uint2 *>(qp + (part + 4 * i) * 4), &qr[4 * i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) qr[4 * i + k] *= scale_log2;
    }
  }
  float m = NEG, l = 0.f;

  const int tile_first = qtile * QT;
  const int span = min(q_off + min(tile_first + QT, T), kv_len);  // keys [.., span)
  const int lo = window > 0 ? max(0, q_off + tile_first - window + 1) : 0;
  const int *bt = block_tables + (size_t)b * bt_stride;

  for (int kb = (lo / KT) * KT; kb < span; kb += KT) {
    __syncthreads();  // previous tile fully consumed
    for (int c = tid; c < KT * CPR; c += blockDim.x) {
      const int r = c / CPR, col = (c % CPR) * EPC;
      const int pos = kb + r;
      float kf[EPC], vf[EPC];
#pragma unroll
      for (int k = 0; k < EPC; ++k) { kf[k] = 0.f; vf[k] = 0.f; }
      if (pos < span) {
        const long long slot =
            (long long)bt[pos / block_size] * block_size + pos % block_size;
        unpack16<E>(*reinterpret_cast<const uint4 *>(k_cache + slot * k_stride + kvh * D + col), kf);
        unpack16<E>(*reinterpret_cast<const uint4 *>(v_cache + slot * v_stride + kvh * D + col), vf);
      }
#pragma unroll
      for (int k = 0; k < EPC; k += 4) {
        *reinterpret_cast<float4 *>(&k_s[r][col + k]) = make_float4(kf[k], kf[k + 1], kf[k + 2], kf[k + 3]);
        *reinterpret_cast<float4 *>(&v_s[r][col + k]) = make_float4(vf[k], vf[k + 1], vf[k + 2], vf[k + 3]);
      }
    }
    if (SCALED && tid < KT) {
      float ks = 0.f, vs = 0.f;
      const int pos = kb + tid;
      if (pos < span) {
        const long long slot =
            (long long)bt[pos / block_size] * block_size + pos % block_size;
        ks = __bfloat162float(k_scale[slot * scale_stride + kvh]);
        vs = __bfloat162float(v_scale[slot * scale_stride + kvh]);
      }
      ks_s[tid] = ks;
      vs_s[tid] = vs;
    }
    __syncthreads();
    const int n = min(KT, span - kb);
    for (int c0 = 0; c0 < n; c0 += 16) {
      float s[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = c0 + j;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 kk = *reinterpret_cast<const float4 *>(&k_s[r][(part + 4 * i) * 4]);
          dot += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y + qr[4 * i + 2] * kk.z +
                 qr[4 * i + 3] * kk.w;
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (SCALED) dot *= ks_s[r];  // K dequant: one multiply on the score
        const int pos = kb + r;
        const bool ok = r < n && pos <= q_pos && pos < kv_len &&
                        (window <= 0 || pos > q_pos - window);
        s[j] = ok ? dot : NEG;
      }
      float mx = s[0];
#pragma unroll
      for (int j = 1; j < 16; ++j) mx = fmaxf(mx, s[j]);
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p = s[j] > 0.5f * NEG ? exp2f(s[j] - m_new) : 0.f;
        l += p;
        if (SCALED) p *= vs_s[c0 + j];  // V dequant, after the normaliser took p
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 vv = *reinterpret_cast<const float4 *>(&v_s[c0 + j][(part + 4 * i) * 4]);
          acc[4 * i] += p * vv.x;
          acc[4 * i + 1] += p * vv.y;
          acc[4 * i + 2] += p * vv.z;
          acc[4 * i + 3] += p * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (row_in) {
    const bool live = q_pos < kv_len && l > 0.f;
    const float inv = live ? 1.f / l : 0.f;
    __nv_bfloat16 *op = out + (((size_t)b * T + t_idx) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      __nv_bfloat162 lo2 = __floats2bfloat162_rn(acc[4 * i] * inv, acc[4 * i + 1] * inv);
      __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t *>(&lo2);
      u.y = *reinterpret_cast<uint32_t *>(&hi2);
      *reinterpret_cast<uint2 *>(op + (part + 4 * i) * 4) = u;
    }
  }
}

template <typename E>
int launch_prefill(const void *q, const void *k_cache, const void *v_cache, long long k_stride,
                   long long v_stride, const void *k_scale, const void *v_scale,
                   long long scale_stride, const void *block_tables, int bt_stride,
                   const void *q_offsets, const void *kv_lens, void *out, int B, int T, int Hq,
                   int Hkv, int block_size, int window, float sm_scale, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  dim3 grid((T + QT - 1) / QT, Hkv, B);
  paged_prefill_kernel<E><<<grid, 4 * QT * G, 0, st>>>(
      static_cast<const __nv_bfloat16 *>(q), static_cast<const E *>(k_cache),
      static_cast<const E *>(v_cache), k_stride, v_stride,
      static_cast<const __nv_bfloat16 *>(k_scale), static_cast<const __nv_bfloat16 *>(v_scale),
      scale_stride, static_cast<const int *>(block_tables), bt_stride,
      static_cast<const int *>(q_offsets), static_cast<const int *>(kv_lens),
      static_cast<__nv_bfloat16 *>(out), T, Hq, Hkv, block_size, window,
      sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry per pool element type, one signature. k_scale / v_scale are read
// by the int8 entry only; the others ignore them.
#define PREFILL_ENTRY(NAME, E)                                                                 \
  extern "C" int NAME(const void *q, const void *k_cache, const void *v_cache,                 \
                      long long k_stride, long long v_stride, const void *k_scale,             \
                      const void *v_scale, long long scale_stride, const void *block_tables,   \
                      int bt_stride, const void *q_offsets, const void *kv_lens, void *out,    \
                      int B, int T, int Hq, int Hkv, int block_size, int window,              \
                      float sm_scale, void *stream) {                                          \
    return launch_prefill<E>(q, k_cache, v_cache, k_stride, v_stride, k_scale, v_scale,        \
                             scale_stride, block_tables, bt_stride, q_offsets, kv_lens, out,   \
                             B, T, Hq, Hkv, block_size, window, sm_scale, stream);            \
  }

PREFILL_ENTRY(paged_prefill_bf16, __nv_bfloat16)
PREFILL_ENTRY(paged_prefill_i8, int8_t)
PREFILL_ENTRY(paged_prefill_e4m3, __nv_fp8_e4m3)
