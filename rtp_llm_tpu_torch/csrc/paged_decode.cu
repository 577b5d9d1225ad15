// Paged GQA decode attention (T = 1) for Hopper (sm_90a), bf16 KV pool.
//
// Replaces the TPU kernels rtp_llm_tpu/ops/attention/pallas_decode.py
// _fullrow_kernel (contexts <= 2048 bucketed tokens) and _decode_kernel
// (longer contexts): one kernel serves both contracts, for any context up to
// max_seq_len.
//
// What it computes: for every row b and query head h,
//   out[b, h] = softmax_p( q[b, h] . K[p] * sm_scale ) @ V[p]
// over the row's cached positions p in [max(kv_len - window, 0), cached),
// cached = kv_len - 1 when the current token arrives in cur_k / cur_v (it is
// then folded in as one more column at position kv_len - 1), else kv_len.
// K[p] / V[p] live in the paged pool [NS, Hkv*D] at slot
// block_table[b, p / block_size] * block_size + p % block_size, read at kv
// head h / G (G = Hq / Hkv). Rows with kv_len == 0 give zeros.
//
// What bounds it on the H100: bytes. Every K and V row of the live context
// is read once per kv head (2 * Hkv * D * 2 B per token and layer); the
// arithmetic is ~2 FLOP per byte, far below the card's ~295 FLOP/B ridge.
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
//  * scores and the online softmax are f32, in the exp2 domain.
// Not yet: wgmma / TMA / cp.async pipelining, CUDA graphs (later PRs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head dim (the wrapper rejects others)
constexpr int TILE = 64;      // context tokens per shared-memory tile
constexpr int THREADS = 128;  // one thread per output dim in the PV phase
constexpr int MAXG = 8;       // max query heads per kv head
constexpr int KPITCH = D + 8; // K tile row pitch (bf16): 272 B keeps 16 B row reads conflict-free
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

__device__ __forceinline__ void unpack8(const uint4 &u, float *f) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16 *__restrict__ q,        // [B, Hq, D]
                    const __nv_bfloat16 *__restrict__ k_cache,  // rows of k_stride elems
                    const __nv_bfloat16 *__restrict__ v_cache,
                    long long k_stride, long long v_stride,
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

  __shared__ __align__(16) float q_s[MAXG][D];
  __shared__ __align__(16) __nv_bfloat16 k_s[TILE][KPITCH];
  __shared__ __align__(16) __nv_bfloat16 v_s[TILE][D];
  __shared__ float p_s[MAXG][TILE];
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
    uint4 kr[TILE * 16 / THREADS], vr[TILE * 16 / THREADS];
#pragma unroll
    for (int it = 0; it < TILE * 16 / THREADS; ++it) {
      const int c = tid + it * THREADS;
      const int r = c >> 4, col = (c & 15) * 8;
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
#pragma unroll
    for (int it = 0; it < TILE * 16 / THREADS; ++it) {
      const int c = tid + it * THREADS;
      const int r = c >> 4, col = (c & 15) * 8;
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
        for (int i = 0; i < D / 8; ++i) {
          float kf[8];
          unpack8(*reinterpret_cast<const uint4 *>(&k_s[r][i * 8]), kf);
#pragma unroll
          for (int j = 0; j < MAXG / 2; ++j) {
            const int g = gh + 2 * j;
            if (g < G) {
              const float4 qa = *reinterpret_cast<const float4 *>(&q_s[g][i * 8]);
              const float4 qb = *reinterpret_cast<const float4 *>(&q_s[g][i * 8 + 4]);
              s[j] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                      qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
            }
          }
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
      p_s[g][lane] = p0;
      p_s[g][lane + 32] = p1;
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
      const float vv = __bfloat162float(v_s[r][tid]);
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

}  // namespace

extern "C" int paged_decode_bf16(const void *q, const void *k_cache, const void *v_cache,
                                 long long k_stride, long long v_stride,
                                 const void *block_tables, int bt_stride,
                                 const void *kv_lens, const void *cur_k, const void *cur_v,
                                 long long cur_stride, void *out, void *ws_o, void *ws_ml,
                                 int B, int Hq, int Hkv, int block_size, int window,
                                 float sm_scale, int num_splits, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  dim3 grid(num_splits, Hkv, B);
  paged_decode_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16 *>(q), static_cast<const __nv_bfloat16 *>(k_cache),
      static_cast<const __nv_bfloat16 *>(v_cache), k_stride, v_stride,
      static_cast<const int *>(block_tables), bt_stride, static_cast<const int *>(kv_lens),
      static_cast<const __nv_bfloat16 *>(cur_k), static_cast<const __nv_bfloat16 *>(cur_v),
      cur_stride, static_cast<__nv_bfloat16 *>(out), static_cast<float *>(ws_o),
      static_cast<float *>(ws_ml), Hq, Hkv, block_size, window, scale_log2, num_splits);
  if (num_splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    paged_decode_combine<<<dim3(Hq, B), D, 0, st>>>(
        static_cast<const float *>(ws_o), static_cast<const float *>(ws_ml),
        static_cast<const int *>(kv_lens), static_cast<__nv_bfloat16 *>(out), Hq, num_splits);
  }
  return static_cast<int>(cudaGetLastError());
}
