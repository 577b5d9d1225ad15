// w8_gemm: y[M,N] bf16 = x[M,K] bf16 @ dequant(W[K,N]) for 8-bit weight
// codes, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package these products are XLA
// matmuls whose int8 / e4m3 -> bf16 convert is fused into the matmul operand
// (quantized_matmul's per-tensor, per-channel and groupwise branches,
// rtp_llm_tpu/quant/weight_only.py:383-409), so a step reads 1 byte per
// weight. PyTorch has no such fused form: `x @ w.to(bf16)` reads 1 B, writes
// 2 B and reads 2 B per weight. This kernel reads the codes once and
// converts them in registers.
//
// Codes (CODE): 0 s8, 1 e4m3 (fp8, bias 7). Both convert to bf16 exactly.
// Scales (MODE): 0 one f32 (per tensor), 1 f32 [N] (per out channel), both
// applied to the f32 sum in the epilogue; 2 f32 [K/group, N] (fp8 per-block,
// GPTQ int8 groupwise), applied to each group's f32 partial sum (GROUPED).
//
// What bounds it: at decode (M <= 64) the weight bytes, 1 B an element (the
// Qwen2-7B gate-up projection, [3584, 37888], is 135.8 MB: 0.041 ms at
// 3.35 TB/s); at prefill (M = 2048) the products (0.56 ms at 989 TFLOP/s).
// The design is the simple one: a 4-stage cp.async ring of k-tiles, mma.sync
// bf16 products, K split over blocks when the output tiles alone do not fill
// the SMs. Making it fast (TMA, wgmma, a persistent schedule) is later work.
//
// The tile: a block of 4 warps owns BM = 16 * MT rows and BN = 128 columns;
// each warp a 32-column slab. A k-tile is 32 rows of W ([32][128] bytes,
// pitch 144: the rows 2*tig of a warp fall on distinct banks) and the
// block's x slab ([BM][32] bf16, pitch 80 B: ldmatrix conflict-free). The
// B fragment of mma.m16n8k16 wants, per thread, two consecutive k rows of
// one column. A 32-bit word of row r holds four columns: thread (g, tig)
// reads the words at column 4*g of its slab from rows 2*tig, 2*tig+1,
// 2*tig+8, 2*tig+9 and deals byte j of each word to n8 tile j (the trick of
// gw_common.cuh). Column n of tile j is slab column 4*n + j, so a thread's
// accumulators (tile j, columns 2*tig, 2*tig+1) are the 8 consecutive slab
// columns 8*tig .. 8*tig+7: one 16-byte store per row.
//
// Planted faults for chip_smoke.py (-DW8_FAULT=n): 1 the per-channel scale
// of the neighbouring column, 2 a group's partial scaled by the next group's
// scale row, 3 e4m3 decoded with its exponent off by one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gw_common.cuh"

#ifndef W8_FAULT
#define W8_FAULT 0
#endif

namespace w8 {

constexpr int BN = 128, BK = 32, STAGES = 4, THREADS = 128;
constexpr int WP = BN + 16;  // W row pitch, bytes
constexpr int XP = BK + 8;   // x row pitch, bf16

struct Args {
  const __nv_bfloat16 *x;  // [M, K], row stride lda elements
  long long lda;
  const uint8_t *w;    // [K, N] codes
  const float *s;      // [1], [N] or [K/group, N]
  __nv_bfloat16 *out;  // [M, N]
  float *ws;           // [splits, M, N] f32 partials when splits > 1, else null
  int M, K, N, mode, group;
  int tiles_per_split;  // k-tiles of one K split (whole groups in mode 2)
};

// e4m3 byte -> f32, exactly: s(1) e(4) m(3), bias 7, e == 0 subnormal
__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t e = (b >> 3) & 15u, m = b & 7u;
#if W8_FAULT == 3
  const uint32_t bias = 121u;  // 127 - 7 + 1: the exponent off by one
#else
  const uint32_t bias = 120u;  // 127 - 7
#endif
  const float mag = e ? __uint_as_float(((e + bias) << 23) | (m << 20))
                      : static_cast<float>(m) * 0.001953125f;  // m * 2^-9
  return (b & 0x80u) ? -mag : mag;
}

template <int CODE>
__device__ __forceinline__ float code_of(uint32_t word, int j) {
  const uint32_t b = (word >> (8 * j)) & 0xFFu;
  if constexpr (CODE == 0)
    return static_cast<float>(static_cast<int8_t>(b));
  else
    return e4m3_to_f32(b);
}

template <int MT>
struct Smem {
  static constexpr int W_BYTES = BK * WP;
  static constexpr int X_BYTES = 16 * MT * XP * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES;
};

template <int MT>
__device__ __forceinline__ void load_tile(const Args &a, unsigned char *stage, int kt, int m0,
                                          int n0) {
  const int tid = threadIdx.x, k0 = kt * BK;
  const uint32_t sw = static_cast<uint32_t>(__cvta_generic_to_shared(stage));
  for (int c = tid; c < BK * (BN / 16); c += THREADS) {
    const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
    const bool ok = n0 + col < a.N;
    gw::cp16(sw + r * WP + col, a.w + (ok ? (size_t)(k0 + r) * a.N + n0 + col : 0), ok);
  }
  const uint32_t sx = sw + Smem<MT>::W_BYTES;
  for (int c = tid; c < 16 * MT * (BK / 8); c += THREADS) {
    const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
    const bool ok = m0 + r < a.M;
    gw::cp16(sx + (r * XP + col) * 2, a.x + (ok ? (size_t)(m0 + r) * a.lda + k0 + col : 0), ok);
  }
}

// Scale each group partial by its scale row and add it to the sum.
__device__ __forceinline__ void flush_group(float (&acc)[4], float (&part)[4], const float *srow,
                                            int c_lo, int c_hi, int N) {
  const float s_lo = c_lo < N ? srow[c_lo] : 0.f, s_hi = c_hi < N ? srow[c_hi] : 0.f;
  acc[0] += part[0] * s_lo;
  acc[1] += part[1] * s_hi;
  acc[2] += part[2] * s_lo;
  acc[3] += part[3] * s_hi;
  part[0] = part[1] = part[2] = part[3] = 0.f;
}

template <int MT, int CODE, bool GROUPED>
__global__ void __launch_bounds__(THREADS) w8_gemm_kernel(const Args a) {
  __shared__ __align__(128) unsigned char smem[STAGES * Smem<MT>::STAGE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 16 * MT, split = blockIdx.z;
  const int ktiles = a.K / BK;
  const int t0 = split * a.tiles_per_split, t1 = min(t0 + a.tiles_per_split, ktiles);
  const int slab = warp * 32;

  float acc[MT][4][4] = {};
  float part[GROUPED ? MT : 1][4][4] = {};

  for (int s = 0; s < STAGES - 1; ++s) {
    if (t0 + s < t1) load_tile<MT>(a, smem + s * Smem<MT>::STAGE, t0 + s, m0, n0);
    gw::cp_async_commit();
  }
  for (int kt = t0; kt < t1; ++kt) {
    gw::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < t1) load_tile<MT>(a, smem + ((nk - t0) % STAGES) * Smem<MT>::STAGE, nk, m0, n0);
    gw::cp_async_commit();

    const unsigned char *stage = smem + ((kt - t0) % STAGES) * Smem<MT>::STAGE;
    const uint32_t sx =
        static_cast<uint32_t>(__cvta_generic_to_shared(stage)) + Smem<MT>::W_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        gw::ldsm4(af[mt], sx + ((mt * 16 + (lane & 15)) * XP + kk + (lane >> 4) * 8) * 2);
      const unsigned char *wr = stage + (kk + 2 * tig) * WP + slab + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t *>(wr);
      const uint32_t w1 = *reinterpret_cast<const uint32_t *>(wr + WP);
      const uint32_t w2 = *reinterpret_cast<const uint32_t *>(wr + 8 * WP);
      const uint32_t w3 = *reinterpret_cast<const uint32_t *>(wr + 9 * WP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b[2] = {gw::pack_bf16(code_of<CODE>(w0, j), code_of<CODE>(w1, j)),
                               gw::pack_bf16(code_of<CODE>(w2, j), code_of<CODE>(w3, j))};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (GROUPED)
            gw::mma_bf16(part[mt][j], af[mt], b);
          else
            gw::mma_bf16(acc[mt][j], af[mt], b);
        }
      }
    }
    if constexpr (GROUPED) {
      if (((kt + 1) * BK) % a.group == 0) {
        int grp = (kt * BK) / a.group;
#if W8_FAULT == 2
        grp = (grp + 1) % (a.K / a.group);  // the next group's scale row
#endif
        const float *srow = a.s + (size_t)grp * a.N;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = n0 + slab + 8 * tig + j;
            flush_group(acc[mt][j], part[mt][j], srow, c, c + 4, a.N);
          }
      }
    }
  }
  gw::cp_async_wait<0>();

  // epilogue: 8 consecutive columns a row, scaled (modes 0 and 1) unless the
  // K split's partial goes to the workspace
  const int c8 = n0 + slab + 8 * tig;
  if (c8 >= a.N) return;
  float cs[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    int c = c8 + q;
#if W8_FAULT == 1
    c ^= 1;  // the neighbouring column's scale
#endif
    cs[q] = a.ws || a.mode == 2 ? 1.f : a.mode == 0 ? a.s[0] : a.s[c];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mt * 16 + g + 8 * h;
      if (r >= a.M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * h] * cs[j];
        v[4 + j] = acc[mt][j][2 * h + 1] * cs[4 + j];
      }
      if (a.ws) {
        float4 *dst = reinterpret_cast<float4 *>(a.ws + ((size_t)split * a.M + r) * a.N + c8);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        uint4 o;
        o.x = gw::pack_bf16(v[0], v[1]);
        o.y = gw::pack_bf16(v[2], v[3]);
        o.z = gw::pack_bf16(v[4], v[5]);
        o.w = gw::pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4 *>(a.out + (size_t)r * a.N + c8) = o;
      }
    }
}

// Sum the K splits' partials, scale (modes 0 and 1), round to bf16; four
// columns a thread.
__global__ void w8_reduce_kernel(const Args a, int splits) {
  const size_t quads = (size_t)a.M * a.N / 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < quads;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 t = reinterpret_cast<const float4 *>(a.ws)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 u = reinterpret_cast<const float4 *>(a.ws + (size_t)s * a.M * a.N)[i];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    const int c = static_cast<int>((i * 4) % a.N);
    float cs[4] = {1.f, 1.f, 1.f, 1.f};
    for (int q = 0; q < 4; ++q) {
      int cq = c + q;
#if W8_FAULT == 1
      cq ^= 1;
#endif
      if (a.mode == 0) cs[q] = a.s[0];
      if (a.mode == 1) cs[q] = a.s[cq];
    }
    uint2 o;
    o.x = gw::pack_bf16(t.x * cs[0], t.y * cs[1]);
    o.y = gw::pack_bf16(t.z * cs[2], t.w * cs[3]);
    reinterpret_cast<uint2 *>(a.out)[i] = o;
  }
}

template <int MT, int CODE, bool GROUPED>
void launch(const Args &a, int splits, cudaStream_t st) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + 16 * MT - 1) / (16 * MT), splits);
  w8_gemm_kernel<MT, CODE, GROUPED><<<grid, THREADS, 0, st>>>(a);
}

template <int MT>
bool dispatch_code(int code, const Args &a, int splits, cudaStream_t st) {
  const bool grouped = a.mode == 2;
  if (code == 0 && !grouped) launch<MT, 0, false>(a, splits, st);
  else if (code == 0) launch<MT, 0, true>(a, splits, st);
  else if (code == 1 && !grouped) launch<MT, 1, false>(a, splits, st);
  else if (code == 1) launch<MT, 1, true>(a, splits, st);
  else return false;
  return true;
}

}  // namespace w8

// y = x @ dequant(w). x [M, K] bf16 (row stride lda), w [K, N] s8 (code 0)
// or e4m3 (code 1), scale by mode (0 per tensor, 1 per channel, 2 groupwise
// [K/group, N]); ws [splits, M, N] f32 when splits > 1. bm in {16, 32, 64}.
// Returns cudaGetLastError() after the launches.
extern "C" int w8_gemm(const void *x, long long lda, const void *w, int code, const void *scale,
                       int mode, int group, void *out, void *ws, int M, int K, int N, int splits,
                       int tiles_per_split, int bm, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  w8::Args a{static_cast<const __nv_bfloat16 *>(x), lda, static_cast<const uint8_t *>(w),
             static_cast<const float *>(scale), static_cast<__nv_bfloat16 *>(out),
             splits > 1 ? static_cast<float *>(ws) : nullptr, M, K, N, mode, group,
             tiles_per_split};
  bool ok = bm == 16   ? w8::dispatch_code<1>(code, a, splits, st)
            : bm == 32 ? w8::dispatch_code<2>(code, a, splits, st)
            : bm == 64 ? w8::dispatch_code<4>(code, a, splits, st)
                       : false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) w8::w8_reduce_kernel<<<264, 256, 0, st>>>(a, splits);
  return static_cast<int>(cudaGetLastError());
}
