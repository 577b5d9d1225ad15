// i8_gemm: y[M,N] bf16 = (sum over groups g of int32(xq_g . W_g) * scale[g, n])
// * xs[m], the integer contraction of W8A8 and W4A8, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package w8a8_matmul and w4a8_matmul
// (rtp_llm_tpu/quant/weight_only.py:166-207) are XLA einsums over s8 x s8
// operands with int32 accumulation. Here xq [M, K] s8 are the per-token
// activation codes (act_quant.cu) with their f32 scales xs [M]; W [K, N] s8
// holds int8 codes (W8A8, scale [1, N]: one group spanning K) or int4 values
// in [-7, 7] (W4A8, scale [K/group, N]).
//
// What bounds it: the products at prefill (a Qwen2-7B gate-up projection at
// M = 2048 is 556 GOP: 0.28 ms at 1979 TOP/s int8 dense), the weight bytes
// at the few rows W4A8 decodes with. The design is the simple one, as in
// w8_gemm.cu: a 4-stage cp.async ring of 32-row k-tiles, 4 warps of 32
// columns, mma.sync.m16n8k32 s8 x s8 -> s32, K split over blocks when the
// output tiles alone do not fill the SMs. Each group's int32 partial turns
// into f32 once, times its scale row; the sums are exact up to that.
//
// B fragments: mma.m16n8k32 wants, per thread, four consecutive k rows of
// one column in one register. Thread (g, tig) reads the 32-bit words at
// column 4*g of its slab from rows 4*tig .. 4*tig+3 (and 16 + those), four
// columns each; a 4x4 byte transpose (prmt) turns them into one k-quad per
// column, and column 4*g + j goes to n8 tile j as in w8_gemm.cu. A
// fragments come from ldmatrix on the xq slab ([BM][32] bytes, pitch 48).
//
// Planted fault for chip_smoke.py (-DI8_FAULT=1): the int32 partial is not
// reset between groups (caught where a K split holds more than one group).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gw_common.cuh"

#ifndef I8_FAULT
#define I8_FAULT 0
#endif

namespace i8 {

constexpr int BN = 128, BK = 32, STAGES = 4, THREADS = 128;
constexpr int WP = BN + 16;  // W row pitch, bytes
constexpr int XP = BK + 16;  // xq row pitch, bytes

struct Args {
  const int8_t *xq;  // [M, K]
  const float *xs;   // [M]
  const int8_t *w;   // [K, N]
  const float *s;    // [K/group, N]
  __nv_bfloat16 *out;  // [M, N]
  float *ws;           // [splits, M, N] when splits > 1, else null
  int M, K, N, group, tiles_per_split;
};

template <int MT>
struct Smem {
  static constexpr int W_BYTES = BK * WP;
  static constexpr int STAGE = W_BYTES + 16 * MT * XP;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows w[0..3] (four columns each) -> o[j] = the four rows' bytes of column j
__device__ __forceinline__ void transpose4(uint32_t (&o)[4], const uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

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
  for (int c = tid; c < 16 * MT * (BK / 16); c += THREADS) {
    const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
    const bool ok = m0 + r < a.M;
    gw::cp16(sx + r * XP + col, a.xq + (ok ? (size_t)(m0 + r) * a.K + k0 + col : 0), ok);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS) i8_gemm_kernel(const Args a) {
  __shared__ __align__(128) unsigned char smem[STAGES * Smem<MT>::STAGE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 16 * MT, split = blockIdx.z;
  const int ktiles = a.K / BK;
  const int t0 = split * a.tiles_per_split, t1 = min(t0 + a.tiles_per_split, ktiles);
  const int slab = warp * 32;

  float acc[MT][4][4] = {};
  int part[MT][4][4] = {};

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
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      gw::ldsm4(af[mt], sx + (mt * 16 + (lane & 15)) * XP + (lane >> 4) * 16);
    uint32_t lo[4], hi[4], blo[4], bhi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned char *wr = stage + (4 * tig + i) * WP + slab + 4 * g;
      lo[i] = *reinterpret_cast<const uint32_t *>(wr);
      hi[i] = *reinterpret_cast<const uint32_t *>(wr + 16 * WP);
    }
    transpose4(blo, lo);
    transpose4(bhi, hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b[2] = {blo[j], bhi[j]};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_s8(part[mt][j], af[mt], b);
    }
    // a group ends here, or this K split does (W8A8: one group spans K)
    if (((kt + 1) * BK) % a.group == 0 || kt + 1 == t1) {
      const float *srow = a.s + (size_t)((kt * BK) / a.group) * a.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + slab + 8 * tig + j;
        const float s_lo = c < a.N ? srow[c] : 0.f, s_hi = c + 4 < a.N ? srow[c + 4] : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][j][0] += static_cast<float>(part[mt][j][0]) * s_lo;
          acc[mt][j][1] += static_cast<float>(part[mt][j][1]) * s_hi;
          acc[mt][j][2] += static_cast<float>(part[mt][j][2]) * s_lo;
          acc[mt][j][3] += static_cast<float>(part[mt][j][3]) * s_hi;
#if I8_FAULT != 1
          part[mt][j][0] = part[mt][j][1] = part[mt][j][2] = part[mt][j][3] = 0;
#endif
        }
      }
    }
  }
  gw::cp_async_wait<0>();

  const int c8 = n0 + slab + 8 * tig;
  if (c8 >= a.N) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mt * 16 + g + 8 * h;
      if (r >= a.M) continue;
      const float rs = a.ws ? 1.f : a.xs[r];
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * h] * rs;
        v[4 + j] = acc[mt][j][2 * h + 1] * rs;
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

// Sum the K splits' partials, times the row's activation scale, to bf16.
__global__ void i8_reduce_kernel(const Args a, int splits) {
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
    const float rs = a.xs[(i * 4) / a.N];
    uint2 o;
    o.x = gw::pack_bf16(t.x * rs, t.y * rs);
    o.y = gw::pack_bf16(t.z * rs, t.w * rs);
    reinterpret_cast<uint2 *>(a.out)[i] = o;
  }
}

template <int MT>
void launch(const Args &a, int splits, cudaStream_t st) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + 16 * MT - 1) / (16 * MT), splits);
  i8_gemm_kernel<MT><<<grid, THREADS, 0, st>>>(a);
}

}  // namespace i8

// y = (sum_g int32(xq_g . w_g) * scale[g]) * xs. xq [M, K] s8 contiguous,
// xs [M] f32, w [K, N] s8, scale [K/group, N] f32; ws [splits, M, N] f32
// when splits > 1. bm in {16, 32, 64}. Returns cudaGetLastError().
extern "C" int i8_gemm(const void *xq, const void *xs, const void *w, const void *scale,
                       int group, void *out, void *ws, int M, int K, int N, int splits,
                       int tiles_per_split, int bm, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  i8::Args a{static_cast<const int8_t *>(xq), static_cast<const float *>(xs),
             static_cast<const int8_t *>(w), static_cast<const float *>(scale),
             static_cast<__nv_bfloat16 *>(out), splits > 1 ? static_cast<float *>(ws) : nullptr,
             M, K, N, group, tiles_per_split};
  if (bm == 16) i8::launch<1>(a, splits, st);
  else if (bm == 32) i8::launch<2>(a, splits, st);
  else if (bm == 64) i8::launch<4>(a, splits, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) i8::i8_reduce_kernel<<<264, 256, 0, st>>>(a, splits);
  return static_cast<int>(cudaGetLastError());
}
