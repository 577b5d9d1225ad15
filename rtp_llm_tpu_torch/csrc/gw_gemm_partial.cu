// Groupwise 4-bit GEMM in the group-partial form, for Hopper (sm_90a).
//
// Replaces the TPU sweep kernels of benchmarks/int4_kernel_sweep.py
// (make_variant with the bodies _gw_kernel_partial, _gw_kernel_i16dec and
// _gw_kernel_i8dec): y = x @ dequant(packed), but the codes enter the
// product unscaled, as the exact small numbers they stand for (nibble - 8,
// or the e2m1 value, all exact in bf16). One f32 partial sum is kept per
// scale group and plane; when the group ends it is multiplied by s[group, n]
// and added to the f32 result. No weight is rounded after scaling, so the
// result differs from gw_gemm's in the last bf16 bits. Its plain version is
// the two-step form with f32 partials (ops/quant_gemm.py
// groupwise_matmul_partial_ref). The sweep kernels decode a nibble as two's
// complement, (c ^ 8) - 8, on bytes the package packs as offset codes: on
// the same bytes they compute another function (tests/test_torch_quant_gemm.py
// pins it). This kernel keeps the offset decode, c - 8, of the served path.
//
// What bounds it on the H100: as gw_gemm.cu, bytes at decode row counts and
// operations at prefill row counts. It runs on the ring of gw_common.cuh
// (stages of cp.async from running pointers, ldmatrix A fragments), so bytes
// stay in flight while it multiplies. What this form changes: the s4 decode
// is three operations for two weights and no f32 arithmetic: one prmt brings
// the bytes of two neighbouring k rows together, one lop3 drops their
// nibbles into the mantissa of bf16 128.0 (0x4300 | c is exactly 128 + c),
// one sub.bf16x2 of 136 leaves c - 8 exactly. The scale is applied to BM x 32
// partials a warp per group instead of to every weight; the price is a second
// set of accumulators. Compiled with -DGW_FAULT=3 the group's partials take
// the scales of the next ring stage (the next group's at a group's end):
// chip_smoke.py builds it to show that its check catches that.
//
// Tile sizes are launch parameters so a caller can sweep them: bm in
// {16, 32, 64} rows, bn in {64, 128} columns, and the K split count.
// Layouts, tiling and the fragment mapping are in gw_common.cuh.

#include "gw_common.cuh"

#ifndef GW_FAULT
#define GW_FAULT 0
#endif

namespace {

using namespace gw;

// Rows r, r + 1 (words a, b) of byte j, as a bf16 pair of exact codes
// c - 8; `a` and `b` hold the wanted nibble in the low four bits of a byte.
template <int J>
__device__ __forceinline__ uint32_t s4_pair(uint32_t a, uint32_t b) {
  constexpr uint32_t SEL = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t v = (__byte_perm(a, b, SEL) & 0x000F000Fu) | 0x43004300u;  // 128 + c
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(0x43084308u));  // - 136
  return r;
}

// B fragments of the unscaled codes, low and high plane.
template <int CODE>
__device__ __forceinline__ void code_frags(uint32_t (&blo)[4][2], uint32_t (&bhi)[4][2],
                                           const uint32_t (&w)[4]) {
  if constexpr (CODE == 0) {
    uint32_t hw[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) hw[r] = w[r] >> 4;
    blo[0][0] = s4_pair<0>(w[0], w[1]), blo[0][1] = s4_pair<0>(w[2], w[3]);
    blo[1][0] = s4_pair<1>(w[0], w[1]), blo[1][1] = s4_pair<1>(w[2], w[3]);
    blo[2][0] = s4_pair<2>(w[0], w[1]), blo[2][1] = s4_pair<2>(w[2], w[3]);
    blo[3][0] = s4_pair<3>(w[0], w[1]), blo[3][1] = s4_pair<3>(w[2], w[3]);
    bhi[0][0] = s4_pair<0>(hw[0], hw[1]), bhi[0][1] = s4_pair<0>(hw[2], hw[3]);
    bhi[1][0] = s4_pair<1>(hw[0], hw[1]), bhi[1][1] = s4_pair<1>(hw[2], hw[3]);
    bhi[2][0] = s4_pair<2>(hw[0], hw[1]), bhi[2][1] = s4_pair<2>(hw[2], hw[3]);
    bhi[3][0] = s4_pair<3>(hw[0], hw[1]), bhi[3][1] = s4_pair<3>(hw[2], hw[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) b[r] = (w[r] >> (8 * j)) & 0xFFu;
      blo[j][0] = pack_bf16(decode<1>(b[0] & 15u), decode<1>(b[1] & 15u));
      blo[j][1] = pack_bf16(decode<1>(b[2] & 15u), decode<1>(b[3] & 15u));
      bhi[j][0] = pack_bf16(decode<1>(b[0] >> 4), decode<1>(b[1] >> 4));
      bhi[j][1] = pack_bf16(decode<1>(b[2] >> 4), decode<1>(b[3] >> 4));
    }
  }
}

template <int MT, int WARPS, int CODE>
__global__ void __launch_bounds__(32 * WARPS) gw_gemm_partial_kernel(const Args a) {
  using R = Ring<16 * MT, 32 * WARPS>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  int r0, r1;
  split_range(a, blockIdx.z, r0, r1);
  const int t0 = r0 / RING_KT, t1 = r1 / RING_KT, tiles_per_group = a.G / RING_KT;
  float acc[MT][4][4] = {}, plo[MT][4][4] = {}, phi[MT][4][4] = {};
  ring_walk<MT, WARPS>(a, smem, [&](int i, const unsigned char *st, uint32_t x_sa) {
#pragma unroll
    for (int ks = 0; ks < RING_KT / 16; ++ks) {
      uint32_t w[4], blo[4][2], bhi[4][2], af[MT][4];
      ring_words<MT, WARPS>(w, st, ks, warp, lane);
      code_frags<CODE>(blo, bhi, w);
      ring_x_frags<MT, WARPS>(af, x_sa, ks * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(plo[mt][j], af[mt], blo[j]);
      ring_x_frags<MT, WARPS>(af, x_sa, RING_KT + ks * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(phi[mt][j], af[mt], bhi[j]);
    }
    const int t = t0 + i;
    if ((t + 1) % tiles_per_group == 0 || t + 1 == t1) {
      // the group ends (or this split's share of it): scale the partials.
      // Accumulator c of tile j is slab column 8*tig + 4*(c & 1) + j.
#if GW_FAULT == 3
      const unsigned char *ss = smem + ((i + 1) % RING_STAGES_OF<MT>) * R::BYTES;
#else
      const unsigned char *ss = st;
#endif
      const float *sl = reinterpret_cast<const float *>(ss + R::S_OFF) + warp * 32 + tig * 8;
      const float *sh = sl + 32 * WARPS;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = 4 * (c & 1) + j;
            acc[mt][j][c] += plo[mt][j][c] * sl[col] + phi[mt][j][c] * sh[col];
            plo[mt][j][c] = 0.f, phi[mt][j][c] = 0.f;
          }
    }
  });
  store_tile<MT, WARPS>(acc, a, blockIdx.x * 16 * MT, blockIdx.y * 32 * WARPS, blockIdx.z, warp,
                        lane);
}

template <int MT, int WARPS, int CODE>
struct LaunchPartial {
  static void run(const Args &a, dim3 grid, cudaStream_t st) {
    constexpr int BYTES = ring_smem<MT, WARPS>();
    static bool done = false;
    if (!allow_smem(gw_gemm_partial_kernel<MT, WARPS, CODE>, BYTES, done)) return;
    gw_gemm_partial_kernel<MT, WARPS, CODE><<<grid, 32 * WARPS, BYTES, st>>>(a);
  }
};

}  // namespace

// Same interface as gw_gemm (gw_gemm.cu); bm in {16, 32, 64}, bn in {64, 128}.
extern "C" int gw_gemm_partial(const void *x, long long x_stride, const void *packed,
                               const void *scale, void *out, void *ws, int M, int K, int N, int G,
                               int code, int splits, int bm, int bn, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const gw::Args a = gw::make_args(x, x_stride, packed, scale, out, ws, M, K, N, G, splits);
  if (!gw::Dispatch<LaunchPartial, 1, 2, 4>::run(bm, bn, code, a, st))
    return static_cast<int>(cudaErrorInvalidValue);
  return gw::finish(a, st);
}
