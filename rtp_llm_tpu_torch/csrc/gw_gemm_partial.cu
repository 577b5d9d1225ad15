// Groupwise 4-bit GEMM in the group-partial form, for Hopper (sm_90a).
//
// Replaces the TPU sweep kernels of benchmarks/int4_kernel_sweep.py
// (make_variant with the bodies _gw_kernel_partial, _gw_kernel_i16dec and
// _gw_kernel_i8dec): the same product y = x @ dequant(packed), but the codes
// enter the product unscaled, as the exact small numbers they stand for
// (nibble - 8, or the e2m1 value, all exact in bf16). One f32 partial sum is
// kept per scale group and plane; when the group ends it is multiplied by
// s[group, n] and added to the f32 result. No weight is rounded after
// scaling, so the result differs from gw_gemm's in the last bf16 bits. Its
// plain version is the two-step form with f32 partials
// (ops/quant_gemm.py groupwise_matmul_partial_ref).
//
// What bounds it on the H100: as gw_gemm.cu, bytes at decode row counts and
// operations at prefill row counts. What this form changes: the decode is
// one multiply cheaper per weight (the scale is applied to 16*MT x 32
// partials per group instead of to every weight), at the price of a second
// set of accumulators, which caps the block at 32 rows.
//
// Tile sizes are launch parameters so a caller can sweep them: bm in
// {16, 32} rows, bn in {64, 128} columns, and the K split count. Layouts,
// tiling and the fragment mapping are in gw_common.cuh.

#include "gw_common.cuh"

namespace {

using namespace gw;

template <int MT, int WARPS, int CODE>
__global__ void __launch_bounds__(32 * WARPS) gw_gemm_partial_kernel(const Args a) {
  __shared__ Stage<MT, WARPS> st;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * 16 * MT, n0 = blockIdx.y * 32 * WARPS, split = blockIdx.z;
  const int t0 = split * a.tiles_per_split;
  const int t1 = min(t0 + a.tiles_per_split, a.K / 2 / KT);
  const int tiles_per_group = a.G / KT;
  float acc[MT][4][4] = {}, plo[MT][4][4] = {}, phi[MT][4][4] = {};
  for (int t = t0; t < t1; ++t) {
    load_tile<MT, WARPS, false>(st, a, m0, n0, t, tid);
    __syncthreads();
    mma_tile<MT, WARPS, CODE, false>(st, plo, phi, warp, lane);
    if ((t + 1) % tiles_per_group == 0 || t + 1 == t1) {
      // the group ends (or this split's share of it): scale the partials.
      // Accumulator c of tile j is slab column 8*tig + 4*(c & 1) + j.
      const float *sl = &st.s[0][warp * 32 + tig * 8], *sh = &st.s[1][warp * 32 + tig * 8];
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
    __syncthreads();
  }
  store_tile<MT, WARPS>(acc, a, m0, n0, split, warp, lane);
}

template <int MT, int WARPS, int CODE>
struct LaunchPartial {
  static void run(const Args &a, dim3 grid, cudaStream_t st) {
    gw_gemm_partial_kernel<MT, WARPS, CODE><<<grid, 32 * WARPS, 0, st>>>(a);
  }
};

}  // namespace

// Same interface as gw_gemm (gw_gemm.cu); bm in {16, 32}.
extern "C" int gw_gemm_partial(const void *x, long long x_stride, const void *packed,
                               const void *scale, void *out, void *ws, int M, int K, int N, int G,
                               int code, int splits, int bm, int bn, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const gw::Args a = gw::make_args(x, x_stride, packed, scale, out, ws, M, K, N, G, splits);
  if (!gw::Dispatch<LaunchPartial, 1, 2>::run(bm, bn, code, a, st))
    return static_cast<int>(cudaErrorInvalidValue);
  return gw::finish(a, st);
}
