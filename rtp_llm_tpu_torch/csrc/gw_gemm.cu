// Groupwise 4-bit dequant-GEMM for Hopper (sm_90a): y = x @ dequant(packed).
//
// Two entry points, one function:
//   gw_gemm       replaces the TPU kernel rtp_llm_tpu/ops/quant_gemm.py
//                 _gw_kernel (decode a tile, multiply it, next tile);
//   gw_gemm_pipe  replaces rtp_llm_tpu/ops/quant_gemm.py _gw_kernel_pipe (the
//                 copy of the next tiles overlaps the decode and product of
//                 this one).
// Both give the same result: every weight is decode(nibble) * scale in f32,
// rounded to bf16, multiplied on the tensor cores (mma.sync m16n8k16) with
// f32 sums; the output is bf16. Layouts, tiling and the fragment mapping are
// in gw_common.cuh. The GPTQ/AWQ zero point is not in here: it is a rank-K/G
// correction the wrapper applies afterwards.
//
// What bounds it on the H100. At decode (M <= 64 rows) bytes: the packed
// weights are read once, K*N/2 bytes plus 4*K*N/G of scales, and 2*M*K*N
// operations sit far below the card's ~295 FLOP/B ridge. At prefill
// (M >= ~512) operations.
//
// What the design does about it:
//  * weights stay packed all the way into shared memory (0.5 B per weight
//    from device memory, 16-byte loads along N) and are decoded in registers
//    straight into mma B fragments; nothing dequantized is ever written back;
//  * a decoded fragment is reused by all MT m16 tiles of the block, so the
//    decode arithmetic is paid once per 16*MT rows;
//  * when M and N alone give too few blocks for the SMs (o_proj, down_proj at
//    decode), the wrapper narrows the N tile to 64 and splits K across
//    blockIdx.z; splits write f32 partial results to a workspace and
//    reduce_splits adds them in a fixed order (no atomics, no host sync);
//  * ragged M and N edges are masked in the loader and the store;
//  * gw_gemm_pipe keeps a ring of STAGES k-tiles in shared memory filled by
//    cp.async (16-byte, wait_group), so tiles t+1 and t+2 are in flight while
//    tile t is decoded and multiplied. The TPU kernel's two revolving buffers
//    become a three-deep ring: one block has to keep more bytes in flight
//    here to cover device-memory latency.
// Not yet: ldmatrix, wgmma, TMA, a warp-specialised producer (later PRs).

#include "gw_common.cuh"

namespace {

using namespace gw;

constexpr int STAGES = 3;

template <int MT, int WARPS, int CODE>
__global__ void __launch_bounds__(32 * WARPS) gw_gemm_kernel(const Args a) {
  __shared__ Stage<MT, WARPS> st;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * 16 * MT, n0 = blockIdx.y * 32 * WARPS, split = blockIdx.z;
  const int t0 = split * a.tiles_per_split;
  const int t1 = min(t0 + a.tiles_per_split, a.K / 2 / KT);
  float acc[MT][4][4] = {};
  for (int t = t0; t < t1; ++t) {
    load_tile<MT, WARPS, false>(st, a, m0, n0, t, tid);
    __syncthreads();
    mma_tile<MT, WARPS, CODE, true>(st, acc, acc, warp, lane);
    __syncthreads();
  }
  store_tile<MT, WARPS>(acc, a, m0, n0, split, warp, lane);
}

template <int MT, int WARPS, int CODE>
__global__ void __launch_bounds__(32 * WARPS) gw_gemm_pipe_kernel(const Args a) {
  __shared__ Stage<MT, WARPS> st[STAGES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * 16 * MT, n0 = blockIdx.y * 32 * WARPS, split = blockIdx.z;
  const int t0 = split * a.tiles_per_split;
  const int nt = min(t0 + a.tiles_per_split, a.K / 2 / KT) - t0;
  float acc[MT][4][4] = {};
  // one commit group per ring slot, empty past the end, so that
  // wait_group<STAGES - 2> always means "tile i has landed"
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load_tile<MT, WARPS, true>(st[s], a, m0, n0, t0 + s, tid);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i visible to all; everyone is done with tile i - 1
    const int nx = i + STAGES - 1;
    if (nx < nt) load_tile<MT, WARPS, true>(st[nx % STAGES], a, m0, n0, t0 + nx, tid);
    cp_async_commit();
    mma_tile<MT, WARPS, CODE, true>(st[i % STAGES], acc, acc, warp, lane);
  }
  store_tile<MT, WARPS>(acc, a, m0, n0, split, warp, lane);
}

template <int MT, int WARPS, int CODE>
struct LaunchBase {
  static void run(const Args &a, dim3 grid, cudaStream_t st) {
    gw_gemm_kernel<MT, WARPS, CODE><<<grid, 32 * WARPS, 0, st>>>(a);
  }
};

template <int MT, int WARPS, int CODE>
struct LaunchPipe {
  static void run(const Args &a, dim3 grid, cudaStream_t st) {
    gw_gemm_pipe_kernel<MT, WARPS, CODE><<<grid, 32 * WARPS, 0, st>>>(a);
  }
};

}  // namespace

// x bf16 [M, K] (row stride x_stride elements), packed u8 [K/2, N], scale f32
// [K/G, N], out bf16 [M, N], ws f32 [splits, M, N] (unused when splits == 1).
// bm in {16, 32, 64}, bn in {64, 128}, code 0 = s4, 1 = e2m1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tile that does not exist.
extern "C" int gw_gemm(const void *x, long long x_stride, const void *packed, const void *scale,
                       void *out, void *ws, int M, int K, int N, int G, int code, int splits,
                       int bm, int bn, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const gw::Args a = gw::make_args(x, x_stride, packed, scale, out, ws, M, K, N, G, splits);
  if (!gw::Dispatch<LaunchBase, 1, 2, 4>::run(bm, bn, code, a, st))
    return static_cast<int>(cudaErrorInvalidValue);
  return gw::finish(a, st);
}

extern "C" int gw_gemm_pipe(const void *x, long long x_stride, const void *packed,
                            const void *scale, void *out, void *ws, int M, int K, int N, int G,
                            int code, int splits, int bm, int bn, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const gw::Args a = gw::make_args(x, x_stride, packed, scale, out, ws, M, K, N, G, splits);
  if (!gw::Dispatch<LaunchPipe, 1, 2, 4>::run(bm, bn, code, a, st))
    return static_cast<int>(cudaErrorInvalidValue);
  return gw::finish(a, st);
}
