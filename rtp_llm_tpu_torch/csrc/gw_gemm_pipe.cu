// Groupwise 4-bit dequant-GEMM, skewed form, for Hopper (sm_90a):
// y = x @ dequant(packed).
//
// gw_gemm_pipe replaces the TPU kernel rtp_llm_tpu/ops/quant_gemm.py
// _gw_kernel_pipe: gw_gemm's product (every weight decode(nibble) * scale in
// f32, rounded once to bf16, f32 sums, bf16 out), in which the decode of
// k-tile t overlaps the product of k-tile t - 1. The TPU kernel holds two
// decoded tiles in VMEM slots (wlo_ref / whi_ref [2, kpt, nt]) and its grid
// runs one step longer than the tiles. Here the same skew, two ways:
//
//  * gw_pipe_tile_kernel (M >= 128): warp-specialised. A block owns 256 (or
//    128) rows of x and 128 output columns and computes the transposed
//    product y^T = W^T x^T. Warpgroup 0 decodes: it copies k-tiles of x,
//    packed bytes and scales into a four-stage cp.async ring, decodes
//    packed k-tile t into decoded slot t % 2 (two shared [128 columns][64 k]
//    bf16 tiles in the 128-byte swizzle, 16-byte stores, conflict-free) and
//    hands it on through a named barrier. Warpgroups 1 and 2 multiply: each
//    owns 64 output columns x all rows and runs wgmma m64n256k16 with A the
//    decoded slot (t - 1) % 2 and B the x tile, both read from shared memory
//    through descriptors. Two more named barriers a slot say when the
//    products are done with it. So each weight is decoded once per 256
//    rows (gw_gemm: 128), and the decode runs on warps that issue no wgmma,
//    beside the tensor cores instead of in turn with them. setmaxnreg moves
//    registers from the decode warpgroup to the two that hold 128 f32
//    accumulators a thread.
//    Shared memory a k-tile of 64 k: the x tile (32 KB) read by both MMA
//    warpgroups, the decoded slot written and read (16 KB each), the copies
//    landing (37 KB): about 135 KB against about 1024 cycles of products at
//    128 B a cycle. The budget holds, but narrowly.
//  * gw_pipe_ring_kernel (M < 128): the ring of gw_common.cuh (stages,
//    running-pointer cp.async, ldmatrix), with the skew held in registers:
//    within a stage the B fragments of k16 step j + 1 are decoded into a
//    second register set while the mma.sync of step j issue.
//
// What bounds it: bytes at decode row counts, operations at prefill row
// counts, as gw_gemm.cu says. K splits, ragged edges and the fixed-order
// split reduce are gw_gemm's. Compiled with -DGW_FAULT=1 the MMA warpgroups
// read the decoded slot of the wrong parity, with -DGW_FAULT=2 the decode
// warpgroup writes without the swizzle: chip_smoke.py builds both to show
// that its check catches them.

#include "gw_common.cuh"

#ifndef GW_FAULT
#define GW_FAULT 0
#endif

namespace {

using namespace gw;

// ---------------------------------------------------------------- M < 128

template <int MT, int WARPS, int CODE>
__global__ void __launch_bounds__(32 * WARPS) gw_pipe_ring_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KS = RING_KT / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[MT][4][4] = {};
  ring_walk<MT, WARPS>(a, smem, [&](int, const unsigned char *st, uint32_t x_sa) {
    float sl[4], sh[4];
    ring_scales<MT, WARPS>(sl, sh, st, warp, lane);
    uint32_t w[4], blo[2][4][2], bhi[2][4][2], af[MT][4];
    ring_words<MT, WARPS>(w, st, 0, warp, lane);
    scaled_frags<CODE>(blo[0], bhi[0], w, sl, sh);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks + 1 < KS) {  // step ks + 1 into the other set, under step ks's products
        ring_words<MT, WARPS>(w, st, ks + 1, warp, lane);
        scaled_frags<CODE>(blo[(ks + 1) & 1], bhi[(ks + 1) & 1], w, sl, sh);
      }
      ring_x_frags<MT, WARPS>(af, x_sa, ks * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af[mt], blo[ks & 1][j]);
      ring_x_frags<MT, WARPS>(af, x_sa, RING_KT + ks * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af[mt], bhi[ks & 1][j]);
    }
  });
  store_tile<MT, WARPS>(acc, a, blockIdx.x * 16 * MT, blockIdx.y * 32 * WARPS, blockIdx.z, warp,
                        lane);
}

// ---------------------------------------------------------------- M >= 128

// Shared memory of a block, from a 1024-byte aligned base:
//   PT_STAGES x { x tile [BM rows][64 k] bf16, K-major, 128-byte swizzle
//                 (k 0..31 meet the low plane, 32..63 the high plane)
//               | packed [32][128 + 16] u8, row r at row slot prow(r)
//               | scale [2 planes][128] f32 }       padded to 1 KB a stage
//   2 decoded slots [128 columns][64 k] bf16, K-major, 128-byte swizzle (16 KB each)
// BM = 256: 4 x 38 KB + 32 KB = 185 KB, one block a multiprocessor.
constexpr int PT_BN = 128, PT_THREADS = 384, PT_STAGES = 4;
constexpr int PT_P_PITCH = PT_BN + 16;
constexpr int PT_P_BYTES = KT * PT_P_PITCH, PT_S_BYTES = 2 * PT_BN * 4;
constexpr int PT_SLOT = PT_BN * 128;
// named barriers: 0 is __syncthreads
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_DECODE = 5, BAR_MMA = 6;
// register budgets: 88 + 2 x 208 = 3 x 168, the launch's share
constexpr int DECODE_REGS = 88, MMA_REGS = 208;

template <int BM>
struct PipeTile {
  static constexpr int X_BYTES = BM * 128;
  static constexpr int STAGE = (X_BYTES + PT_P_BYTES + PT_S_BYTES + 1023) / 1024 * 1024;
  static constexpr int SLOTS_OFF = PT_STAGES * STAGE;
  static constexpr int SMEM = SLOTS_OFF + 2 * PT_SLOT + 1024;  // + alignment slack
  static_assert(BM * PT_BN * 2 <= SLOTS_OFF, "the output tile reuses the ring");
};

// Packed row r = 8 o + i of a k-tile lies at row slot 8 o + (i + 2 o) % 8:
// the decode warps read rows 8 o + i for o = 0..3 at once, and at a pitch of
// 144 B the four land on four different groups of 8 banks.
__device__ __forceinline__ int prow(int r) { return (r & ~7) + ((r + 2 * (r >> 3)) & 7); }

template <int BM, int CODE>
__global__ void __launch_bounds__(PT_THREADS, 1) gw_pipe_tile_kernel(const Args a) {
  using T = PipeTile<BM>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char *smem = smem_raw + (sbase - raw);
  const uint32_t slots = sbase + T::SLOTS_OFF;
  const int tid = threadIdx.x;
  // the warpgroup, read back from lane 0 so that ptxas sees it uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * PT_BN;
  int r0, r1;
  split_range(a, blockIdx.z, r0, r1);
  const int nt = (r1 - r0) / KT;  // K/2 % 32 == 0

  if (wg == 0) {
    // ======================== decode warpgroup: copies, decode, hand-off
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DECODE_REGS));
    // ---- what this thread copies each k-tile, from running pointers to
    // constant destinations: chunk x_c of x rows x_r + 16 j; packed chunk
    // p_c of rows p_r and p_r + 16; the first 64 threads a scale chunk.
    // Rows past M and columns past N are zero-filled.
    constexpr int XJ = BM / 16;
    const int k2 = a.K / 2;
    const int x_c = tid & 7, x_r = tid >> 3;
    const __nv_bfloat16 *xp =
        a.x + (size_t)(m0 + x_r) * a.xs + (x_c >= 4 ? k2 : 0) + (x_c & 3) * 8 + r0;
    const size_t x_step = (size_t)16 * a.xs;
    uint32_t x_ok = 0;
#pragma unroll
    for (int j = 0; j < XJ; ++j) x_ok |= (m0 + x_r + 16 * j < a.M ? 1u : 0u) << j;
    const uint32_t x_dst = x_r * 128 + ((x_c ^ (x_r & 7)) << 4);  // (x_r + 16 j) & 7 == x_r & 7
    const int p_c = tid & 7, p_r = tid >> 3;
    const bool p_ok = n0 + p_c * 16 < a.N;
    const uint8_t *pp = p_ok ? a.p + (size_t)(r0 + p_r) * a.N + n0 + p_c * 16 : a.p;
    const size_t p_half = p_ok ? (size_t)16 * a.N : 0;
    const uint32_t p_dst0 = T::X_BYTES + prow(p_r) * PT_P_PITCH + p_c * 16;
    const uint32_t p_dst1 = T::X_BYTES + prow(p_r + 16) * PT_P_PITCH + p_c * 16;
    const int s_pl = tid >> 5, s_c = tid & 31;  // plane, 4 columns
    const bool s_ok = tid < 64 && n0 + s_c * 4 < a.N;
    const float *sp = s_ok ? a.s + n0 + s_c * 4 : a.s;
    int s_g = (s_pl * k2 + r0) / a.G, s_in = (s_pl * k2 + r0) % a.G;  // scale row, rows into it
    auto load = [&](int stage) {  // the next 32 packed rows
      const uint32_t st = sbase + stage * T::STAGE;
#pragma unroll
      for (int j = 0; j < XJ; ++j) {
        const bool ok = (x_ok >> j) & 1u;
        cp16(st + x_dst + j * 16 * 128, ok ? xp + j * x_step : a.x, ok);
      }
      xp += KT;
      cp16(st + p_dst0, pp, p_ok);
      cp16(st + p_dst1, pp + p_half, p_ok);
      pp += 2 * p_half;
      if (tid < 64) {
        cp16(st + T::X_BYTES + PT_P_BYTES + tid * 16, s_ok ? sp + (size_t)s_g * a.N : a.s, s_ok);
        s_in += KT;
        if (s_in == a.G) s_in = 0, ++s_g;
      }
    };

    // ---- what this thread decodes: columns 4 q .. 4 q + 3 (one 32-bit word
    // a row) of packed rows 8 o .. 8 o + 7, both planes: 8 chunks of 8 k
    // values. Column n = 4 q + j, chunk 4 p + o (plane p) goes to row n of
    // the slot at chunk (4 p + o) ^ (n & 7); eight neighbouring threads (two
    // q, four o) hit eight different chunks: the 16-byte stores are
    // conflict-free.
    const int o = tid & 3, q = tid >> 2;
    auto decode = [&](int t) {
      const unsigned char *st = smem + (t % PT_STAGES) * T::STAGE;
      const unsigned char *pk = st + T::X_BYTES + 8 * o * PT_P_PITCH + 4 * q;
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t w = *reinterpret_cast<const uint32_t *>(pk + ((i + 2 * o) & 7) * PT_P_PITCH);
        lo[i] = w & 0x0F0F0F0Fu;
        hi[i] = (w >> 4) & 0x0F0F0F0Fu;
      }
      const float *sc = reinterpret_cast<const float *>(st + T::X_BYTES + PT_P_BYTES) + 4 * q;
      const float4 fl = *reinterpret_cast<const float4 *>(sc);
      const float4 fh = *reinterpret_cast<const float4 *>(sc + PT_BN);
      const float sl[4] = {fl.x, fl.y, fl.z, fl.w}, sh[4] = {fh.x, fh.y, fh.z, fh.w};
      const uint32_t dst = slots + (t & 1) * PT_SLOT + 4 * q * 128;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t *v = p ? hi : lo;
          const float s = p ? sh[j] : sl[j];
          uint32_t d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[e] = pack_bf16(decode_byte<CODE>(v[2 * e], j) * s,
                             decode_byte<CODE>(v[2 * e + 1], j) * s);
#if GW_FAULT == 2
          const int chunk = 4 * p + o;
#else
          const int chunk = (4 * p + o) ^ (4 * (q & 1) + j);  // (4 q + j) & 7
#endif
          st_shared16(dst + j * 128 + (chunk << 4), d[0], d[1], d[2], d[3]);
        }
      }
    };

    for (int s = 0; s < PT_STAGES - 2; ++s) {
      if (s < nt) load(s);
      cp_async_commit();
    }
    for (int t = 0; t < nt; ++t) {
      // the products of tile t - 2 are done: slot t % 2 and the ring stage
      // of tile t - 2 (= that of tile t + 2) are free
      if (t >= 2) bar_sync(BAR_EMPTY + (t & 1), PT_THREADS);
      const int nx = t + PT_STAGES - 2;
      if (nx < nt) load(nx % PT_STAGES);
      cp_async_commit();
      cp_async_wait<PT_STAGES - 2>();  // this thread's copies of tile t have landed
      bar_sync(BAR_DECODE, 128);       // everyone's
      decode(t);
      fence_async_proxy();  // the x tile and the decoded slot, for wgmma's reads
      bar_arrive(BAR_FULL + (t & 1), PT_THREADS);
    }
    return;
  }

  // ========================== MMA warpgroups: 64 output columns x BM rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
  const int h = wg - 1;
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < nt; ++t) {
    bar_sync(BAR_FULL + (t & 1), PT_THREADS);  // decoded slot t % 2 and x tile t are ready
    const uint32_t xa = sbase + (t % PT_STAGES) * T::STAGE;
#if GW_FAULT == 1
    const uint32_t wa = slots + ((t + 1) & 1) * PT_SLOT + h * 64 * 128;
#else
    const uint32_t wa = slots + (t & 1) * PT_SLOT + h * 64 * 128;
#endif
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0>(acc, wg_desc(wa + ks * 32, 16, 1024), wg_desc(xa + ks * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    if (t + 2 < nt) bar_arrive(BAR_EMPTY + (t & 1), PT_THREADS);
  }

  // thread (g, tig) of warp wi holds block columns c and c + 8 (rows g, g + 8
  // of its warp's 16) and tokens 8 j + 2 tig, + 1 of each n8 tile j
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3, wi = (tid >> 5) & 3;
  const int c = 64 * h + 16 * wi + g;
  if (a.splits > 1) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * tig + e;
        if (m >= a.M) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = n0 + c + 8 * r;
          if (n < a.N) a.ws[((size_t)blockIdx.z * a.M + m) * a.N + n] = acc[4 * j + 2 * r + e];
        }
      }
    return;
  }
  // bf16 output: the [BM tokens][128 columns] tile goes into the ring's memory
  // (free once both warpgroups' products are done; a token row is 256 B,
  // chunk ch stored at ch ^ (token & 7)) and leaves in 16-byte stores
  bar_sync(BAR_MMA, 256);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 8 * j + 2 * tig + e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = c + 8 * r;
        *reinterpret_cast<__nv_bfloat16 *>(smem + t * 256 + (((col >> 3) ^ (t & 7)) << 4) +
                                           (col & 7) * 2) = __float2bfloat16_rn(acc[4 * j + 2 * r + e]);
      }
    }
  bar_sync(BAR_MMA, 256);
  for (int idx = tid - 128; idx < BM * 16; idx += 256) {
    const int t = idx >> 4, ch = idx & 15;
    const int m = m0 + t, n = n0 + ch * 8;
    if (m < a.M && n < a.N)
      *reinterpret_cast<uint4 *>(a.out + (size_t)m * a.N + n) =
          *reinterpret_cast<const uint4 *>(smem + t * 256 + ((ch ^ (t & 7)) << 4));
  }
}

template <int MT, int WARPS, int CODE>
struct LaunchPipeRing {
  static void run(const Args &a, dim3 grid, cudaStream_t st) {
    constexpr int BYTES = ring_smem<MT, WARPS>();
    static bool done = false;
    if (!allow_smem(gw_pipe_ring_kernel<MT, WARPS, CODE>, BYTES, done)) return;  // finish() reports it
    gw_pipe_ring_kernel<MT, WARPS, CODE><<<grid, 32 * WARPS, BYTES, st>>>(a);
  }
};

template <int BM, int CODE>
void launch_pipe_tile(const Args &a, cudaStream_t st) {
  static bool done = false;
  if (!allow_smem(gw_pipe_tile_kernel<BM, CODE>, PipeTile<BM>::SMEM, done)) return;
  gw_pipe_tile_kernel<BM, CODE>
      <<<make_grid(a, BM, PT_BN), PT_THREADS, PipeTile<BM>::SMEM, st>>>(a);
}

}  // namespace

// x bf16 [M, K] (row stride x_stride elements), packed u8 [K/2, N], scale f32
// [K/G, N], out bf16 [M, N], ws f32 [splits, M, N] (unused when splits == 1).
// bm in {16, 32, 64} with bn in {64, 128}, or bm in {128, 256} with bn = 128;
// code 0 = s4, 1 = e2m1. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile that does not exist.
extern "C" int gw_gemm_pipe(const void *x, long long x_stride, const void *packed,
                            const void *scale, void *out, void *ws, int M, int K, int N, int G,
                            int code, int splits, int bm, int bn, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const gw::Args a = gw::make_args(x, x_stride, packed, scale, out, ws, M, K, N, G, splits);
  if (code != 0 && code != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bn == PT_BN && bm == 256) {
    if (code == 0) launch_pipe_tile<256, 0>(a, st);
    else launch_pipe_tile<256, 1>(a, st);
  } else if (bn == PT_BN && bm == 128) {
    if (code == 0) launch_pipe_tile<128, 0>(a, st);
    else launch_pipe_tile<128, 1>(a, st);
  } else if (!gw::Dispatch<LaunchPipeRing, 1, 2, 4>::run(bm, bn, code, a, st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return gw::finish(a, st);
}
