// moe_grouped_gemm (X6): the grouped expert GEMM of the mixture-of-experts
// layer on Hopper (sm_90a), over rows sorted by expert:
//   y[r, :] = x[rows[r], :] @ W[e(r)]        r in [0, R)
// with x [*, K] bf16 (row stride ldx; rows [R] int32 picks its rows, or
// null: row r itself), W [E, K, N] bf16 contiguous, offsets [E + 1] int32 on
// the device (expert e owns sorted rows [offsets[e], offsets[e + 1])), y
// [R, N] bf16 (row stride ldy). bf16 operands, f32 sums, bf16 out.
//
// Replaces no Pallas kernel: the JAX package's expert products are
// jax.lax.ragged_dot (rtp_llm_tpu/ops/moe.py:40-43), an XLA op, and PyTorch
// has no public form of it. The layer runs it twice a forward: gate-up (x
// gathered through rows = token of each sorted assignment, N = 2I) and down
// (the activation rows in sorted order, N = H).
//
// What bounds it. At decode every touched expert's [K, N] slice is read for
// a few rows: bytes. At prefill on the Qwen shapes (60-128 experts, 100-300
// rows an expert) every expert's slice is still read about once and the
// products are a third of the bytes' time or less: bytes. On Mixtral's (8
// experts, hundreds of rows each, K or N 14336) the products: operations.
// In between, the limit looks like the rate at which the multiprocessors
// take their tiles in from L2 (a fixed number of bytes a k-tile for a fixed
// number of products); PERF.md keeps it as an open question.
//
// One kernel, moe_gemm_wgmma_kernel, at three tile heights TM, 64, 128 and 160
// rows; the wrapper picks TM from the rows and experts (ops/moe.py
// tile_rows: the height of the least expected cost). The 64-row tiles serve
// decode too: a 16-row mma.sync kernel was slower than them at every row
// count swept (PERF.md, X6).
// * A fixed grid, capturable in a CUDA graph: ceil(R / TM) + E row tiles
//   (an upper bound: each expert wastes at most one partial tile) times the
//   column tiles, in one dimension. Each block finds its tile from the
//   device offsets: warp 0 takes the experts 32 at a time, lane l the tiles
//   of expert e0 + l, ceil(count / TM), in a warp-wide prefix sum; the lane
//   whose range holds row tile b / columns names the expert, whose t row
//   tiles x columns blocks follow each other, row tiles fastest. A block
//   past the last tile has no rows and exits. Nothing is read by the host.
// * Warp-specialised, 384 threads, TM x 256 tiles. A 64-row mma.sync tile
//   read 0.34-0.38 of its bound at 2048 prefill tokens on the Qwen shapes
//   and 0.15-0.18 on Mixtral's, for four reasons, each answered here:
// 1. mma.sync only: the products run on wgmma, both operands from shared
//    memory, in the transposed form y^T = W^T x^T of w8_gemm.cu's tile
//    kernel: A is a [64 k][64 n] box of W read M-major (as W lies in memory,
//    no transpose), B the tile's x rows K-major; the tile's rows are wgmma's
//    N (64, 128 or 160: no padding on M). Each of the two consumer warpgroups
//    owns two boxes, 128 columns. The natural form (x as A) would put rows
//    on M in steps of 64 and W's 256 columns on N: the same bytes a k-tile.
// 2. Every warp read the whole W tile through ldmatrix.trans: now each W
//    element in shared memory is read once, by one warpgroup's wgmma.
// 3. All threads copied and then computed: now warpgroup 0 only loads
//    (setmaxnreg down to PRODUCER_REGS) and the consumers only multiply (up
//    to CONSUMER_REGS). One producer thread loads W by TMA through a 3-D
//    tensor map (N, K, E), box {64 n, 64 k, 1}, four boxes a k-tile, in the
//    128-byte swizzle; a k-tile past K is zero-filled inside its own expert.
//    The map is encoded on the host at each launch and passed by value as a
//    __grid_constant__ parameter (a captured graph keeps it). The gate-up
//    product's x rows are a gather (TMA cannot gather rows): the
//    warpgroup's 128 threads copy them by cp.async into the same swizzle,
//    wait for them one tile later (LAG), fence them for the async proxy and
//    arrive on the stage's full mbarrier, which also counts TMA's bytes. The
//    down product's rows are x's own, in order: one more TMA box {64 k, TM
//    rows} over x takes their place. Against the gather (MOE_DOWN_GATHER)
//    the map is the faster at prefill, most on Mixtral's K 14336
//    (chip_smoke.py [moe-time] gather_x_ms beside tm*_ms; PERF.md, X6).
//    Consumers release a stage on its empty mbarrier once its products are
//    done (one wgmma group in flight).
// 4. 64 x 128 tiles read each W tile once a 64 rows and x once a 128
//    columns: now up to 160 x 256 tiles (an expert of 100-160 rows, the
//    Qwen models' prefill groups, reads its W slice once), a ring of four
//    stages of 40 / 48 / 52 KB (one block a multiprocessor), and an
//    expert's row tiles take each column tile in turn, so that the blocks on
//    the card at once share its W tiles in L2. (Pairing row tiles by index
//    instead read two experts' W at once wherever an expert had an odd
//    number of tiles: a 267-row group in 128-row tiles cost Mixtral-8x7B
//    35%, PERF.md, X6.)
// x's gathered columns past K (a K off a multiple of 64) repeat the row's
// last 16-byte chunk instead of being zero-filled: W's rows past K are zero
// (the map's fill), which alone keeps them out of the sums. Gathered rows
// past the tile's group are not copied, and the map's rows past it are the
// next expert's; their sums are never stored. The epilogue rounds to bf16
// once, stages the [TM][256] tile in the ring and stores rows [first, first
// + count) in 16-byte pieces (no TMA store: a partial tile would overwrite
// the next expert's rows, which another block writes).
//
// What bounds it: see PERF.md, X6, for the times (chip_smoke.py [moe-time]).
// At 2048 prefill tokens the Qwen shapes read about 0.8 of their byte bound;
// Mixtral's gate-up stays under 0.5 of its operation bound. ptxas still
// serialises the TM 64 instance's wgmma (C7514); it measures fastest at few
// rows an expert all the same.
//
// Limits (the launcher returns cudaErrorInvalidValue otherwise): K, N, ldx
// and ldy multiples of 8; x, W and y 16-byte aligned; TM 64, 128 or 160.
//
// Planted faults for chip_smoke.py (MOE_GEMM_FAULT): 1 leaves the last k
// stage out of every sum; 2 gives the second tile of each expert the first
// tile's rows; 3 the consumers' full-barrier parity never flips, so after
// the ring wraps they may multiply a stage before it is refilled (the stage
// is still released after a wait of the right parity); 4 W's map is 2-D over
// [E * K, N], so a k-tile past K reads the next expert's rows. A faulty
// build bounds its mbarrier waits (MOE_WAIT_BOUND: a wrong parity can wait
// for a phase that never comes).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gw_common.cuh"

#ifndef MOE_GEMM_FAULT
#define MOE_GEMM_FAULT 0
#endif
// 1: every mbarrier wait gives up after about a millisecond (the faulty
// builds, and a first run of a changed ring, which must not hang the card)
// 1: the down product's x rows by the gather too, instead of a TMA map
// (chip_smoke.py times it beside the map: [moe-time] gather_x_ms)
#ifndef MOE_DOWN_GATHER
#define MOE_DOWN_GATHER 0
#endif
#ifndef MOE_WAIT_BOUND
#define MOE_WAIT_BOUND (MOE_GEMM_FAULT != 0)
#endif

namespace {

constexpr int KT = 64;  // k a ring stage

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const __nv_bfloat16 *x;
  long long ldx;
  const int *rows;  // [R] or null
  const __nv_bfloat16 *w;
  const int *offsets;  // [E + 1]
  __nv_bfloat16 *y;
  long long ldy;
  int R, K, N, E;
};

// Warp 0: the expert whose row tiles hold row tile `b`, into tile[0..3] as
// (expert, its first sorted row, its rows, its first row tile); rows 0 for a
// block past the last tile.
template <int TM>
__device__ __forceinline__ void find_tile(const Args &a, int b, int lane, int *tile) {
  int base = 0;  // tiles of the experts before this chunk
  if (lane == 0) tile[2] = 0;
  __syncwarp();
  for (int e0 = 0; e0 < a.E; e0 += 32) {
    const int e = e0 + lane;
    const int lo = e < a.E ? a.offsets[e] : 0;
    const int cnt = e < a.E ? a.offsets[e + 1] - lo : 0;
    const int t = (cnt + TM - 1) / TM;
    int inc = t;  // inclusive prefix sum of the chunk's tiles
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const int excl = base + inc - t;
    if (b >= excl && b < excl + t) {
      tile[0] = e;
      tile[1] = lo;
      tile[2] = cnt;
      tile[3] = excl;
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
    if (b < base) break;  // warp-uniform: every lane holds the same base
  }
}

constexpr int WG = 128;              // threads a warpgroup
constexpr int WG_THREADS = 3 * WG;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int WBOX = KT * 64 * 2;   // 8 KB: W's [64 k][64 n], one TMA box, one wgmma's A
constexpr int LAG = 1;  // the producer arrives for tile t's x rows after issuing tile t + 1
// register budgets: 56 + 2 x 224 = 504 <= 3 x 168, the launch's share
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int BAR_EPILOGUE = 1;  // named barrier of the 256 consumer threads (0 is __syncthreads)
constexpr int MAX_PRE_E = 256;  // experts whose offsets a block stages in shared memory

// TM rows x WN columns a block; each consumer warpgroup owns two boxes of 64
// columns, one wgmma (M 64, N TM) each a k16 step
constexpr int WN = 256;
template <int TM>
struct WgRing {
  static constexpr int XSTAGE = TM * 128;        // x [TM rows][64 k] bf16, K-major, 128-byte swizzle
  static constexpr int WSTAGE = WN / 64 * WBOX;  // W [64 k][WN n] as four boxes
  static constexpr int STAGES = 4;
  static constexpr int W_OFF = STAGES * XSTAGE;
  static constexpr int SMEM = STAGES * (XSTAGE + WSTAGE) + 1024;  // + alignment slack
  static_assert(LAG <= STAGES - 2, "the producer must not wait on a stage it has to fill");
  static_assert(SMEM + 4096 <= 232448, "a block's shared memory");
  static_assert(TM * WN * 2 <= STAGES * (XSTAGE + WSTAGE), "the output tile reuses the ring");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// an arrival that also expects `bytes` of transactions (TMA's) in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of `parity` has completed: a spin inside one asm block,
// so that the compiler sees no loop between a tile's wgmma and the next
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#if MOE_WAIT_BOUND
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (clock64() - t0 > (1ll << 21)) return;  // about a millisecond
  }
#else
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
#endif
}

// W's box {64 n, 64 k, 1} at (n, k, e) into `dst`, its bytes counted on `bar`
__device__ __forceinline__ void tma_w(uint32_t dst, const CUtensorMap *map, int n, int k, int e,
                                      int K, uint32_t bar) {
#if MOE_GEMM_FAULT == 4
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(n), "r"(e * K + k)
      : "memory");
#else
  (void)K;
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(n), "r"(k), "r"(e)
      : "memory");
#endif
}

__device__ __forceinline__ void cp16_all(uint32_t dst, const void *src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// D[64 x 64] += A[64 x 16] x B[16 x 64] (gw::wgmma_ss's form at N 64: A M-major)
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n"  // scale-d on, scale-a / -b 1, A M-major, B K-major
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da, uint64_t db) {
  gw::wgmma_ss<1>(d, da, db);
}

// D[64 x 160] += A[64 x 16] x B[16 x 160] (the same form at N 160)
__device__ __forceinline__ void wgmma_tile(float (&d)[80], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db));
}

// An empty asm that reads and writes every accumulator: the compiler keeps
// its own reads and moves of them on one side of the wgmma sequence (without
// it ptxas serialised every wgmma: "non wgmma instructions reading
// accumulator registers")
template <int N>
__device__ __forceinline__ void fence_operands(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

template <int TM, bool GATHER>
__global__ void __launch_bounds__(WG_THREADS, 1)
    moe_gemm_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap) {
  using G = WgRing<TM>;
  constexpr int S = G::STAGES, MH = 2, HALF = TM / 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ long long src[TM];  // x's element offset of each tile row; -1 past the group
  __shared__ int off_s[MAX_PRE_E + 1];
  __shared__ int tile[4];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle wants 1024-byte aligned stages
  unsigned char *ring_p = smem_raw + (ring - raw);
  const int tid = threadIdx.x;

  const int b = blockIdx.x, cols = (a.N + WN - 1) / WN;
  if (tid < 32) {
    // the offsets in one round of independent loads, then the tile map
    const bool pre = a.E <= MAX_PRE_E;
    if (pre)
      for (int e = tid; e <= a.E; e += 32) off_s[e] = a.offsets[e];
    __syncwarp();
    Args staged = a;
    if (pre) staged.offsets = off_s;
    find_tile<TM>(staged, b / cols, tid, tile);
  }
  if (tid == 32) {
    for (int s = 0; s < S; ++s) {
      // gathered x: the producer threads + the TMA thread; else TMA's alone
      mbar_init(smem_addr(&full[s]), GATHER ? WG + 1 : 1);
      mbar_init(smem_addr(&empty[s]), 2 * WG);  // the consumer threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ex = tile[0], cnt = tile[2];
  if (cnt <= 0) return;
  // the block's row tile j in its expert and its column tile: an expert's
  // blocks run in turn, its row tiles fastest, so that the blocks on the
  // card at once share each of its W tiles in L2, however many tiles it has
  const int t = (cnt + TM - 1) / TM, k = b - tile[3] * cols;
  const int j = k % t, col_tile = k / t;
  const int first = tile[1] + (MOE_GEMM_FAULT == 2 && j == 1 ? 0 : j) * TM;
  const int count = min(TM, cnt - j * TM);
  if (GATHER) {
    for (int i = tid; i < TM; i += WG_THREADS)
      src[i] = i < count ? static_cast<long long>(a.rows ? a.rows[first + i] : first + i) * a.ldx
                         : -1;
    __syncthreads();
  }
  const int n0 = col_tile * WN;
  const int nt = (a.K + KT - 1) / KT;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // uniform to ptxas

  if (wg == 0) {
    // ============================== producer: W by TMA, x rows by cp.async
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (!GATHER && tid != 0) return;  // x's rows by TMA too: one thread loads
    // chunk c of tile rows r0 + 16 j: (r0 + 16 j) & 7 == r0 & 7, so one
    // swizzled offset serves every j
    const int c = tid & 7, r0 = tid >> 3;
    const uint32_t dst0 = r0 * 128 + ((c ^ (r0 & 7)) << 4);
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      if (!GATHER)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                     : "memory");
    }
    for (int t = 0; t < nt; ++t) {
      const int s = t % S, k0 = t * KT;
      if (t >= S) mbar_wait(smem_addr(&empty[s]), ((t / S) - 1) & 1);  // tile t - S released
      if (tid == 0) {
        const uint32_t bar = smem_addr(&full[s]), wd = ring + G::W_OFF + s * G::WSTAGE;
        mbar_arrive_tx(bar, G::WSTAGE + (GATHER ? 0 : G::XSTAGE));
#pragma unroll
        for (int q = 0; q < WN / 64; ++q) tma_w(wd + q * WBOX, &wmap, n0 + 64 * q, k0, ex, a.K, bar);
        // rows [first, first + TM) of x, zeros past K and past R; rows past
        // the group are the next expert's, never stored
        if (!GATHER)
          asm volatile(
              "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
              "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(ring + s * G::XSTAGE),
              "l"(reinterpret_cast<uint64_t>(&xmap)), "r"(bar), "r"(k0), "r"(first)
              : "memory");
      }
      if (!GATHER) continue;
      const __nv_bfloat16 *xk = a.x + min(k0 + c * 8, a.K - 8);  // past K: the last chunk again
      const uint32_t xd = ring + s * G::XSTAGE + dst0;
#pragma unroll
      for (int j = 0; j < TM / 16; ++j) {
        const long long off = src[r0 + 16 * j];
        if (off >= 0) cp16_all(xd + j * 2048, xk + off);
      }
      cp_async_commit();
      if (t >= LAG) {  // tile t - LAG's rows have landed: hand them to wgmma
        cp_async_wait<LAG>();
        gw::fence_async_proxy();
        mbar_arrive(smem_addr(&full[(t - LAG) % S]));
      }
    }
    if (GATHER) {
      cp_async_wait<0>();
      gw::fence_async_proxy();
      for (int t = max(0, nt - LAG); t < nt; ++t) mbar_arrive(smem_addr(&full[t % S]));
    }
    return;
  }

  // ================= consumers: MH boxes of 64 columns (WN / 2) x TM rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int h = wg - 1;
  float acc[MH][HALF];
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[m][i] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int s = t % S;
    const uint32_t full_s = smem_addr(&full[s]), parity = (t / S) & 1;
#if MOE_GEMM_FAULT == 3
    mbar_wait(full_s, 0);  // never flips: from the second round, maybe before the refill
#else
    mbar_wait(full_s, parity);
#endif
    const uint32_t xa = ring + s * G::XSTAGE;
    const uint32_t wa = ring + G::W_OFF + s * G::WSTAGE + h * MH * WBOX;
#if MOE_GEMM_FAULT == 1
    if (t < nt - 1) {
#endif
#pragma unroll
      for (int m = 0; m < MH; ++m) fence_operands(acc[m]);
      gw::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks)
#pragma unroll
        for (int m = 0; m < MH; ++m)
          // A: k rows 16 ks .. 16 ks + 15 of box m, M-major, 8-row groups
          // 1024 B apart; B: 32 bytes further along each x row
          wgmma_tile(acc[m], gw::wg_desc(wa + m * WBOX + ks * 2048, WBOX, 1024),
                     gw::wg_desc(xa + ks * 32, 16, 1024));
      gw::wgmma_commit();
#if MOE_GEMM_FAULT == 1
    }
#endif
#if MOE_GEMM_FAULT == 3
    mbar_wait(full_s, parity);  // the stage is still released in order
#endif
    gw::wgmma_wait<1>();  // tile t - 1's products are done: release its stage
#pragma unroll
    for (int m = 0; m < MH; ++m) fence_operands(acc[m]);
    if (t > 0) mbar_arrive(smem_addr(&empty[(t - 1) % S]));
  }
  gw::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MH; ++m) fence_operands(acc[m]);

  // thread (g, tig) of warp wi holds, in box m, columns col and col + 8 and
  // tile rows 8 j + 2 tig, + 1 of each n8 tile j: accumulator 4 j + 2 q + e
  // is column col + 8 q, row 8 j + 2 tig + e. The [TM rows][WN columns] bf16
  // tile goes into the ring (free once both warpgroups' products are done;
  // a row is 2 WN bytes, chunk ch stored at ch ^ (row & 7)) and leaves in
  // 16-byte stores.
  constexpr int PITCH = 2 * WN, CHUNKS = WN / 8;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3, wi = (tid >> 5) & 3;
  gw::bar_sync(BAR_EPILOGUE, 256);
#pragma unroll
  for (int m = 0; m < MH; ++m) {
    const int col = (h * MH + m) * 64 + 16 * wi + g;
#pragma unroll
    for (int j = 0; j < TM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + 2 * tig + e;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int cq = col + 8 * q;
          *reinterpret_cast<__nv_bfloat16 *>(ring_p + r * PITCH + (((cq >> 3) ^ (r & 7)) << 4) +
                                             (cq & 7) * 2) =
              __float2bfloat16_rn(acc[m][4 * j + 2 * q + e]);
        }
      }
  }
  gw::bar_sync(BAR_EPILOGUE, 256);
  for (int idx = tid - 128; idx < count * CHUNKS; idx += 256) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS, n = n0 + ch * 8;
    if (n < a.N)
      *reinterpret_cast<uint4 *>(a.y + static_cast<long long>(first + r) * a.ldy + n) =
          *reinterpret_cast<const uint4 *>(ring_p + r * PITCH + ((ch ^ (r & 7)) << 4));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap *, CUtensorMapDataType, cuuint32_t, void *,
                                 const cuuint64_t *, const cuuint64_t *, const cuuint32_t *,
                                 const cuuint32_t *, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda); null
// where it is missing
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// W [E, K, N] as a 3-D map (n, k, e), box {64, 64, 1}, 128-byte swizzle,
// zeros past each expert's K and past N
bool encode_w(const Args &a, CUtensorMap *map) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
#if MOE_GEMM_FAULT == 4
  const cuuint64_t dims[2] = {(cuuint64_t)a.N, (cuuint64_t)a.K * a.E};
  const cuuint64_t strides[1] = {(cuuint64_t)a.N * 2};
  const cuuint32_t box[2] = {64, KT};
  const cuuint32_t rank = 2;
#else
  const cuuint64_t dims[3] = {(cuuint64_t)a.N, (cuuint64_t)a.K, (cuuint64_t)a.E};
  const cuuint64_t strides[2] = {(cuuint64_t)a.N * 2, (cuuint64_t)a.K * a.N * 2};
  const cuuint32_t box[3] = {64, KT, 1};
  const cuuint32_t rank = 3;
#endif
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<__nv_bfloat16 *>(a.w), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x [R, K] (row stride ldx) as a 2-D map (k, row), box {64, TM}, 128-byte
// swizzle: the down product's rows, which need no gather
bool encode_x(const Args &a, int tm, CUtensorMap *map) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)a.K, (cuuint64_t)a.R};
  const cuuint64_t strides[1] = {(cuuint64_t)a.ldx * 2};
  const cuuint32_t box[2] = {KT, (cuuint32_t)tm}, elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16 *>(a.x), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TM, bool GATHER>
cudaError_t launch_wgmma(const Args &a, cudaStream_t stream) {
  using G = WgRing<TM>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_wgmma_kernel<TM, GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  CUtensorMap wmap, xmap;
  if (!encode_w(a, &wmap)) return cudaErrorInvalidValue;
  if (GATHER) xmap = wmap;  // unread
  else if (!encode_x(a, TM, &xmap)) return cudaErrorInvalidValue;
  const dim3 grid(((a.R + TM - 1) / TM + a.E) * ((a.N + WN - 1) / WN));
  moe_gemm_wgmma_kernel<TM, GATHER><<<grid, WG_THREADS, G::SMEM, stream>>>(a, wmap, xmap);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_wgmma(const Args &a, cudaStream_t stream) {
  return a.rows || MOE_DOWN_GATHER ? launch_wgmma<TM, true>(a, stream)
                                   : launch_wgmma<TM, false>(a, stream);
}

}  // namespace

extern "C" int moe_grouped_gemm(const void *x, long long ldx, const void *rows, const void *w,
                                const void *offsets, void *y, long long ldy, int R, int K, int N,
                                int E, int tile_m, void *stream) {
  if (K <= 0 || N <= 0 || K % 8 || N % 8 || ldx % 8 || ldy % 8 || E <= 0 || R <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16 *>(x), ldx, static_cast<const int *>(rows),
               static_cast<const __nv_bfloat16 *>(w), static_cast<const int *>(offsets),
               static_cast<__nv_bfloat16 *>(y), ldy, R, K, N, E};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_m) {
    case 64: return static_cast<int>(launch_wgmma<64>(a, st));
    case 128: return static_cast<int>(launch_wgmma<128>(a, st));
    case 160: return static_cast<int>(launch_wgmma<160>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
