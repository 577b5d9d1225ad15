// Groupwise 4-bit dequant-GEMM for Hopper (sm_90a): y = x @ dequant(packed).
//
// gw_gemm replaces the TPU kernel rtp_llm_tpu/ops/quant_gemm.py _gw_kernel
// (decode a tile, multiply it, next tile). Every weight is decode(nibble) *
// scale in f32, rounded once to bf16, multiplied on the tensor cores
// (mma.sync m16n8k16, or wgmma in the 128-row kernel) with f32 sums; the
// output is bf16. The packed layout, the fragment mapping and the ring are in
// gw_common.cuh. The GPTQ/AWQ zero point is not in here: it is a rank-K/G
// correction the wrapper applies afterwards. gw_gemm_pipe.cu computes the
// same function with the decode skewed against the products.
//
// What bounds it on the H100. At decode (M <= 64 rows) bytes: the packed
// weights are read once, K*N/2 bytes plus 4*K*N/G of scales, and 2*M*K*N
// operations sit far below the card's ~295 FLOP/B ridge; what a kernel then
// needs is enough bytes in flight a multiprocessor to cover device-memory
// latency (3.35 TB/s x ~1 us / 132 = ~25 KB) and a decode cheap enough not
// to become the limit itself. At prefill (M >= ~512) operations: the decode
// arithmetic must be paid once for many rows and the products must be fed
// by ldmatrix, not by 32-bit shared loads.
//
// Two kernels behind one entry (the wrapper's plan picks by M):
//  * gw_ring_kernel, row tiles of 16 / 32 / 64 (M < 128), on the shared ring
//    (gw_common.cuh ring_walk). Weights stay packed all the way into shared
//    memory (0.5 B a weight from device memory) and are decoded in registers
//    straight into mma.sync B fragments. A ring of four to six stages; a
//    stage is a k-tile of 32 packed rows: 4 KB of weights at 128 columns, the
//    block's x slab for those 64 k values and two scale rows. 47-59 KB a
//    block, so three to four blocks share a multiprocessor and all 296
//    column blocks of a 37888-wide linear are resident at once; with three
//    to five tiles in flight a block that is 36-80 KB of weights in flight a
//    multiprocessor. A fragments come from ldmatrix (row pitch 144 B:
//    conflict-free); the two products that add into one accumulator (low
//    and high plane) go out 4 MT instructions apart, not back to back.
//  * gw_tile_kernel, 128 rows x 128 columns a block (M >= 128), on wgmma. It
//    computes the transposed product y^T = W^T x^T: wgmma's 64-row A operand
//    may come from registers, so each warp decodes the bytes of its
//    16 output columns straight into A fragments (a decoded weight serves
//    all 128 rows of x and never touches shared memory), and the x tile, as
//    cp.async lands it in the 128-byte swizzle, is the K-major B operand.
//    Neighbouring warpgroups run half a step apart, so one's decode runs
//    beside the other's products. The output tile goes through shared memory
//    and leaves in 16-byte stores. Ring of four stages, two blocks a
//    multiprocessor.
//  * the s4 decode is three operations a weight (gw_common.cuh
//    scaled_frags). prmt, the masks, cvt and all index arithmetic share the
//    half-rate integer pipe, which is what the kernels run against once loads
//    are hidden: both kernels' copies therefore use running pointers and
//    constant destinations (per-copy index arithmetic cost the few-row kernel
//    a quarter of its time).
//  * o_proj / down_proj at few rows: the wrapper splits K across blockIdx.z
//    in whole k-tiles (also to even out the rounds when a wide linear gives
//    2.2 blocks a multiprocessor); splits write f32 partial results to a
//    workspace and reduce_splits adds them in a fixed order (no atomics:
//    results do not change from run to run);
//  * ragged M and N edges are zero-filled by the loaders (cp.async with
//    source size 0) and masked in the stores.
// What did not pay, measured on the card: an mma.sync 128 x 128 block with
// the weights decoded into a shared bf16 tile (no faster than 64-row
// tiles: every warp re-read the A tile); wgmma with that decoded tile as
// its shared-memory B operand (shared-memory traffic, 97 KB a k-tile
// against 48 KB of operand reads, set the time); two A-fragment sets to
// decode tile i + 1 under tile i's products (ptxas serialises wgmma whose
// register operands are written while another is in flight).

#include "gw_common.cuh"

namespace {

using namespace gw;

// ---------------------------------------------------------------- gw_gemm

constexpr int TILE_KT = 32;      // packed rows per k-tile of gw_tile_kernel
constexpr int TILE_BM = 128;     // rows of x a block of gw_tile_kernel

template <int MT, int WARPS, int CODE>
__global__ void __launch_bounds__(32 * WARPS) gw_ring_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[MT][4][4] = {};
  ring_walk<MT, WARPS>(a, smem, [&](int, const unsigned char *st, uint32_t x_sa) {
    float sl[4], sh[4];
    ring_scales<MT, WARPS>(sl, sh, st, warp, lane);
#pragma unroll
    for (int ks = 0; ks < RING_KT / 16; ++ks) {
      uint32_t w[4], blo[4][2], bhi[4][2], af[MT][4];
      ring_words<MT, WARPS>(w, st, ks, warp, lane);
      scaled_frags<CODE>(blo, bhi, w, sl, sh);
      // all low-plane products, then all high-plane ones: the two that
      // add into one accumulator are 4 MT instructions apart, not neighbours
      ring_x_frags<MT, WARPS>(af, x_sa, ks * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af[mt], blo[j]);
      ring_x_frags<MT, WARPS>(af, x_sa, RING_KT + ks * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af[mt], bhi[j]);
    }
  });
  store_tile<MT, WARPS>(acc, a, blockIdx.x * 16 * MT, blockIdx.y * 32 * WARPS, blockIdx.z, warp,
                        lane);
}

// ---- gw_tile_kernel: wgmma, the weights as its register operand -------------
//
// The block computes the transposed product y^T = W^T x^T: wgmma's 64-row A
// operand, which may come from registers, is a slab of 64 output columns of
// W^T, decoded from the packed bytes straight into A fragments; its B
// operand, which must lie in shared memory, is the x tile as it arrives
// (K-major, no transpose). Decoded weights never pass through shared memory:
// a first form that decoded into a shared bf16 tile for a shared-memory B
// operand moved 97 KB of shared memory a k-tile against 48 KB the products
// themselves read, and ran at that limit.
//
// Shared memory of a block, from a 1024-byte aligned base (the 128-byte
// swizzle of the wgmma descriptor repeats every 1024 bytes):
//   TILE_STAGES x { x tile [128 rows][64 k] bf16, K-major: a row is 128 B, its
//                   16-byte chunk c stored at c ^ (row & 7); k 0..31 meet the
//                   low plane, k 32..63 the high plane           (16 KB)
//                 | packed [32][128 + 16] u8 (pitch 144 B: the 16-bit reads
//                   of a warp's four row pairs spread over all banks)
//                 | scale [2 planes][128] f32 }   padded to 22 KB a stage
//                   padded to 22 KB a stage
// Two warpgroups (64 output columns each) share one x tile; four stages, 89
// KB, two blocks a multiprocessor. Four warpgroups on 256 columns (x re-read
// from L2 half as often, one block a multiprocessor) measured no faster at
// any shape and slower at most.
constexpr int TILE_BN = 128, TILE_THREADS = 256, TILE_STAGES = 4;
constexpr int TP_PITCH = TILE_BN + 16;
constexpr int TX_BYTES = TILE_BM * 128, TP_BYTES = TILE_KT * TP_PITCH, TS_BYTES = 2 * TILE_BN * 4;
constexpr int TSTAGE_BYTES = (TX_BYTES + TP_BYTES + TS_BYTES + 1023) / 1024 * 1024;
constexpr int TILE_SMEM = TILE_STAGES * TSTAGE_BYTES + 1024;  // + alignment slack
static_assert(TILE_BM * TILE_BN * 2 <= TILE_STAGES * TSTAGE_BYTES, "the output tile reuses the ring");
static_assert(TILE_KT * (TILE_BN / 16) == TILE_THREADS, "one 16-byte chunk of packed bytes a thread");

// D[64 x 128] += A[64 x 16] (registers: each warp of the warpgroup its 16
// rows, in the fragment layout of mma.m16n8k16's A) x B[16 x 128] (shared
// memory, K-major), bf16 operands, f32 sums, asynchronous.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&af)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"  // D +=; scale-a, scale-b = 1; B as it lies
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "l"(db), "r"(1));
}
template <int CODE>
__global__ void __launch_bounds__(TILE_THREADS, 2) gw_tile_kernel(const Args a) {
  constexpr int THREADS = TILE_THREADS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char *smem = smem_raw + (sbase - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * TILE_BM, n0 = blockIdx.y * TILE_BN;
  const int k2 = a.K / 2;
  int r0, r1;
  split_range(a, blockIdx.z, r0, r1);
  const int nt = (r1 - r0) / TILE_KT;  // K/2 % 32 == 0

  // ---- what this thread copies each k-tile: chunk x_c of x rows x_r, x_r +
  // 32, ..; one packed chunk; the first 64 threads one scale
  // chunk. Tiles are loaded in order, so the sources are running pointers
  // and the destinations constants: the integer pipe, which the decode
  // needs, spends a few operations a copy instead of the index arithmetic.
  constexpr int XJ = TILE_BM * 8 / THREADS;
  const int x_c = tid & 7, x_r = tid >> 3;
  const uint32_t x_dst = x_r * 128 + ((x_c ^ (x_r & 7)) << 4);  // row & 7 is the same for all
  const __nv_bfloat16 *xp[XJ];
  bool x_ok[XJ];
#pragma unroll
  for (int j = 0; j < XJ; ++j) {
    const int m = m0 + x_r + (THREADS / 8) * j;
    x_ok[j] = m < a.M;
    xp[j] = x_ok[j] ? a.x + (size_t)m * a.xs + (x_c >= 4 ? k2 : 0) + (x_c & 3) * 8 + r0 : a.x;
  }
  const int p_row = tid / (TILE_BN / 16), p_c16 = tid % (TILE_BN / 16);  // row, 16 columns
  const bool p_ok = n0 + p_c16 * 16 < a.N;
  const uint8_t *pp = p_ok ? a.p + (size_t)(r0 + p_row) * a.N + n0 + p_c16 * 16 : a.p;
  const size_t p_step = p_ok ? (size_t)TILE_KT * a.N : 0;
  const uint32_t p_dst = TX_BYTES + p_row * TP_PITCH + p_c16 * 16;
  const int s_pl = tid / (TILE_BN / 4), s_c = tid % (TILE_BN / 4);  // plane, 4 columns
  const bool s_ok = tid < TILE_BN / 2 && n0 + s_c * 4 < a.N;
  const float *sp = s_ok ? a.s + n0 + s_c * 4 : a.s;
  int s_g = (s_pl * k2 + r0) / a.G, s_in = (s_pl * k2 + r0) % a.G;  // scale row, rows into it
  auto load = [&](int stage) {  // the next 32 packed rows
    const uint32_t st = sbase + stage * TSTAGE_BYTES;
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      cp16(st + x_dst + j * (THREADS / 8) * 128, xp[j], x_ok[j]);
      xp[j] += TILE_KT;
    }
    cp16(st + p_dst, pp, p_ok);
    pp += p_step;
    if (tid < TILE_BN / 2) {
      cp16(st + TX_BYTES + TP_BYTES + tid * 16, s_ok ? sp + (size_t)s_g * a.N : a.s, s_ok);
      s_in += TILE_KT;
      if (s_in == a.G) s_in = 0, ++s_g;
    }
  };

  // ---- the product's rows are output columns. Warp w owns 16 of them, from
  // c0 = 16 w; its fragment row r is column c0 + 2 (r % 8) + r / 8, so the
  // thread's two rows g and g + 8 are the neighbouring columns c0 + 2 g, + 1:
  // one 16-bit load gives both for one k row.
  const int c0 = warp * 16 + 2 * g;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < TILE_STAGES - 2; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }

  // decode k-tile i into the A fragments of its four k16 steps: low plane
  // rows 0..15, 16..31, then the high plane's
  uint32_t af[4][4];
  auto decode = [&](int i) {
    const unsigned char *st = smem + (i % TILE_STAGES) * TSTAGE_BYTES;
    const float *sc = reinterpret_cast<const float *>(st + TX_BYTES + TP_BYTES) + c0;
    const float2 sl = *reinterpret_cast<const float2 *>(sc);
    const float2 sh = *reinterpret_cast<const float2 *>(sc + TILE_BN);
    const unsigned char *pw = st + TX_BYTES + (2 * tig) * TP_PITCH + c0;
#pragma unroll
    for (int ks = 0; ks < TILE_KT / 16; ++ks) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // k rows 2 tig, + 1; then 2 tig + 8, + 9
        const unsigned char *q = pw + (ks * 16 + hf * 8) * TP_PITCH;
        // bytes: (column c0, k), (c0 + 1, k), (c0, k + 1), (c0 + 1, k + 1)
        const uint32_t w = (uint32_t)*reinterpret_cast<const uint16_t *>(q) |
                           ((uint32_t)*reinterpret_cast<const uint16_t *>(q + TP_PITCH) << 16);
        const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
        af[ks][2 * hf] = pack_bf16(decode_byte<CODE>(lo, 0) * sl.x, decode_byte<CODE>(lo, 2) * sl.x);
        af[ks][2 * hf + 1] = pack_bf16(decode_byte<CODE>(lo, 1) * sl.y, decode_byte<CODE>(lo, 3) * sl.y);
        af[2 + ks][2 * hf] = pack_bf16(decode_byte<CODE>(hi, 0) * sh.x, decode_byte<CODE>(hi, 2) * sh.x);
        af[2 + ks][2 * hf + 1] = pack_bf16(decode_byte<CODE>(hi, 1) * sh.y, decode_byte<CODE>(hi, 3) * sh.y);
      }
    }
  };
  // the four products of k-tile i. B: all 128 rows (tokens) of the x tile, 16
  // k a step = 32 B along its rows. Waited for before the fragments change:
  // ptxas serialises wgmma whose register operands are written while
  // another is in flight, so a warpgroup never overlaps its own two phases.
  auto multiply = [&](int i) {
    const uint32_t xa = sbase + (i % TILE_STAGES) * TSTAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2 * TILE_KT / 16; ++ks)
      wgmma_m64n128k16(acc, af[ks], wg_desc(xa + ks * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
  };
  // Neighbouring warpgroups run half a step apart: the even one decodes tile
  // i and multiplies it, the odd one multiplies tile i - 1 and then decodes
  // tile i, so one's decode (ALU) runs beside the other's products (tensor
  // cores) with one barrier a k-tile.
  const bool even = ((warp >> 2) & 1) == 0;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<TILE_STAGES - 3>();
    fence_async_proxy();
    __syncthreads();  // tile i visible to all; every warpgroup is done with tile i - 2
    const int nx = i + TILE_STAGES - 2;
    if (nx < nt) load(nx % TILE_STAGES);
    cp_async_commit();
    if (even) {
      decode(i);
      multiply(i);
    } else {
      if (i > 0) multiply(i - 1);
      decode(i);
    }
  }
  if (!even && nt > 0) multiply(nt - 1);

  // thread (g, tig) of warp w holds columns c0, c0 + 1 (fragment rows g,
  // g + 8) and tokens 8 j + 2 tig, + 1 of each n8 tile j
  if (a.splits > 1) {
    const int n = n0 + c0;
    if (n < a.N) {
#pragma unroll
      for (int j = 0; j < TILE_BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + j * 8 + tig * 2 + e;
          if (m < a.M)
            *reinterpret_cast<float2 *>(a.ws + ((size_t)blockIdx.z * a.M + m) * a.N + n) =
                make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
        }
      }
    }
    return;
  }
  // bf16 output: the block lays its [128 tokens][128 columns] tile into the
  // ring's memory (free once both warpgroups' products are done; a token row
  // is 256 B, chunk c stored at c ^ (token & 7)) and stores 16 bytes a thread
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TILE_BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = j * 8 + tig * 2 + e;
      *reinterpret_cast<uint32_t *>(smem + t * (TILE_BN * 2) + (((c0 >> 3) ^ (t & 7)) << 4) +
                                    (c0 & 7) * 2) = pack_bf16(acc[4 * j + e], acc[4 * j + 2 + e]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < TILE_BM * (TILE_BN / 8) / THREADS; ++it) {
    const int idx = it * THREADS + tid, t = idx / (TILE_BN / 8), ch = idx % (TILE_BN / 8);
    const int m = m0 + t, n = n0 + ch * 8;
    if (m < a.M && n < a.N)
      *reinterpret_cast<uint4 *>(a.out + (size_t)m * a.N + n) =
          *reinterpret_cast<const uint4 *>(smem + t * (TILE_BN * 2) + ((ch ^ (t & 7)) << 4));
  }
}

template <int MT, int WARPS, int CODE>
struct LaunchRing {
  static void run(const Args &a, dim3 grid, cudaStream_t st) {
    constexpr int BYTES = ring_smem<MT, WARPS>();
    static bool done = false;
    if (!allow_smem(gw_ring_kernel<MT, WARPS, CODE>, BYTES, done)) return;  // finish() reports it
    gw_ring_kernel<MT, WARPS, CODE><<<grid, 32 * WARPS, BYTES, st>>>(a);
  }
};

template <int CODE>
void launch_tile(const Args &a, cudaStream_t st) {
  static bool done = false;
  if (!allow_smem(gw_tile_kernel<CODE>, TILE_SMEM, done)) return;
  gw_tile_kernel<CODE><<<make_grid(a, TILE_BM, TILE_BN), TILE_THREADS, TILE_SMEM, st>>>(a);
}

}  // namespace

// x bf16 [M, K] (row stride x_stride elements), packed u8 [K/2, N], scale f32
// [K/G, N], out bf16 [M, N], ws f32 [splits, M, N] (unused when splits == 1).
// bm in {16, 32, 64} with bn in {64, 128}, or bm = bn = 128; code 0 = s4,
// 1 = e2m1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tile that does not exist.
extern "C" int gw_gemm(const void *x, long long x_stride, const void *packed, const void *scale,
                       void *out, void *ws, int M, int K, int N, int G, int code, int splits,
                       int bm, int bn, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const gw::Args a = gw::make_args(x, x_stride, packed, scale, out, ws, M, K, N, G, splits);
  if (code != 0 && code != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == TILE_BM && bn == TILE_BN) {
    if (code == 0) launch_tile<0>(a, st);
    else launch_tile<1>(a, st);
  } else if (!gw::Dispatch<LaunchRing, 1, 2, 4>::run(bm, bn, code, a, st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return gw::finish(a, st);
}
