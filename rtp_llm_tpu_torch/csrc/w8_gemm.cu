// w8_gemm: y[M,N] bf16 = x[M,K] bf16 @ dequant(W[K,N]) for 8-bit weight
// codes, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package these products are XLA
// matmuls whose int8 / e4m3 -> bf16 convert is fused into the matmul operand
// (quantized_matmul's per-tensor, per-channel and groupwise branches,
// rtp_llm_tpu/quant/weight_only.py:383-409), so a step reads 1 byte per
// weight. PyTorch has no such fused form: `x @ w.to(bf16)` reads 1 B, writes
// 2 B and reads 2 B per weight. This kernel reads the codes once and
// converts them on the way to the tensor cores.
//
// Codes (CODE): 0 s8, 1 e4m3 (fp8, bias 7). Both convert to bf16 exactly.
// Scales (MODE): 0 one f32 (per tensor), 1 f32 [N] (per out channel), both
// applied to the f32 sum in the epilogue; 2 f32 [K/group, N] (fp8 per-block,
// GPTQ int8 groupwise), applied to each group's f32 partial sum (GROUPED),
// the JAX two-step form (a scale folded into a bf16 weight rounds otherwise).
//
// Two kernels behind the one entry, both walking K in k-tiles of KT = 64
// rows (the wrapper picks by rows, ops/quant_gemm8.py w8_plan):
//
//  * w8_ring_kernel, M < 128 (decode): bound by the weight bytes, 1 B an
//    element (Qwen2-7B gate-up, [3584, 37888], is 135.8 MB: 0.041 ms at
//    3.35 TB/s). A block of 4 warps owns 16, 32 or 64 rows and 128 columns,
//    each warp a 32-column slab; a ring of 3-6 stages of 8 KB of codes and
//    the rows' x slab in dynamic shared memory, filled by cp.async, keeps
//    16-40 KB of weights in flight a block, with 3-4 blocks an SM. The warps
//    multiply with mma.sync.m16n8k16: A fragments by ldmatrix, B fragments
//    decoded in registers from the bytes. K is split (f32 partials, then a
//    fixed-order reduce) where the blocks alone leave SMs idle.
//  * w8_tile_kernel, M >= 128 (prefill): bound by the products (0.56 ms at
//    989 TFLOP/s at M = 2048). gw_gemm_pipe.cu's warp-specialised form: a
//    block owns 256 (or 128) rows and 128 columns and computes the
//    transposed product y^T = W^T x^T. Warpgroup 0 copies k-tiles of x and
//    of the codes into a four-stage cp.async ring (both in the 128-byte
//    swizzle) and decodes codes tile t into bf16 slot t % 2; warpgroups 1
//    and 2 each own 64 columns and run wgmma m64n256k16 (m64n128k16 at 128
//    rows) with A the decoded slot and B the x tile, both read from shared
//    memory through descriptors. The codes lie [k][n], and so does the slot
//    ([64 k][64 n] halves, one a warpgroup): wgmma reads A M-major
//    (transposed), which bf16 allows, so the decode is a byte-to-bf16 pass
//    with no transpose, 16 codes a 16-byte load and two 16-byte stores,
//    conflict-free. Each weight is decoded once per 256 (or 128) rows, on
//    warps that issue no wgmma, beside the tensor cores.
//
// The decode, `pair`: two codes to one bf16x2, exactly, in full-rate
// operations (the first kernel converted every byte through the
// quarter-rate int-to-float pipe, and e4m3 through eight integer operations
// and a select):
//  * s8: the byte biased to b ^ 0x80 = v + 128 goes by one prmt into the
//    mantissa of the f32 2^23; one FADD subtracts 2^23 + 128, leaving v.
//    |v| <= 128 needs 8 significant bits, so the f32's high half is v in
//    bf16 exactly, and one prmt takes the two high halves.
//  * e4m3: the byte's exponent and mantissa, shifted by 4, are the low
//    exponent bits and top mantissa bits of a bf16 (value * 2^-120, a bf16
//    subnormal for an e4m3 subnormal), its sign bit the bf16's; one bf16x2
//    multiply by 2^120 restores the value (exact: a power of two, and the
//    bf16 multiply keeps subnormal inputs, which chip_smoke.py checks over
//    all 254 non-NaN codes). One prmt, a shift and two logic operations a
//    pair, and the multiply.
//
// Groupwise (mode 2): the ring keeps a second accumulator set for the group
// partial (a group a multiple of 32 rows); the tile kernel runs m64n128k16
// (128 rows), its 64 accumulators the partial and 64 more the scaled sum:
// after a tile that ends a group (a multiple of 64 rows) the MMA warpgroups,
// whose products are done (wgmma.wait_group 0), add partial x scale row, and
// the next tile's first product overwrites the partial (scale-d 0). A flush
// between the k16 steps of a tile (for 32-row groups) made ptxas serialise
// every wgmma of the kernel ("wgmma ... serialized due to ... WG.AR in
// divergent path"): 32-row groups take the ring kernel at every row count.
//
// Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py [w8-time], and
// builds of this source with the variants below, two runs, Qwen2-7B gate-up
// [3584, 37888], s8 per channel):
// the ring at 64 rows 0.087-0.092 ms (0.46-0.49 of the byte bound), at 8
// rows 0.062-0.065 (0.63-0.66); the tile kernel at 2048 rows 1.03-1.05 ms
// (0.54 of the operation bound), block-128 1.66-1.72. Builds without the
// decode (wrong products) take 0.91-0.92x (64 rows), 0.87-0.88x (2048) and
// 0.82-0.83x (block-128): at 64 rows the ring's mma.sync and ldmatrix work,
// not the decode, remains. Tried and did not pay, against the shipped build
// in turns: 4 ring stages at 64 rows (0.089-0.094 against 0.087-0.092 ms),
// no L2 prefetch hint on the ring's code copies (0.063-0.066 against
// 0.062-0.065 at 8 rows), K split in two to even the rounds at 64 rows
// (0.109-0.110 against 0.087-0.091), the code tiles by TMA (2-D tensor map,
// mbarrier; 1.073-1.082 against 1.036-1.051 ms at 2048 rows, 1.663-1.690
// against 1.662-1.709 for block-128), 6 tile stages at 128 rows
// (1.683-1.689 against 1.662-1.679). None of them is kept in this source.
//
// Planted faults for chip_smoke.py (-DW8_FAULT=n): 1 the per-channel scale
// of the neighbouring column, 2 a group's partial scaled by the next group's
// scale row, 3 e4m3 decoded with its exponent off by one, 4 the tile
// kernel's MMA warpgroups read the decoded slot of the wrong parity, 5 the
// tile kernel's grouped flush skips a split's first group boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gw_common.cuh"

#ifndef W8_FAULT
#define W8_FAULT 0
#endif

namespace w8 {
// internal linkage: the faulty builds are libraries of their own in the same
// process, and a launcher's static flag (the shared-memory attribute set)
// must not be merged across them
namespace {

constexpr int KT = 64;   // k rows of a k-tile
constexpr int BN = 128;  // columns of a block

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

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The ring's code copies ask L2 to fetch 128-byte sectors (a block reads a
// 128-byte row segment of the codes).
__device__ __forceinline__ void cp16_codes(uint32_t dst, const void *src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

// bf16x2 {low: code in byte i of a, high: code in byte j of b}, exactly.
template <int CODE>
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b, int i, int j) {
  if constexpr (CODE == 0) {
    const float fa = __uint_as_float(__byte_perm(a ^ 0x80808080u, 0x4B000000u, 0x7440u | i));
    const float fb = __uint_as_float(__byte_perm(b ^ 0x80808080u, 0x4B000000u, 0x7440u | j));
    return __byte_perm(__float_as_uint(fa - 8388736.0f), __float_as_uint(fb - 8388736.0f),
                       0x7632u);
  } else {
    // each byte twice in its half: the low copy gives exponent and mantissa
    // (shifted into bits 4..10), the high copy's top bit the sign (bit 15)
    const uint32_t p = __byte_perm(a, b, i | (i << 4) | ((4 + j) << 8) | ((4 + j) << 12));
    const uint32_t r = ((p << 4) & 0x07F007F0u) | (p & 0x80008000u);
#if W8_FAULT == 3
    const uint32_t two_pow = 0x7C007C00u;  // 2^121: the exponent off by one
#else
    const uint32_t two_pow = 0x7B807B80u;  // 2^120 in bf16x2
#endif
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(r), "r"(two_pow), "r"(0x80008000u));
    return d;
  }
}

// ---------------------------------------------------------------- M < 128

// One ring stage: codes [64][128 + 16] u8 (the pitch puts a warp's four
// row pairs on all banks) | x [BM][64 + 8] bf16 (a pitch of 144 B keeps
// ldmatrix conflict-free). Stages by rows (6, 5, 3): 69, 69 and 55 KB a
// block, three, three and four blocks an SM.
template <int MT>
struct Ring {
  static constexpr int BM = 16 * MT;
  static constexpr int STAGES = MT == 1 ? 6 : MT == 2 ? 5 : 3;
  static constexpr int WP = BN + 16;  // codes row pitch, bytes
  static constexpr int XP = KT + 8;   // x row pitch, bf16
  static constexpr int X_OFF = KT * WP;
  static constexpr int STAGE = X_OFF + BM * XP * 2;
  static constexpr int SMEM = STAGES * STAGE;
};

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

// The B fragment of mma.m16n8k16 wants, per thread, two consecutive k rows
// of one column. A 32-bit word of a codes row holds four columns: thread
// (g, tig) reads the words at column 4 g of its slab from rows 2 tig,
// 2 tig + 1, 2 tig + 8, 2 tig + 9 and deals byte j of each word to n8 tile
// j (the dealing of gw_common.cuh). Column n of tile j is slab column
// 4 n + j, so a thread's accumulators (tile j, columns 2 tig, 2 tig + 1) are
// the 8 consecutive slab columns 8 tig .. 8 tig + 7: one 16-byte store a row.
template <int MT, int CODE, bool GROUPED>
__global__ void __launch_bounds__(128) w8_ring_kernel(const Args a) {
  using R = Ring<MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * R::BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int t0 = split * a.tiles_per_split, t1 = min(t0 + a.tiles_per_split, a.K / KT);
  const int slab = warp * 32;
  const uint32_t sbase = smem_addr(smem);

  // what this thread copies each k-tile, from running pointers: code chunk
  // c_c of rows c_r + 16 j (j < 4), x chunk c_c of rows c_r + 16 j (j < MT).
  // Columns past N and rows past M are zero-filled.
  const int c_c = tid & 7, c_r = tid >> 3;
  const bool w_ok = n0 + c_c * 16 < a.N;
  const uint8_t *wp = w_ok ? a.w + ((size_t)t0 * KT + c_r) * a.N + n0 + c_c * 16 : a.w;
  const size_t w_step = w_ok ? (size_t)16 * a.N : 0;
  const __nv_bfloat16 *xp = a.x + (size_t)(m0 + c_r) * a.lda + (size_t)t0 * KT + c_c * 8;
  const size_t x_step = (size_t)16 * a.lda;
  auto load = [&](int stage) {
    const uint32_t st = sbase + stage * R::STAGE;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cp16_codes(st + (c_r + 16 * j) * R::WP + c_c * 16, wp + j * w_step, w_ok);
    wp += 4 * w_step;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const bool ok = m0 + c_r + 16 * j < a.M;
      gw::cp16(st + R::X_OFF + ((c_r + 16 * j) * R::XP + c_c * 8) * 2, ok ? xp + j * x_step : a.x,
               ok);
    }
    xp += KT;
  };

  float acc[MT][4][4] = {};
  float part[GROUPED ? MT : 1][4][4] = {};
  int left = a.group, grp = t0 * KT / a.group;  // rows to the group's end, the group

  const int nt = t1 - t0;
  // one commit group per ring slot, empty past the end, so that
  // wait_group<STAGES - 2> always means "tile i has landed"
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < nt) load(s);
    gw::cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    gw::cp_async_wait<R::STAGES - 2>();
    __syncthreads();  // tile i visible to all; everyone is done with tile i - 1
    if (i + R::STAGES - 1 < nt) load((i + R::STAGES - 1) % R::STAGES);
    gw::cp_async_commit();

    const unsigned char *stage = smem + (i % R::STAGES) * R::STAGE;
    const uint32_t sx = sbase + (i % R::STAGES) * R::STAGE + R::X_OFF;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        gw::ldsm4(af[mt], sx + ((mt * 16 + (lane & 15)) * R::XP + kk + (lane >> 4) * 8) * 2);
      const unsigned char *wr = stage + (kk + 2 * tig) * R::WP + slab + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t *>(wr);
      const uint32_t w1 = *reinterpret_cast<const uint32_t *>(wr + R::WP);
      const uint32_t w2 = *reinterpret_cast<const uint32_t *>(wr + 8 * R::WP);
      const uint32_t w3 = *reinterpret_cast<const uint32_t *>(wr + 9 * R::WP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b[2] = {pair<CODE>(w0, w1, j, j), pair<CODE>(w2, w3, j, j)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (GROUPED)
            gw::mma_bf16(part[mt][j], af[mt], b);
          else
            gw::mma_bf16(acc[mt][j], af[mt], b);
        }
      }
      if constexpr (GROUPED) {
        if (kk & 16) {  // 32 rows done; a group is a multiple of 32 rows
          left -= 32;
          if (left == 0) {
            int sg = grp;
#if W8_FAULT == 2
            sg = (grp + 1) % (a.K / a.group);  // the next group's scale row
#endif
            const float *srow = a.s + (size_t)sg * a.N;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = n0 + slab + 8 * tig + j;
                flush_group(acc[mt][j], part[mt][j], srow, c, c + 4, a.N);
              }
            left = a.group;
            ++grp;
          }
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

// ---------------------------------------------------------------- M >= 128

// Shared memory of a block, from a 1024-byte aligned base:
//   STAGES x { x tile [BM rows][64 k] bf16, K-major | codes [64 k][128 n] u8 },
//                both in the 128-byte swizzle: 16-byte chunk c of row r at c ^ (r & 7)
//   2 decoded slots, each 2 halves [64 k][64 n] bf16, N-major, 128-byte swizzle
// BM = 256: 4 x 40 KB + 32 KB = 193 KB, one block an SM.
constexpr int T_THREADS = 384;
constexpr int T_CODES = KT * BN;     // 8 KB
constexpr int T_HALF = KT * 64 * 2;  // 8 KB: one MMA warpgroup's 64 columns
constexpr int T_SLOT = 2 * T_HALF;
// named barriers: 0 is __syncthreads
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_DECODE = 5, BAR_MMA = 6;
// register budgets: 88 + 2 x 208 = 3 x 168, the launch's share
constexpr int DECODE_REGS = 88, MMA_REGS = 208;

template <int BM>
struct Tile {
  static constexpr int X_BYTES = BM * 128;
  static constexpr int STAGE = X_BYTES + T_CODES;  // a multiple of 1 KB
  // ring stages: 256 rows fill the shared memory at 4 (193 KB)
  static constexpr int STAGES = 4;
  static constexpr int SLOTS_OFF = STAGES * STAGE;
  static constexpr int SMEM = SLOTS_OFF + 2 * T_SLOT + 1024;  // + alignment slack
  static_assert(BM * BN * 2 <= SLOTS_OFF, "the output tile reuses the ring");
};

template <int BM, int CODE, bool GROUPED>
__global__ void __launch_bounds__(T_THREADS, 1) w8_tile_kernel(const Args a) {
  using T = Tile<BM>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char *smem = smem_raw + (sbase - raw);
  const uint32_t slots = sbase + T::SLOTS_OFF;
  const int tid = threadIdx.x;
  // the warpgroup, read back from lane 0 so that ptxas sees it uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int t0 = blockIdx.z * a.tiles_per_split;
  const int nt = min(a.tiles_per_split, a.K / KT - t0);

  if (wg == 0) {
    // ======================== decode warpgroup: copies, decode, hand-off
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DECODE_REGS));
    // ---- what this thread copies each k-tile, from running pointers to
    // constant destinations: chunk c_c of x rows c_r + 16 j (j < BM / 16)
    // and of code rows c_r + 16 j (j < 4). (c_r + 16 j) & 7 == c_r & 7, so
    // one swizzled offset serves every j. Rows past M and columns past N are
    // zero-filled.
    constexpr int XJ = BM / 16;
    const int c_c = tid & 7, c_r = tid >> 3;
    const uint32_t dst = c_r * 128 + ((c_c ^ (c_r & 7)) << 4);
    const __nv_bfloat16 *xp = a.x + (size_t)(m0 + c_r) * a.lda + (size_t)t0 * KT + c_c * 8;
    const size_t x_step = (size_t)16 * a.lda;
    uint32_t x_ok = 0;
#pragma unroll
    for (int j = 0; j < XJ; ++j) x_ok |= (m0 + c_r + 16 * j < a.M ? 1u : 0u) << j;
    const bool w_ok = n0 + c_c * 16 < a.N;
    const uint8_t *wp = w_ok ? a.w + ((size_t)t0 * KT + c_r) * a.N + n0 + c_c * 16 : a.w;
    const size_t w_step = w_ok ? (size_t)16 * a.N : 0;
    auto load = [&](int stage) {
      const uint32_t st = sbase + stage * T::STAGE;
#pragma unroll
      for (int j = 0; j < XJ; ++j) {
        const bool ok = (x_ok >> j) & 1u;
        gw::cp16(st + dst + j * 2048, ok ? xp + j * x_step : a.x, ok);
      }
      xp += KT;
#pragma unroll
      for (int j = 0; j < 4; ++j) gw::cp16(st + T::X_BYTES + dst + j * 2048, wp + j * w_step, w_ok);
      wp += 4 * w_step;
    };

    // ---- what this thread decodes: code row dr, 16-code chunks dc + 2 i
    // (columns 16 c .. 16 c + 15), each to two 8-column bf16 chunks of the
    // slot's half c / 4. Eight neighbouring threads take eight neighbouring
    // rows of one chunk: loads and stores are conflict-free.
    const int dr = tid & 63, dc = tid >> 6;
    auto decode = [&](int t) {
      const unsigned char *codes = smem + (t % T::STAGES) * T::STAGE + T::X_BYTES + dr * 128;
      const uint32_t row = slots + (t & 1) * T_SLOT + dr * 128;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = dc + 2 * i;
        const uint4 v = *reinterpret_cast<const uint4 *>(codes + ((c ^ (dr & 7)) << 4));
        const uint32_t half = row + (c >> 2) * T_HALF;
        const int ch = 2 * (c & 3);
        gw::st_shared16(half + ((ch ^ (dr & 7)) << 4), pair<CODE>(v.x, v.x, 0, 1),
                        pair<CODE>(v.x, v.x, 2, 3), pair<CODE>(v.y, v.y, 0, 1),
                        pair<CODE>(v.y, v.y, 2, 3));
        gw::st_shared16(half + (((ch + 1) ^ (dr & 7)) << 4), pair<CODE>(v.z, v.z, 0, 1),
                        pair<CODE>(v.z, v.z, 2, 3), pair<CODE>(v.w, v.w, 0, 1),
                        pair<CODE>(v.w, v.w, 2, 3));
      }
    };

    for (int s = 0; s < T::STAGES - 2; ++s) {
      if (s < nt) load(s);
      gw::cp_async_commit();
    }
    for (int t = 0; t < nt; ++t) {
      // the products of tile t - 2 are done: slot t % 2 and the ring stage
      // of tile t - 2 (= that of tile t + STAGES - 2) are free
      if (t >= 2) gw::bar_sync(BAR_EMPTY + (t & 1), T_THREADS);
      if (t + T::STAGES - 2 < nt) load((t + T::STAGES - 2) % T::STAGES);
      gw::cp_async_commit();
      gw::cp_async_wait<T::STAGES - 2>();  // this thread's copies of tile t have landed
      gw::bar_sync(BAR_DECODE, 128);  // everyone's
      decode(t);
      gw::fence_async_proxy();  // the x tile and the decoded slot, for wgmma's reads
      gw::bar_arrive(BAR_FULL + (t & 1), T_THREADS);
    }
    return;
  }

  // ========================== MMA warpgroups: 64 output columns x BM rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
  const int h = wg - 1;
  // thread (g, tig) of warp wi holds block columns c and c + 8 (rows g, g + 8
  // of its warp's 16) and tokens 8 j + 2 tig, + 1 of each n8 tile j:
  // accumulator 4 j + 2 r + e is column c + 8 r, token 8 j + 2 tig + e
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3, wi = (tid >> 5) & 3;
  const int c = 64 * h + 16 * wi + g;
  float acc[BM / 2];  // the sum (modes 0, 1) or the group's partial (mode 2)
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  float tot[GROUPED ? BM / 2 : 1];  // mode 2: the scaled sum
#pragma unroll
  for (int i = 0; i < (GROUPED ? BM / 2 : 1); ++i) tot[i] = 0.f;
  int grp = t0 * KT / a.group;   // the group
  float s_lo = 0.f, s_hi = 0.f;  // its scales of columns c, c + 8
  auto scales = [&]() {
    int sg = grp;
#if W8_FAULT == 2
    sg = (grp + 1) % (a.K / a.group);  // the next group's scale row
#endif
    const float *srow = a.s + (size_t)sg * a.N + n0 + c;
    s_lo = n0 + c < a.N ? srow[0] : 0.f;
    s_hi = n0 + c + 8 < a.N ? srow[8] : 0.f;
  };
  if constexpr (GROUPED) scales();
  int acc_in = 1;  // 0: the tile's first product overwrites the partial

  for (int t = 0; t < nt; ++t) {
    gw::bar_sync(BAR_FULL + (t & 1), T_THREADS);  // decoded slot t % 2 and x tile t are ready
    const uint32_t xa = sbase + (t % T::STAGES) * T::STAGE;
#if W8_FAULT == 4
    const uint32_t wa = slots + ((t + 1) & 1) * T_SLOT + h * T_HALF;
#else
    const uint32_t wa = slots + (t & 1) * T_SLOT + h * T_HALF;
#endif
    gw::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      // A: k rows 16 ks .. 16 ks + 15 of the half, M-major: 8-row groups
      // 1024 B apart; B: 32 bytes further along each x row
      gw::wgmma_ss<1>(acc, gw::wg_desc(wa + ks * 2048, T_HALF, 1024),
                      gw::wg_desc(xa + ks * 32, 16, 1024), ks == 0 ? acc_in : 1);
    gw::wgmma_commit();
    gw::wgmma_wait<0>();
    if constexpr (GROUPED) {
      // a group is a multiple of 64 rows here: the flush comes after the
      // tile's products are done, outside the wgmma sequence
      acc_in = 1;
      if (((t0 + t + 1) * KT) % a.group == 0) {
#if W8_FAULT == 5
        const bool skip = grp == t0 * KT / a.group;  // the split's first group end
#else
        constexpr bool skip = false;
#endif
        if (!skip) {
#pragma unroll
          for (int i = 0; i < BM / 2; ++i) tot[i] += acc[i] * ((i & 2) ? s_hi : s_lo);
          acc_in = 0;
        }
        ++grp;
        if (grp < a.K / a.group) scales();
      }
    }
    if (t + 2 < nt) gw::bar_arrive(BAR_EMPTY + (t & 1), T_THREADS);
  }

  auto res = [&](int i) {
    if constexpr (GROUPED)
      return tot[i];
    else
      return acc[i];
  };
  if (a.ws) {  // this split's f32 partial, unscaled in modes 0 and 1
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * tig + e;
        if (m >= a.M) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = n0 + c + 8 * r;
          if (n < a.N) a.ws[((size_t)blockIdx.z * a.M + m) * a.N + n] = res(4 * j + 2 * r + e);
        }
      }
    return;
  }
  float cs[2] = {1.f, 1.f};
  if (!GROUPED) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int n = n0 + c + 8 * r;
#if W8_FAULT == 1
      n ^= 1;  // the neighbouring column's scale
#endif
      cs[r] = a.mode == 0 ? a.s[0] : n < a.N ? a.s[n] : 0.f;
    }
  }
  // bf16 output: the [BM tokens][128 columns] tile goes into the ring's memory
  // (free once both warpgroups' products are done; a token row is 256 B,
  // chunk ch stored at ch ^ (token & 7)) and leaves in 16-byte stores
  gw::bar_sync(BAR_MMA, 256);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tk = 8 * j + 2 * tig + e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = c + 8 * r;
        *reinterpret_cast<__nv_bfloat16 *>(smem + tk * 256 + (((col >> 3) ^ (tk & 7)) << 4) +
                                           (col & 7) * 2) =
            __float2bfloat16_rn(res(4 * j + 2 * r + e) * cs[r]);
      }
    }
  gw::bar_sync(BAR_MMA, 256);
  for (int idx = tid - 128; idx < BM * 16; idx += 256) {
    const int tk = idx >> 4, ch = idx & 15;
    const int m = m0 + tk, n = n0 + ch * 8;
    if (m < a.M && n < a.N)
      *reinterpret_cast<uint4 *>(a.out + (size_t)m * a.N + n) =
          *reinterpret_cast<const uint4 *>(smem + tk * 256 + ((ch ^ (tk & 7)) << 4));
  }
}

// ---------------------------------------------------------------- host side

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

inline dim3 grid_of(const Args &a, int bm, int splits) {
  // row blocks fastest: the blocks that read one column tile run together
  return dim3((a.M + bm - 1) / bm, (a.N + BN - 1) / BN, splits);
}

template <int MT, int CODE, bool GROUPED>
void launch_ring(const Args &a, int splits, cudaStream_t st) {
  static bool done = false;
  if (!gw::allow_smem(w8_ring_kernel<MT, CODE, GROUPED>, Ring<MT>::SMEM, done)) return;
  w8_ring_kernel<MT, CODE, GROUPED>
      <<<grid_of(a, 16 * MT, splits), 128, Ring<MT>::SMEM, st>>>(a);
}

template <int BM, int CODE, bool GROUPED>
void launch_tile(const Args &a, int splits, cudaStream_t st) {
  static bool done = false;
  if (!gw::allow_smem(w8_tile_kernel<BM, CODE, GROUPED>, Tile<BM>::SMEM, done)) return;
  w8_tile_kernel<BM, CODE, GROUPED><<<grid_of(a, BM, splits), T_THREADS, Tile<BM>::SMEM, st>>>(a);
}

// false: no such tile; a refused launch shows in cudaGetLastError()
template <int CODE, bool GROUPED>
bool dispatch(int bm, const Args &a, int splits, cudaStream_t st) {
  switch (bm) {
    case 16: launch_ring<1, CODE, GROUPED>(a, splits, st); return true;
    case 32: launch_ring<2, CODE, GROUPED>(a, splits, st); return true;
    case 64: launch_ring<4, CODE, GROUPED>(a, splits, st); return true;
    case 128: launch_tile<128, CODE, GROUPED>(a, splits, st); return true;
    case 256:
      if constexpr (GROUPED) {
        return false;  // the partial and the sum would need 256 registers a thread
      } else {
        launch_tile<256, CODE, false>(a, splits, st);
        return true;
      }
    default: return false;
  }
}

}  // namespace
}  // namespace w8

// y = x @ dequant(w). x [M, K] bf16 (row stride lda), w [K, N] s8 (code 0)
// or e4m3 (code 1), scale by mode (0 per tensor, 1 per channel, 2 groupwise
// [K/group, N], group % 32 == 0); K % 64 == 0, N % 16 == 0; ws [splits, M, N]
// f32 when splits > 1, each split tiles_per_split 64-row k-tiles. bm in {16,
// 32, 64} runs the ring kernel, {128, 256} the tile kernel (mode 2: 128, and
// group % 64 == 0).
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a tile that does not exist.
extern "C" int w8_gemm(const void *x, long long lda, const void *w, int code, const void *scale,
                       int mode, int group, void *out, void *ws, int M, int K, int N, int splits,
                       int tiles_per_split, int bm, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  w8::Args a{static_cast<const __nv_bfloat16 *>(x), lda, static_cast<const uint8_t *>(w),
             static_cast<const float *>(scale), static_cast<__nv_bfloat16 *>(out),
             splits > 1 ? static_cast<float *>(ws) : nullptr, M, K, N, mode, group,
             tiles_per_split};
  const bool grouped = mode == 2;
  if (grouped && bm >= 128 && group % w8::KT) return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = code == 0 ? (grouped ? w8::dispatch<0, true>(bm, a, splits, st)
                                       : w8::dispatch<0, false>(bm, a, splits, st))
                  : code == 1 ? (grouped ? w8::dispatch<1, true>(bm, a, splits, st)
                                         : w8::dispatch<1, false>(bm, a, splits, st))
                              : false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  w8::w8_reduce_kernel<<<264, 256, 0, st>>>(a, splits);
  return static_cast<int>(cudaGetLastError());
}
