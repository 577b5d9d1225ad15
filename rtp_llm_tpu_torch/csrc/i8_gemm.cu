// i8_gemm: y[M,N] bf16 = (sum over groups g of int32(xq_g . W_g) * scale[g, n])
// * xs[m], the integer contraction of W8A8 and W4A8, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package w8a8_matmul and w4a8_matmul
// (rtp_llm_tpu/quant/weight_only.py:166-207) are XLA einsums over s8 x s8
// operands with int32 accumulation. Here xq [M, K] s8 are the per-token
// activation codes (act_quant.cu) with their f32 scales xs [M]; W [K, N] s8
// holds int8 codes (W8A8, scale [1, N]: one group spanning K) or int4 values
// in [-7, 7] (W4A8, scale [K/group, N]). The weight keeps the JAX layout
// [K, N] (a layer's view of the [L, K, N] stack, never copied).
//
// Two kernels behind the one entry (the wrapper picks by rows,
// ops/quant_gemm8.py plan), after w8_gemm.cu's pair:
//
//  * i8_ring_kernel, M < 128 (W4A8 decode): bound by the weight bytes, 1 B an
//    element (Qwen2-7B gate-up, [3584, 37888], is 135.8 MB: 0.041 ms at
//    3.35 TB/s). A block of 4 warps owns 16, 32 or 64 rows and 128 columns,
//    each warp a 32-column slab; a ring of 4-6 stages of 64-row k-tiles (8 KB
//    of codes and the rows' xq slab) in dynamic shared memory, filled by
//    cp.async with the L2 prefetch hint on the codes, three or four blocks an
//    SM. The warps multiply with mma.sync.m16n8k32 s8 x s8 -> s32: A
//    fragments by ldmatrix; a B fragment wants four consecutive k rows of one
//    column in a register, so each thread reads the 32-bit words at column
//    4 g of its slab from rows 4 tig .. 4 tig + 3 (and 16 + those) and a 4x4
//    byte transpose (transpose4, six prmt) turns them into one k-quad a
//    column; column 4 g + j goes to n8 tile j as in w8_gemm.cu. A code row's
//    16-byte chunk c lies at c ^ 2 ((k >> 2) & 3), which puts those reads of
//    a warp on 32 banks. K is split (f32 partials, then a fixed-order reduce)
//    where the blocks alone leave SMs idle.
//  * i8_tile_kernel, M >= 128 (prefill): bound by the products (a Qwen2-7B
//    gate-up at M = 2048 is 556 GOP: 0.28 ms at 1979 TOP/s int8 dense).
//    Warp-specialised: a block owns 256 (or 128) rows and 128 columns and
//    computes y^T = W^T xq^T, the 64 columns of a warpgroup wgmma's M and the
//    rows its N. wgmma takes 8-bit operands from shared memory K-major only
//    (the transpose flags exist for 16-bit types alone): xq [M, K] is, the
//    codes [K, N] are not. Warpgroup 0, the producer, copies k-tiles of 128
//    k values (one 128-byte row of each operand) of xq (in the 128-byte
//    swizzle) and of the codes into a four-stage cp.async ring, then turns
//    the codes of tile t into the K-major slot t % 2: [128 n][128 k] as two
//    [64 n][128 k] halves, one a warpgroup, in the 128-byte swizzle. A
//    producer thread reads one 32-bit word (4 columns) from 16 code rows,
//    transposes it by transpose4 into four 16-byte chunks (16 k of one
//    column) and stores them: each byte is transposed once per 256 (or 128)
//    rows, on warps that issue no wgmma. The raw rows lie with chunk c at
//    c ^ ((k >> 4) & 7) so that a warp's 32 word reads (8 k-chunks x 4
//    words) and each quarter-warp's 16-byte stores (8 k-chunks of one
//    column) are conflict-free. Warpgroups 1 and 2 run wgmma m64n256k32
//    (m64n128k32 at 128 rows) s8 x s8 -> s32 on the slot and the xq tile,
//    both through descriptors, keeping one tile's products in flight. The
//    int32 sum turns into f32 once, in the epilogue, times the column's
//    scale and the row's xs.
//
// Groups (W4A8): the int32 partial of a group becomes f32 times its scale
// row and is added to an f32 sum where the group ends. The ring flushes at
// the end of any 32-row step; the tile kernel holds a partial and a sum,
// 128 registers a thread at 128 rows (256 rows would need 256), and flushes
// after a tile that ends a group (a multiple of 128 rows), outside the wgmma
// sequence; the next tile's first product overwrites the partial (scale-d
// 0). Groups that are not a multiple of 128 rows take the ring at every row
// count. All sums are exact up to the one conversion a group.
//
// Planted faults for chip_smoke.py (-DI8_FAULT=n): 1 a group's int32 partial
// is not reset after its flush (both kernels), 2 the tile kernel's wgmma
// warpgroups read the slot of the wrong parity, 3 the B operand read one
// k-quad off (the ring's fragment rows, the tile kernel's slot chunks), 4 the
// tile kernel's grouped flush skips a split's first group end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gw_common.cuh"

#ifndef I8_FAULT
#define I8_FAULT 0
#endif

namespace i8 {
// internal linkage: the faulty builds are libraries of their own in the same
// process, and a launcher's static flag (the shared-memory attribute set)
// must not be merged across them
namespace {

constexpr int BN = 128;  // columns of a block

struct Args {
  const int8_t *xq;    // [M, K]
  const float *xs;     // [M]
  const int8_t *w;     // [K, N]
  const float *s;      // [K/group, N]
  __nv_bfloat16 *out;  // [M, N]
  float *ws;           // [splits, M, N] when splits > 1, else null
  int M, K, N, group, tiles_per_split;
};

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// ---------------------------------------------------------------- M < 128

constexpr int RKT = 64;  // k rows of a ring k-tile

// One ring stage: codes [64][128] u8, chunk c of row k at c ^ 2 ((k >> 2) & 3)
// | xq [BM][64 + 16] (a pitch of 80 B keeps ldmatrix conflict-free). Stages
// by rows (6, 5, 4): 55, 53 and 52 KB a block.
template <int MT>
struct Ring {
  static constexpr int BM = 16 * MT;
  static constexpr int STAGES = MT == 1 ? 6 : MT == 2 ? 5 : 4;
  static constexpr int XP = RKT + 16;  // xq row pitch, bytes
  static constexpr int X_OFF = RKT * BN;
  static constexpr int STAGE = X_OFF + BM * XP;
  static constexpr int SMEM = STAGES * STAGE;
};

// The ring's code copies ask L2 to fetch 128-byte sectors (a block reads a
// 128-byte row segment of the codes).
__device__ __forceinline__ void cp16_codes(uint32_t dst, const void *src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Thread (g, tig) holds, per row tile and n8 tile j, the sums of rows g and
// g + 8 at slab columns 8 tig + j and 8 tig + 4 + j: one 16-byte store a row.
template <int MT, bool GROUPED>
__global__ void __launch_bounds__(128) i8_ring_kernel(const Args a) {
  using R = Ring<MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * R::BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int t0 = split * a.tiles_per_split, t1 = min(t0 + a.tiles_per_split, a.K / RKT);
  const int slab = warp * 32;
  const uint32_t sbase = smem_addr(smem);

  // what this thread copies each k-tile, from running pointers: code chunk
  // c_c of rows c_r + 16 j (j < 4; one chunk key for all four), xq chunk x_c
  // of rows x_r + 32 j. Columns past N and rows past M are zero-filled.
  const int c_c = tid & 7, c_r = tid >> 3;
  const bool w_ok = n0 + c_c * 16 < a.N;
  const int8_t *wp = w_ok ? a.w + ((size_t)t0 * RKT + c_r) * a.N + n0 + c_c * 16 : a.w;
  const size_t w_step = w_ok ? (size_t)16 * a.N : 0;
  const uint32_t w_dst = c_r * BN + ((c_c ^ (((c_r >> 2) & 3) << 1)) << 4);
  const int x_c = tid & 3, x_r = tid >> 2;
  const int8_t *xp = a.xq + (size_t)(m0 + x_r) * a.K + (size_t)t0 * RKT + x_c * 16;
  auto load = [&](int stage) {
    const uint32_t st = sbase + stage * R::STAGE;
#pragma unroll
    for (int j = 0; j < 4; ++j) cp16_codes(st + w_dst + j * 16 * BN, wp + j * w_step, w_ok);
    wp += 4 * w_step;
#pragma unroll
    for (int j = 0; j < (R::BM + 31) / 32; ++j) {
      const int r = x_r + 32 * j;
      if (r < R::BM) {
        const bool ok = m0 + r < a.M;
        gw::cp16(st + R::X_OFF + r * R::XP + x_c * 16, ok ? xp + (size_t)32 * j * a.K : a.xq, ok);
      }
    }
    xp += RKT;
  };

  // B reads: rows 4 quad + r (+ 16) of a k32 step, the word at slab column 4 g
#if I8_FAULT == 3
  const int quad = (tig + 1) & 3;  // the next k-quad's rows
#else
  const int quad = tig;
#endif
  const int b_off = (4 * quad) * BN + ((((slab >> 4) + (g >> 2)) ^ (quad << 1)) << 4) + (g & 3) * 4;

  int part[MT][4][4] = {};
  float acc[GROUPED ? MT : 1][4][4] = {};
  int left = a.group, grp = t0 * RKT / a.group;  // rows to the group's end, the group

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
    for (int kk = 0; kk < RKT; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        gw::ldsm4(af[mt], sx + (mt * 16 + (lane & 15)) * R::XP + kk + (lane >> 4) * 16);
      uint32_t lo[4], hi[4], blo[4], bhi[4];
      const unsigned char *wr = stage + kk * BN + b_off;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        lo[r] = *reinterpret_cast<const uint32_t *>(wr + r * BN);
        hi[r] = *reinterpret_cast<const uint32_t *>(wr + (16 + r) * BN);
      }
      transpose4(blo, lo);
      transpose4(bhi, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b[2] = {blo[j], bhi[j]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(part[mt][j], af[mt], b);
      }
      if constexpr (GROUPED) {
        left -= 32;
        if (left == 0) {  // a group ends: its partial, times its scale row, into the sum
          const float *srow = a.s + (size_t)grp * a.N;
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
          left = a.group;
          ++grp;
        }
      }
    }
  }
  gw::cp_async_wait<0>();

  // epilogue: one group's int32 sum times the column scale (W8A8), or the
  // groups' f32 sum; times the row's xs unless the split's partial goes to
  // the workspace
  const int c8 = n0 + slab + 8 * tig;
  if (c8 >= a.N) return;
  float cs[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) cs[q] = GROUPED ? 1.f : a.s[c8 + q];
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
        if constexpr (GROUPED) {
          v[j] = acc[mt][j][2 * h] * rs;
          v[4 + j] = acc[mt][j][2 * h + 1] * rs;
        } else {
          v[j] = static_cast<float>(part[mt][j][2 * h]) * cs[j] * rs;
          v[4 + j] = static_cast<float>(part[mt][j][2 * h + 1]) * cs[4 + j] * rs;
        }
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

// wgmma m64nNk32 s8 x s8 -> s32, A and B K-major in shared memory through
// descriptors; scale_d 0 overwrites the accumulators.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


// Shared memory of a block, from a 1024-byte aligned base:
//   STAGES x { xq tile [BM rows][128 k], 128-byte swizzle: 16-byte chunk c of
//              row r at c ^ (r & 7) | codes [128 k][128 n], chunk c of row k
//              at c ^ ((k >> 4) & 7) }
//   2 slots, each 2 halves [64 n][128 k], K-major, 128-byte swizzle
// BM = 256: 4 x 48 KB + 32 KB = 225 KB, one block an SM.
constexpr int TKT = 128;  // k values of a tile k-tile
constexpr int T_THREADS = 384;
constexpr int T_CODES = TKT * BN;  // 16 KB
constexpr int T_HALF = 64 * TKT;   // 8 KB: one MMA warpgroup's 64 columns
constexpr int T_SLOT = 2 * T_HALF;
// named barriers: 0 is __syncthreads
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PRODUCE = 5, BAR_MMA = 6;
// register budgets: 88 + 2 x 208 = 3 x 168, the launch's share
constexpr int PRODUCER_REGS = 88, MMA_REGS = 208;

template <int BM>
struct Tile {
  static constexpr int X_BYTES = BM * TKT;
  static constexpr int STAGE = X_BYTES + T_CODES;  // a multiple of 1 KB
  static constexpr int STAGES = 4;
  static constexpr int SLOTS_OFF = STAGES * STAGE;
  static constexpr int SMEM = SLOTS_OFF + 2 * T_SLOT + 1024;  // + alignment slack
  static_assert(BM * BN * 2 <= SLOTS_OFF, "the output tile reuses the ring");
};

// Tile t's products of MMA warpgroup h: four k32 steps, A 32 k of the
// slot half's column rows, B of the xq tile's token rows, both K-major (rows
// 128 B apart, 8-row groups 1024 B apart); scale_d 0 overwrites acc.
template <class T, int R>
__device__ __forceinline__ void tile_mma(int (&acc)[R], uint32_t sbase, uint32_t slots, int t,
                                         int h, int scale_d) {
  const uint32_t xa = sbase + (t % T::STAGES) * T::STAGE;
#if I8_FAULT == 2
  const uint32_t wa = slots + ((t + 1) & 1) * T_SLOT + h * T_HALF;  // the other slot
#else
  const uint32_t wa = slots + (t & 1) * T_SLOT + h * T_HALF;
#endif
  gw::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_s8(acc, gw::wg_desc(wa + ks * 32, 16, 1024), gw::wg_desc(xa + ks * 32, 16, 1024),
             ks == 0 ? scale_d : 1);
  gw::wgmma_commit();
}

template <int BM, bool GROUPED>
__global__ void __launch_bounds__(T_THREADS, 1) i8_tile_kernel(const Args a) {
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
  const int nt = min(a.tiles_per_split, a.K / TKT - t0);

  if (wg == 0) {
    // ======================== producer warpgroup: copies, transpose, hand-off
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // ---- what this thread copies each k-tile, from running pointers to
    // constant destinations: chunk c_c of xq rows c_r + 16 j (j < BM / 16;
    // (c_r + 16 j) & 7 == c_r & 7, one swizzled offset for every j) and of
    // code rows c_r + 16 j (j < 8; the chunk key of row c_r + 16 j is j).
    // Rows past M and columns past N are zero-filled.
    constexpr int XJ = BM / 16;
    const int c_c = tid & 7, c_r = tid >> 3;
    const uint32_t x_dst = c_r * 128 + ((c_c ^ (c_r & 7)) << 4);
    const int8_t *xp = a.xq + (size_t)(m0 + c_r) * a.K + (size_t)t0 * TKT + c_c * 16;
    const size_t x_step = (size_t)16 * a.K;
    uint32_t x_ok = 0;
#pragma unroll
    for (int j = 0; j < XJ; ++j) x_ok |= (m0 + c_r + 16 * j < a.M ? 1u : 0u) << j;
    const bool w_ok = n0 + c_c * 16 < a.N;
    const int8_t *wp = w_ok ? a.w + ((size_t)t0 * TKT + c_r) * a.N + n0 + c_c * 16 : a.w;
    const size_t w_step = w_ok ? (size_t)16 * a.N : 0;
    auto load = [&](int stage) {
      const uint32_t st = sbase + stage * T::STAGE;
#pragma unroll
      for (int j = 0; j < XJ; ++j) {
        const bool ok = (x_ok >> j) & 1u;
        gw::cp16(st + x_dst + j * 2048, ok ? xp + j * x_step : a.xq, ok);
      }
      xp += TKT;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        gw::cp16(st + T::X_BYTES + (c_r + 16 * j) * 128 + ((c_c ^ j) << 4), wp + j * w_step, w_ok);
      wp += 8 * w_step;
    };

    // ---- what this thread transposes: lane (c = lane & 7, qo = lane >> 3)
    // of warp wq takes k-chunk c (code rows 16 c .. 16 c + 15) of words
    // q = 4 Q + qo (columns 4 q .. 4 q + 3), Q = 2 wq + u for u = 0, 1. A
    // warp's word reads fall on 32 banks ((Q ^ c) x 4 + qo); the 16-byte
    // stores of a quarter warp are the 8 k-chunks of one column.
    const int c = tid & 7, qo = (tid >> 3) & 3, wq = tid >> 5;
    auto transpose = [&](int t) {
      const unsigned char *codes = smem + (t % T::STAGES) * T::STAGE + T::X_BYTES;
      const uint32_t slot = slots + (t & 1) * T_SLOT;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int Q = 2 * wq + u;
        const unsigned char *src = codes + 16 * c * 128 + ((Q ^ c) << 4) + qo * 4;
        uint32_t o[4][4];  // [k-quad][column j]
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          uint32_t w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            w[r] = *reinterpret_cast<const uint32_t *>(src + (4 * i4 + r) * 128);
          transpose4(o[i4], w);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 16 * Q + 4 * qo + j, r = n & 63;
          const uint32_t dst = slot + (n >> 6) * T_HALF + r * 128 + ((c ^ (r & 7)) << 4);
#if I8_FAULT == 3
          gw::st_shared16(dst, o[1][j], o[2][j], o[3][j], o[0][j]);  // one k-quad off
#else
          gw::st_shared16(dst, o[0][j], o[1][j], o[2][j], o[3][j]);
#endif
        }
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
      gw::bar_sync(BAR_PRODUCE, 128);       // everyone's
      transpose(t);
      gw::fence_async_proxy();  // the xq tile and the slot, for wgmma's reads
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
  int acc[BM / 2];  // the int32 sum (one group) or the group's partial
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
  float tot[GROUPED ? BM / 2 : 1];  // groups: the scaled sum
#pragma unroll
  for (int i = 0; i < (GROUPED ? BM / 2 : 1); ++i) tot[i] = 0.f;
  if constexpr (!GROUPED) {
    // one tile's products stay in flight while the next tile's are issued
    for (int t = 0; t < nt; ++t) {
      gw::bar_sync(BAR_FULL + (t & 1), T_THREADS);  // slot t % 2 and xq tile t are ready
      tile_mma<T>(acc, sbase, slots, t, h, 1);
      gw::wgmma_wait<1>();  // tile t - 1's products are done
      if (t >= 1 && t + 1 < nt) gw::bar_arrive(BAR_EMPTY + ((t - 1) & 1), T_THREADS);
    }
    gw::wgmma_wait<0>();
  } else {
    int grp = t0 * TKT / a.group;  // the group
    float s_lo = 0.f, s_hi = 0.f;  // its scales of columns c, c + 8
    auto scales = [&]() {
      const float *srow = a.s + (size_t)grp * a.N + n0 + c;
      s_lo = n0 + c < a.N ? srow[0] : 0.f;
      s_hi = n0 + c + 8 < a.N ? srow[8] : 0.f;
    };
    scales();
    int acc_in = 1;  // 0: the tile's first product overwrites the partial
    for (int t = 0; t < nt; ++t) {
      gw::bar_sync(BAR_FULL + (t & 1), T_THREADS);
      tile_mma<T>(acc, sbase, slots, t, h, acc_in);
      gw::wgmma_wait<0>();
      // a group is a multiple of 128 rows here: the flush comes after the
      // tile's products are done, outside the wgmma sequence
      acc_in = 1;
      if (((t0 + t + 1) * TKT) % a.group == 0) {
#if I8_FAULT == 4
        const bool skip = grp == t0 * TKT / a.group;  // the split's first group end
#else
        constexpr bool skip = false;
#endif
        if (!skip) {
#pragma unroll
          for (int i = 0; i < BM / 2; ++i)
            tot[i] += static_cast<float>(acc[i]) * ((i & 2) ? s_hi : s_lo);
#if I8_FAULT != 1
          acc_in = 0;
#endif
        }
        ++grp;
        if (grp < a.K / a.group) scales();
      }
      if (t + 2 < nt) gw::bar_arrive(BAR_EMPTY + (t & 1), T_THREADS);
    }
  }

  // the split's f32 result of column c + 8 r: the groups' sum, or the int32
  // sum times the column's scale
  float cs[2] = {1.f, 1.f};
  if constexpr (!GROUPED) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + c + 8 * r;
      cs[r] = n < a.N ? a.s[n] : 0.f;
    }
  }
  auto res = [&](int i) {
    if constexpr (GROUPED)
      return tot[i];
    else
      return static_cast<float>(acc[i]) * cs[(i >> 1) & 1];
  };
  if (a.ws) {  // this split's f32 partial, without the row's xs
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
  // bf16 output: the [BM tokens][128 columns] tile goes into the ring's memory
  // (free once both warpgroups' products are done; a token row is 256 B,
  // chunk ch stored at ch ^ (token & 7)) and leaves in 16-byte stores
  gw::bar_sync(BAR_MMA, 256);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tk = 8 * j + 2 * tig + e;
      const float rs = m0 + tk < a.M ? a.xs[m0 + tk] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = c + 8 * r;
        *reinterpret_cast<__nv_bfloat16 *>(smem + tk * 256 + (((col >> 3) ^ (tk & 7)) << 4) +
                                           (col & 7) * 2) =
            __float2bfloat16_rn(res(4 * j + 2 * r + e) * rs);
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

inline dim3 grid_of(const Args &a, int bm, int splits) {
  // row blocks fastest: the blocks that read one column tile run together
  return dim3((a.M + bm - 1) / bm, (a.N + BN - 1) / BN, splits);
}

template <int MT, bool GROUPED>
void launch_ring(const Args &a, int splits, cudaStream_t st) {
  static bool done = false;
  if (!gw::allow_smem(i8_ring_kernel<MT, GROUPED>, Ring<MT>::SMEM, done)) return;
  i8_ring_kernel<MT, GROUPED><<<grid_of(a, 16 * MT, splits), 128, Ring<MT>::SMEM, st>>>(a);
}

template <int BM, bool GROUPED>
void launch_tile(const Args &a, int splits, cudaStream_t st) {
  static bool done = false;
  if (!gw::allow_smem(i8_tile_kernel<BM, GROUPED>, Tile<BM>::SMEM, done)) return;
  i8_tile_kernel<BM, GROUPED><<<grid_of(a, BM, splits), T_THREADS, Tile<BM>::SMEM, st>>>(a);
}

// false: no such tile; a refused launch shows in cudaGetLastError()
template <bool GROUPED>
bool dispatch(int bm, const Args &a, int splits, cudaStream_t st) {
  switch (bm) {
    case 16: launch_ring<1, GROUPED>(a, splits, st); return true;
    case 32: launch_ring<2, GROUPED>(a, splits, st); return true;
    case 64: launch_ring<4, GROUPED>(a, splits, st); return true;
    case 128: launch_tile<128, GROUPED>(a, splits, st); return true;
    case 256:
      if constexpr (GROUPED) {
        return false;  // the partial and the sum would need 256 registers a thread
      } else {
        launch_tile<256, false>(a, splits, st);
        return true;
      }
    default: return false;
  }
}

}  // namespace
}  // namespace i8

// y = (sum_g int32(xq_g . w_g) * scale[g]) * xs. xq [M, K] s8 contiguous,
// xs [M] f32, w [K, N] s8, scale [K/group, N] f32 (group == K: one group);
// N % 16 == 0; ws [splits, M, N] f32 when splits > 1. bm in {16, 32, 64} runs
// the ring kernel (K % 64 == 0, group % 32 == 0, splits of tiles_per_split
// 64-row k-tiles), {128, 256} the tile kernel (K % 128 == 0, group % 128 ==
// 0, 128-row k-tiles; groups: 128 only). Returns cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for a tile that does not exist.
extern "C" int i8_gemm(const void *xq, const void *xs, const void *w, const void *scale,
                       int group, void *out, void *ws, int M, int K, int N, int splits,
                       int tiles_per_split, int bm, void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  i8::Args a{static_cast<const int8_t *>(xq), static_cast<const float *>(xs),
             static_cast<const int8_t *>(w), static_cast<const float *>(scale),
             static_cast<__nv_bfloat16 *>(out), splits > 1 ? static_cast<float *>(ws) : nullptr,
             M, K, N, group, tiles_per_split};
  const int kt = bm >= 128 ? i8::TKT : i8::RKT;
  if (K % kt || group % (bm >= 128 ? i8::TKT : 32)) return static_cast<int>(cudaErrorInvalidValue);
  const bool grouped = group < K;
  if (!(grouped ? i8::dispatch<true>(bm, a, splits, st) : i8::dispatch<false>(bm, a, splits, st)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  i8::i8_reduce_kernel<<<264, 256, 0, st>>>(a, splits);
  return static_cast<int>(cudaGetLastError());
}
