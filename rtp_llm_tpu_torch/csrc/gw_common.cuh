// Shared pieces of the groupwise 4-bit dequant-GEMM kernels for Hopper
// (sm_90a): gw_gemm.cu (gw_gemm), gw_gemm_pipe.cu (gw_gemm_pipe) and
// gw_gemm_partial.cu (gw_gemm_partial); the 8-bit w8_gemm.cu takes the
// cp.async, mma.sync and wgmma helpers.
//
// The function: y[M,N] = x[M,K] @ W[K,N], W given as
//   packed u8 [K/2, N], split-half: byte[i,n] = code(W[i,n]) | code(W[i+K/2,n]) << 4
//   scale  f32 [K/G, N] over the original rows: row i of the low plane uses
//          scale row i / G, row i of the high plane scale row K/(2G) + i / G
//   code 0 "s4": value = nibble - 8 (offset code);  code 1 "e2m1": fp4
//          sign(1) exp(2) mant(1), the values +-{0, .5, 1, 1.5, 2, 3, 4, 6}.
// x and y are bf16, sums are f32.
//
// The ring. Every kernel walks the packed rows of its K split in k-tiles of
// KT = 32 (32 low-plane and 32 high-plane k values; a k-tile lies inside one
// scale group per plane: the wrapper requires G % 32 == 0 and K % 2G == 0).
// The few-row kernels of all three entries share one ring (ring_walk): a
// block of WARPS warps owns BM = 16*MT rows of x and BN = 32*WARPS columns of
// W; a ring of RING_STAGES_OF<MT> stages in dynamic shared memory is filled
// by 16-byte cp.async from running pointers, a stage holding a k-tile's
// packed bytes, the block's x slab for its 64 k values and two scale rows.
// Each warp owns a 32-column slab and all BM rows and multiplies with
// mma.sync.m16n8k16 (bf16 x bf16 -> f32), its A fragments from ldmatrix.
//
// The B fragment of that instruction wants, per thread, two consecutive k
// rows of ONE column. The two nibbles of a byte are K/2 rows apart, so a
// byte feeds two different products (low plane against x[:, i], high plane
// against x[:, K/2 + i]) and a k-pair comes from the bytes of two
// neighbouring packed rows. To read 4 bytes at a time the slab's columns are
// dealt to the four n8 tiles round-robin: thread (g, tig) reads the 32-bit
// word at column 4*g of its slab from rows 2*tig, 2*tig+1, 2*tig+8, 2*tig+9,
// and byte j of those words is its B column (n = g) of tile j. Column n of
// tile j is therefore slab column 4*n + j, and the accumulators of a thread
// (tile j, columns 2*tig and 2*tig+1) are the 8 consecutive slab columns
// 8*tig .. 8*tig+7: one 16-byte store per row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gw {

constexpr int KT = 32;  // packed rows per k-tile
constexpr int RING_KT = KT;

struct Args {
  const __nv_bfloat16 *x;  // [M, K], row stride xs elements
  long long xs;
  const uint8_t *p;  // [K/2, N]
  const float *s;    // [K/G, N]
  __nv_bfloat16 *out;  // [M, N]
  float *ws;           // [splits, M, N] when splits > 1
  int M, K, N, G;
  int splits, tiles_per_split;
};

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void *src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// nibble -> value, exactly, in f32.
template <int CODE>
__device__ __forceinline__ float decode(uint32_t nib) {
  if constexpr (CODE == 0) {
    // 2^23 + nib is exact in f32; subtracting 2^23 + 8 leaves nib - 8
    return __uint_as_float(0x4B000000u | nib) - 8388616.0f;
  } else {
    // every e2m1 value is a normal f32: pack its fields directly
    const uint32_t e = (nib >> 1) & 3u, m = nib & 1u;
    const uint32_t bits = (e ? (((e + 126u) << 23) | (m << 22)) : m * 0x3F000000u) |
                          ((nib & 8u) << 28);
    return __uint_as_float(bits);
  }
}

// Byte j of `nibs` (four nibbles, one per byte, already masked) -> its value
// in f32, exactly. s4: one prmt puts the nibble into the mantissa of 2^23.
template <int CODE>
__device__ __forceinline__ float decode_byte(uint32_t nibs, int j) {
  if constexpr (CODE == 0)
    return __uint_as_float(__byte_perm(nibs, 0x4B000000u, 0x7440u | j)) - 8388616.0f;
  else
    return decode<1>((nibs >> (8 * j)) & 15u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (bits 0..15)
  return *reinterpret_cast<uint32_t *>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- the ring of the few-row kernels --------------------------------------

// ring depth by row tile: the x slab grows with the rows, and three to four
// blocks must fit a multiprocessor (47-59 KB a block)
template <int MT> constexpr int RING_STAGES_OF = MT == 1 ? 6 : MT == 2 ? 5 : 4;

// One ring stage in dynamic shared memory, as byte offsets:
//   packed [32][BN + 16] u8 (the pitch spreads a warp's four row pairs over all
//   banks) | x [BM][64 + 8] bf16 (32 low-plane k values, 32 high-plane ones,
//   pad: a pitch of 144 B keeps ldmatrix conflict-free) | scale [2 planes][BN] f32
template <int BM, int BN>
struct Ring {
  static constexpr int PP = BN + 16;          // packed row pitch, bytes
  static constexpr int XP = 2 * RING_KT + 8;  // x row pitch, bf16
  static constexpr int X_OFF = RING_KT * PP;
  static constexpr int S_OFF = X_OFF + BM * XP * 2;
  static constexpr int BYTES = S_OFF + 2 * BN * 4;
};

template <int MT, int WARPS>
constexpr int ring_smem() { return RING_STAGES_OF<MT> * Ring<16 * MT, 32 * WARPS>::BYTES; }

// Packed rows [r0, r1) of this block's K split, in whole plan k-tiles.
__device__ __forceinline__ void split_range(const Args &a, int split, int &r0, int &r1) {
  r0 = split * a.tiles_per_split * RING_KT;
  r1 = min(r0 + a.tiles_per_split * RING_KT, a.K / 2);
}

// Walk this block's k-tiles through the ring: body(i, stage, x_sa) for
// k-tile i of the split, with `stage` the stage's bytes and `x_sa` the shared
// address of this lane's ldmatrix row in the stage's x slab (low plane;
// + RING_KT * 2 bytes for the high plane). One barrier a k-tile: when body
// runs, tile i is visible to all and every thread is done with tile i - 1.
// `a` by value: taken by reference to the kernel's parameter, the 64-row
// tiles read 4-8% slower on the card.
template <int MT, int WARPS, class BODY>
__device__ __forceinline__ void ring_walk(const Args a, unsigned char *smem, BODY &&body) {
  using R = Ring<16 * MT, 32 * WARPS>;
  constexpr int RING_STAGES = RING_STAGES_OF<MT>;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, lane = tid & 31;
  const int lm = lane >> 3, lr = lane & 7;
  const int m0 = blockIdx.x * 16 * MT, n0 = blockIdx.y * 32 * WARPS;
  int r0, r1;
  split_range(a, blockIdx.z, r0, r1);
  const int nt = (r1 - r0) / RING_KT;  // K/2 % 32 == 0

  // ---- what this thread copies each k-tile: 2 packed chunks (rows p_r and
  // p_r + 16), its share of the x slab (chunk x_c of rows x_r, x_r +
  // THREADS / 8, ..), and the first THREADS / 2 threads a scale chunk.
  // Tiles are loaded in order, so the sources are running pointers and the
  // destinations constants: the decode needs the integer pipe that index
  // arithmetic would spend. Rows past M and columns past N are zero-filled.
  constexpr int THREADS = 32 * WARPS, BN = 32 * WARPS, XJ = 16 * MT * 8 / THREADS;
  const int k2 = a.K / 2;
  const int p_r = tid / (BN / 16), p_c = tid % (BN / 16);
  const bool p_ok = n0 + p_c * 16 < a.N;
  const uint8_t *pp = p_ok ? a.p + (size_t)(r0 + p_r) * a.N + n0 + p_c * 16 : a.p;
  const size_t p_half = p_ok ? (size_t)16 * a.N : 0;
  const uint32_t p_dst = p_r * R::PP + p_c * 16;
  const int x_c = tid & 7, x_r = tid >> 3;  // chunks 0..3 low plane, 4..7 high plane
  const __nv_bfloat16 *xp = a.x + (size_t)(x_c >> 2) * k2 + (x_c & 3) * 8 + r0;
  const uint32_t x_dst = R::X_OFF + (x_r * R::XP + (x_c >> 2) * RING_KT + (x_c & 3) * 8) * 2;
  const int s_pl = tid / (BN / 4), s_c = tid % (BN / 4);
  const bool s_ok = tid < THREADS / 2 && n0 + s_c * 4 < a.N;
  const float *sp = s_ok ? a.s + n0 + s_c * 4 : a.s;
  int s_g = (s_pl * k2 + r0) / a.G, s_in = (s_pl * k2 + r0) % a.G;  // scale row, rows into it
  auto load = [&](int stage) {  // the next 32 packed rows
    const uint32_t st = sbase + stage * R::BYTES;
    cp16(st + p_dst, pp, p_ok);
    cp16(st + p_dst + 16 * R::PP, pp + p_half, p_ok);
    pp += 2 * p_half;
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      const int m = m0 + x_r + (THREADS / 8) * j;
      const bool ok = m < a.M;
      cp16(st + x_dst + j * (THREADS / 8) * R::XP * 2, ok ? xp + (size_t)m * a.xs : a.x, ok);
    }
    xp += RING_KT;
    if (tid < THREADS / 2) {
      cp16(st + R::S_OFF + tid * 16, s_ok ? sp + (size_t)s_g * a.N : a.s, s_ok);
      s_in += RING_KT;
      if (s_in == a.G) s_in = 0, ++s_g;
    }
  };
  // one commit group per ring slot, empty past the end, so that
  // wait_group<STAGES - 2> always means "tile i has landed"
  for (int s = 0; s < RING_STAGES - 1; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }
  // ldmatrix lane address inside an m16 x k16 A tile: row, k offset
  const int a_off = (((lm & 1) * 8 + lr) * R::XP + (lm >> 1) * 8) * 2;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<RING_STAGES - 2>();
    __syncthreads();  // tile i visible to all; everyone is done with tile i - 1
    const int nx = i + RING_STAGES - 1;
    if (nx < nt) load(nx % RING_STAGES);
    cp_async_commit();
    body(i, smem + (i % RING_STAGES) * R::BYTES,
         sbase + (i % RING_STAGES) * R::BYTES + R::X_OFF + a_off);
  }
}

// A fragments of all MT row tiles of one k16 step, `k` k values into the
// stage's x row (0.. low plane, RING_KT.. high plane).
template <int MT, int WARPS>
__device__ __forceinline__ void ring_x_frags(uint32_t (&af)[MT][4], uint32_t x_sa, int k) {
  using R = Ring<16 * MT, 32 * WARPS>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ldsm4(af[mt], x_sa + (mt * 16 * R::XP + k) * 2);
}

// The packed words of k16 step ks: rows 2 tig, 2 tig + 1, 2 tig + 8,
// 2 tig + 9; byte j of each word is column g of n8 tile j.
template <int MT, int WARPS>
__device__ __forceinline__ void ring_words(uint32_t (&w)[4], const unsigned char *stage, int ks,
                                           int warp, int lane) {
  using R = Ring<16 * MT, 32 * WARPS>;
  const int g = lane >> 2, tig = lane & 3;
  const unsigned char *pw = stage + (ks * 16 + tig * 2) * R::PP + warp * 32 + g * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    w[r] = *reinterpret_cast<const uint32_t *>(pw + ((r & 1) + (r >> 1) * 8) * R::PP);
}

// This thread's scales in the stage: slab columns 4 g .. 4 g + 3 (n8 tiles
// 0..3), low and high plane.
template <int MT, int WARPS>
__device__ __forceinline__ void ring_scales(float (&sl)[4], float (&sh)[4],
                                            const unsigned char *stage, int warp, int lane) {
  using R = Ring<16 * MT, 32 * WARPS>;
  const float *sc = reinterpret_cast<const float *>(stage + R::S_OFF) + warp * 32 + (lane >> 2) * 4;
  const float4 fl = *reinterpret_cast<const float4 *>(sc);
  const float4 fh = *reinterpret_cast<const float4 *>(sc + 32 * WARPS);
  sl[0] = fl.x, sl[1] = fl.y, sl[2] = fl.z, sl[3] = fl.w;
  sh[0] = fh.x, sh[1] = fh.y, sh[2] = fh.z, sh[3] = fh.w;
}

// B fragments of the scaled weights: decode(nibble) * scale in f32, rounded
// once to bf16. The s4 decode is three operations a weight: the four low (or
// high) nibbles of a word are masked at once, one prmt drops a nibble into
// the mantissa of 2^23, one subtract leaves nibble - 8, one multiply applies
// the scale; one cvt.rn.bf16x2.f32 rounds a pair.
template <int CODE>
__device__ __forceinline__ void scaled_frags(uint32_t (&blo)[4][2], uint32_t (&bhi)[4][2],
                                             const uint32_t (&w)[4], const float (&sl)[4],
                                             const float (&sh)[4]) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lo[r] = w[r] & 0x0F0F0F0Fu;
    hi[r] = (w[r] >> 4) & 0x0F0F0F0Fu;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    blo[j][0] = pack_bf16(decode_byte<CODE>(lo[0], j) * sl[j], decode_byte<CODE>(lo[1], j) * sl[j]);
    blo[j][1] = pack_bf16(decode_byte<CODE>(lo[2], j) * sl[j], decode_byte<CODE>(lo[3], j) * sl[j]);
    bhi[j][0] = pack_bf16(decode_byte<CODE>(hi[0], j) * sh[j], decode_byte<CODE>(hi[1], j) * sh[j]);
    bhi[j][1] = pack_bf16(decode_byte<CODE>(hi[2], j) * sh[j], decode_byte<CODE>(hi[3], j) * sh[j]);
  }
}

// Write a block's sums: bf16 to `out`, or f32 to this split's slice of the
// workspace. A thread holds 8 consecutive columns of rows g and g + 8.
template <int MT, int WARPS>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][4][4], const Args &a, int m0,
                                           int n0, int split, int warp, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int n = n0 + warp * 32 + tig * 8;
  if (n >= a.N) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + g + h * 8;
      if (m >= a.M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][h * 2];
        v[4 + j] = acc[mt][j][h * 2 + 1];
      }
      if (a.splits == 1) {
        uint4 o;
        o.x = pack_bf16(v[0], v[1]), o.y = pack_bf16(v[2], v[3]);
        o.z = pack_bf16(v[4], v[5]), o.w = pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4 *>(a.out + (size_t)m * a.N + n) = o;
      } else {
        float *w = a.ws + ((size_t)split * a.M + m) * a.N + n;
        *reinterpret_cast<float4 *>(w) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4 *>(w + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

// ---- wgmma (the 128-row tile kernels) ---------------------------------------

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units. A K-major operand of
// [rows][64 bf16] lies as 128-byte rows, the 16-byte chunk c of row r stored
// at c ^ (r & 7), 8-row groups 1024 bytes apart (the stride offset), from a
// 1024-byte aligned base; a k16 step starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// writes made by threads (cp.async, st.shared) become visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x N] (+)= A[64 x 16] x B[16 x N], both bf16 from shared memory
// through descriptors, f32 sums, asynchronous (N = 128: 64 accumulators a
// thread, N = 256: 128). B is K-major (the x tiles); A is K-major (TA = 0)
// or M-major (TA = 1: a [k][m] tile, as the 8-bit weights lie in memory).
// scale_d 0 writes A x B over D instead of adding it.
template <int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 0;\n"  // scale-a, scale-b = 1; A as TA says, B K-major
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, 0;\n"  // scale-a, scale-b = 1; A as TA says, B K-major
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// ---- host side ----------------------------------------------------------------

// Sum the splits' f32 partial results in a fixed order (no atomics) -> bf16.
__global__ void __launch_bounds__(256)
reduce_splits(const float *__restrict__ ws, __nv_bfloat16 *__restrict__ out, int splits,
              size_t mn) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 s = *reinterpret_cast<const float4 *>(ws + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 t = *reinterpret_cast<const float4 *>(ws + (size_t)sp * mn + i);
    s.x += t.x, s.y += t.y, s.z += t.z, s.w += t.w;
  }
  uint2 o;
  o.x = pack_bf16(s.x, s.y), o.y = pack_bf16(s.z, s.w);
  *reinterpret_cast<uint2 *>(out + i) = o;
}

inline Args make_args(const void *x, long long xs, const void *packed, const void *scale,
                      void *out, void *ws, int M, int K, int N, int G, int splits) {
  Args a;
  a.x = static_cast<const __nv_bfloat16 *>(x), a.xs = xs;
  a.p = static_cast<const uint8_t *>(packed), a.s = static_cast<const float *>(scale);
  a.out = static_cast<__nv_bfloat16 *>(out), a.ws = static_cast<float *>(ws);
  a.M = M, a.K = K, a.N = N, a.G = G, a.splits = splits;
  const int ktiles = K / 2 / KT;
  a.tiles_per_split = (ktiles + splits - 1) / splits;
  return a;
}

inline dim3 make_grid(const Args &a, int bm, int bn) {
  return dim3((a.M + bm - 1) / bm, (a.N + bn - 1) / bn, a.splits);
}

// After the main kernel: the reduce pass when K was split. Returns the
// launch status of whatever ran last.
inline int finish(const Args &a, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  const size_t mn = (size_t)a.M * a.N;
  reduce_splits<<<(unsigned)((mn / 4 + 255) / 256), 256, 0, st>>>(a.ws, a.out, a.splits, mn);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory above 48 KB needs the attribute, once per instantiation.
template <typename KERNEL>
bool allow_smem(KERNEL kernel, int bytes, bool &done) {
  if (!done)
    done = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
           cudaSuccess;
  return done;
}

// Pick the instantiation for (bm, bn, code) at run time. LAUNCH is a functor
// template: LAUNCH<MT, WARPS, CODE>::run(args, grid, stream).
template <template <int, int, int> class LAUNCH, int... MTS>
struct Dispatch;

template <template <int, int, int> class LAUNCH>
struct Dispatch<LAUNCH> {
  static bool run(int, int, int, const Args &, cudaStream_t) { return false; }
};

template <template <int, int, int> class LAUNCH, int MT, int... REST>
struct Dispatch<LAUNCH, MT, REST...> {
  static bool run(int bm, int bn, int code, const Args &a, cudaStream_t st) {
    if (bm != 16 * MT) return Dispatch<LAUNCH, REST...>::run(bm, bn, code, a, st);
    const dim3 grid = make_grid(a, bm, bn);
    if (bn == 128 && code == 0) LAUNCH<MT, 4, 0>::run(a, grid, st);
    else if (bn == 128 && code == 1) LAUNCH<MT, 4, 1>::run(a, grid, st);
    else if (bn == 64 && code == 0) LAUNCH<MT, 2, 0>::run(a, grid, st);
    else if (bn == 64 && code == 1) LAUNCH<MT, 2, 1>::run(a, grid, st);
    else return false;
    return true;
  }
};

}  // namespace gw
