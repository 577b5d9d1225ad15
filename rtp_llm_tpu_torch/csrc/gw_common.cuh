// Shared pieces of the groupwise 4-bit dequant-GEMM kernels for Hopper
// (sm_90a): gw_gemm.cu (gw_gemm, gw_gemm_pipe) and gw_gemm_partial.cu.
//
// The function: y[M,N] = x[M,K] @ W[K,N], W given as
//   packed u8 [K/2, N], split-half: byte[i,n] = code(W[i,n]) | code(W[i+K/2,n]) << 4
//   scale  f32 [K/G, N] over the original rows: row i of the low plane uses
//          scale row i / G, row i of the high plane scale row K/(2G) + i / G
//   code 0 "s4": value = nibble - 8 (offset code);  code 1 "e2m1": fp4
//          sign(1) exp(2) mant(1), the values +-{0, .5, 1, 1.5, 2, 3, 4, 6}.
// x and y are bf16, sums are f32.
//
// Tiling. A block of WARPS warps owns BM = 16*MT rows of x and BN = 32*WARPS
// columns of W, and walks the packed rows in k-tiles of KT = 32 (32 low-plane
// and 32 high-plane k values). A k-tile lies inside one scale group per plane
// (the wrapper requires G % 32 == 0 and K % 2G == 0). Each warp owns a
// 32-column slab and all BM rows, and multiplies with
// mma.sync.m16n8k16 (bf16 x bf16 -> f32).
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

constexpr int KT = 32;          // packed rows per k-tile
constexpr int XP = 2 * KT + 8;  // x tile row pitch in bf16: 144 B keeps the A reads conflict-free

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

// One k-tile in shared memory. The packed rows carry 16 bytes of padding: a
// pitch of 144 B (or 80 B) spreads the four row pairs a warp reads over all
// 32 banks.
template <int MT, int WARPS>
struct alignas(16) Stage {
  uint8_t p[KT][32 * WARPS + 16];
  __nv_bfloat16 x[16 * MT][XP];  // [row][low plane k 0..31 | high plane k 0..31 | pad]
  float s[2][32 * WARPS];        // scale row of the low / high plane
};

template <bool ASYNC>
__device__ __forceinline__ void copy16(void *dst, const void *src) {
  if constexpr (ASYNC) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    *reinterpret_cast<uint4 *>(dst) = *reinterpret_cast<const uint4 *>(src);
  }
}

__device__ __forceinline__ void zero16(void *dst) {
  *reinterpret_cast<uint4 *>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bring k-tile `tile` (packed rows tile*KT ..) of the block at (m0, n0) into
// `st` with 16-byte copies, neighbouring threads on neighbouring addresses.
// Chunks past M or N are zero-filled, so ragged edges need no host padding.
template <int MT, int WARPS, bool ASYNC>
__device__ __forceinline__ void load_tile(Stage<MT, WARPS> &st, const Args &a, int m0, int n0,
                                          int tile, int tid) {
  constexpr int BN = 32 * WARPS, THREADS = 32 * WARPS, BM = 16 * MT;
  const int r0 = tile * KT;
  for (int c = tid; c < KT * (BN / 16); c += THREADS) {
    const int r = c / (BN / 16), cc = c % (BN / 16);
    const int n = n0 + cc * 16;
    if (n < a.N) copy16<ASYNC>(&st.p[r][cc * 16], a.p + (size_t)(r0 + r) * a.N + n);
    else zero16(&st.p[r][cc * 16]);
  }
  const int glo = r0 / a.G, ghi = (a.K / 2 + r0) / a.G;
  for (int c = tid; c < 2 * (BN / 4); c += THREADS) {
    const int pl = c / (BN / 4), cc = c % (BN / 4);
    const int n = n0 + cc * 4;
    if (n < a.N) copy16<ASYNC>(&st.s[pl][cc * 4], a.s + (size_t)(pl ? ghi : glo) * a.N + n);
    else zero16(&st.s[pl][cc * 4]);
  }
  for (int c = tid; c < BM * 8; c += THREADS) {
    const int row = c / 8, pl = (c % 8) / 4, cc = c % 4;
    const int m = m0 + row;
    if (m < a.M)
      copy16<ASYNC>(&st.x[row][pl * KT + cc * 8],
                    a.x + (size_t)m * a.xs + (size_t)pl * (a.K / 2) + r0 + cc * 8);
    else zero16(&st.x[row][pl * KT + cc * 8]);
  }
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (bits 0..15)
  return *reinterpret_cast<uint32_t *>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16 *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Multiply one k-tile. SCALED: each weight is decode(nibble) * scale in f32,
// rounded to bf16, and both planes add into `lo` (the caller passes the same
// array twice). Not SCALED: the codes enter as exact bf16 integers and the
// low and high planes add into their own arrays (group partials).
template <int MT, int WARPS, int CODE, bool SCALED>
__device__ __forceinline__ void mma_tile(const Stage<MT, WARPS> &st, float (&lo)[MT][4][4],
                                         float (&hi)[MT][4][4], int warp, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  float sl[4] = {1.f, 1.f, 1.f, 1.f}, sh[4] = {1.f, 1.f, 1.f, 1.f};
  if constexpr (SCALED) {
    const float4 a = *reinterpret_cast<const float4 *>(&st.s[0][warp * 32 + g * 4]);
    const float4 b = *reinterpret_cast<const float4 *>(&st.s[1][warp * 32 + g * 4]);
    sl[0] = a.x, sl[1] = a.y, sl[2] = a.z, sl[3] = a.w;
    sh[0] = b.x, sh[1] = b.y, sh[2] = b.z, sh[3] = b.w;
  }
#pragma unroll
  for (int ks = 0; ks < KT / 16; ++ks) {
    const int rb = ks * 16 + tig * 2;
    uint32_t w[4];
    w[0] = *reinterpret_cast<const uint32_t *>(&st.p[rb][warp * 32 + g * 4]);
    w[1] = *reinterpret_cast<const uint32_t *>(&st.p[rb + 1][warp * 32 + g * 4]);
    w[2] = *reinterpret_cast<const uint32_t *>(&st.p[rb + 8][warp * 32 + g * 4]);
    w[3] = *reinterpret_cast<const uint32_t *>(&st.p[rb + 9][warp * 32 + g * 4]);
    uint32_t blo[4][2], bhi[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) b[r] = (w[r] >> (8 * j)) & 0xFFu;
      blo[j][0] = pack_bf16(decode<CODE>(b[0] & 15u) * sl[j], decode<CODE>(b[1] & 15u) * sl[j]);
      blo[j][1] = pack_bf16(decode<CODE>(b[2] & 15u) * sl[j], decode<CODE>(b[3] & 15u) * sl[j]);
      bhi[j][0] = pack_bf16(decode<CODE>(b[0] >> 4) * sh[j], decode<CODE>(b[1] >> 4) * sh[j]);
      bhi[j][1] = pack_bf16(decode<CODE>(b[2] >> 4) * sh[j], decode<CODE>(b[3] >> 4) * sh[j]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const __nv_bfloat16 *xl = &st.x[mt * 16 + g][ks * 16 + tig * 2];
      const __nv_bfloat16 *xh = xl + KT;
      const uint32_t alo[4] = {ld32(xl), ld32(xl + 8 * XP), ld32(xl + 8), ld32(xl + 8 * XP + 8)};
      const uint32_t ahi[4] = {ld32(xh), ld32(xh + 8 * XP), ld32(xh + 8), ld32(xh + 8 * XP + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_bf16(lo[mt][j], alo, blo[j]);
        mma_bf16(hi[mt][j], ahi, bhi[j]);
      }
    }
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
