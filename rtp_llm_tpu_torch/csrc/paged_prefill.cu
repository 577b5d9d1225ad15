// Paged causal GQA prefill attention for Hopper (sm_90a); KV pool in bf16,
// int8 with per-(slot, kv head) scales, or fp8 e4m3.
//
// Replaces the TPU kernel rtp_llm_tpu/ops/attention/pallas_prefill.py
// _prefill_kernel (paged_prefill_attention). In the port it is *the* prefill
// attention on the GPU, and it takes B rows at once with per-row scalars.
// The JAX package sends prefill over a quantized pool through its plain XLA
// path; here a CUDA tensor never takes the plain version, so this kernel
// reads the quantized pool itself, with the same dequantization as the
// decode kernel's quant mode (pallas_decode.py:225-240: K scale on the
// score, V scale on the probability after the normaliser). A reused prefix
// or an earlier chunk is thus read back quantized. The element type and the
// head width D (64, 96, 128 or 256) are template parameters; the entries
// paged_prefill_{bf16,i8,e4m3} (D 128) and their _d64 / _d96 / _d256 forms
// share one body. The JAX package runs its Pallas prefill at D 128 and 256
// when enable_pallas_prefill is set (rtp_llm_tpu/ops/attention/__init__.py,
// d % 128 == 0) and serves D 64 and 96 through its plain XLA path; here the
// kernel takes every width.
//
// Logit soft-cap (gemma2): with soft_cap > 0 every score is s = cap *
// tanh(q . K * sm_scale / cap) before the softmax (the int8 K scale inside
// the tanh). The JAX package sends a capped model to its XLA plain path
// (rtp_llm_tpu/ops/attention/ref.py); here it is a runtime mode, a branch
// uniform over the launch: uncapped scores take the code they took before.
// tanhf, accurate in f32 (tanh.approx's 2^-11 relative error would be ~0.025
// on a score under a cap of 50), then the exp2 domain.
//
// What it computes: for row b, query token t (absolute position
// q_pos = q_offsets[b] + t) and query head h,
//   out[b, t, h] = softmax_p( q[b, t, h] . K[p] * sm_scale ) @ V[p]
// over p <= q_pos, p < kv_lens[b] (and p > q_pos - window with a sliding
// window). kv_lens[b] counts the whole context including this chunk, whose
// KV is already in the pool; q_offsets[b] is the reused-prefix length.
// Padded bucket-tail rows (q_pos >= kv_len) output exact zeros. With an int8
// pool the score is q . K8[p] * ks[p] * sm_scale and the sum runs over
// softmax_p * vs[p] * V8[p], the normaliser over the unscaled probabilities.
//
// What bounds it on the H100: operations. A T-token chunk does ~4 * T * S *
// Hq * D FLOP for ~2 * S * Hkv * D * 2 bytes of KV (S = context length), far
// above the bytes/FLOP ridge for the prompt lengths served. So both products
// have to run on the tensor cores and the loads have to hide behind them.
//
// The design (FlashAttention-2/3 shaped, on wgmma):
//  * One block of two warpgroups per (query tile, kv head, row) owns BM = 128
//    rows of the product, 64 a warpgroup (wgmma's M). The G = Hq / Hkv query
//    heads of the kv head are stacked into those rows, so every K/V tile is
//    read once for all of them: row r of the block is (token r / G, head
//    r % G), a block takes TQ = 128 / G tokens (integer division) and rows
//    >= TQ * G are dead (G = 7: 18 tokens, 126 live rows; G = 3, 5, 6 alike;
//    G = 1, 2, 4, 8 fill all 128). ops/attention/prefill.py tile_plan states
//    the same map in Python. Warp w owns rows 16 w .. 16 w + 15: wgmma's
//    accumulator layout is mma.m16n8's, a warp holding 16 of the
//    warpgroup's 64 rows, so the softmax works on fragments as before.
//  * Q is staged once in shared memory as bf16 (cp.async) and is the
//    shared-memory A operand of S = Q K^T in every tile. The softmax scale
//    is applied to the f32 scores.
//  * K and V arrive in their pool type by 16-byte cp.async through the block
//    table into a ring of four stages of 64 keys in dynamic shared memory
//    (161 KB a block, one block a multiprocessor: three tiles, 96 KB of
//    bf16 KV, in flight). Rows past the span use the zero-fill form (source
//    size 0): nothing is read from a slot no live key maps to, and masked
//    (zero) probabilities never meet garbage V rows. A tile is two halves of
//    64 dims, [half][key][128 B] with the 16-byte chunk index XORed with
//    (key & 7): wgmma's 128-byte swizzle.
//  * S = Q K^T: m64n64k16 from shared memory, K rows as the K-major B
//    operand as they lie. O += P V: m64n128k16 with P as the register A
//    operand (the accumulator fragments of two neighbouring n8 tiles are the
//    A fragment of one k16 step, rounded to bf16 in registers) and the same
//    kind of tile as the MN-major B operand (V needs no transpose). f32
//    accumulators throughout. A warpgroup waits for its products before it
//    touches their registers again; the other warpgroup's softmax fills the
//    tensor cores' gaps.
//  * Online softmax in f32 in the exp2 domain on the accumulator fragments;
//    row max and sum across the quad by shuffles; O is rescaled only when a
//    row's max moved.
//  * int8 / e4m3: the raw bytes take the same ring (half the bytes); one pass
//    a tile turns the landed stage into a bf16 tile in shared memory (both
//    conversions are exact: int8 by the 2^23 magic number and one
//    cvt.rn.bf16x2.f32 a pair, e4m3 through f16). int8 scales are read
//    through the block table into registers when a tile's copies are started
//    (never for a key past the span: its slot may hold NaN) and stored beside
//    the ring one step later, when they have arrived; the K scale multiplies
//    the score column in f32, the V scale multiplies P's column after l took
//    p and before P is rounded to bf16.
//  * Masks only where needed: a warpgroup tests per key only in tiles that
//    touch its diagonal, kv_len or the window's edge, and skips tiles wholly
//    masked for its 64 rows. wgmma under a branch must not look divergent to
//    the compiler (it serialises them): the warpgroup index and the
//    remainder decision are read back from lane 0.
//  * A query tile wholly past kv_len writes its zeros and returns before any
//    load; blockIdx.x maps to the last query tile first, so the causal
//    triangle's long blocks start first.
//  * A warp writes its O rows over its own Q rows and stores 16 bytes a lane.
//  * Head widths: shared memory holds whole 64-dim halves (DP = 64 for D 64,
//    128 for D 96 and 128, 256 for D 256), so every tile keeps the 128-byte
//    swizzle. S = Q
//    K^T runs D / 16 k16 steps (D 96: six, the second half's first 32 dims);
//    P V runs at N = DP (m64n64k16 for D 64, m64n128k16 else) and D 96 drops
//    the last 32 output columns, which read half-rows no load wrote (a
//    column of O depends on its own column of V alone). That spends a third
//    more on D 96's P V than an N 96 product would; an N 96 MN-major operand
//    would straddle the 128-byte swizzle atom.
//  * D 256: Q is 64 KB and a K or V tile 32 KB, so the ring has two stages
//    (Smem::STAGES: 193 KB a block; four would need 320 KB): one tile in
//    flight while the block computes the other. P V is two m64n128k16 a key
//    step, on the tile's dims 0-127 and 128-255, into the two halves of a
//    128-f32 O accumulator a thread.
// An mma.sync.m16n8k16 + ldmatrix form of the same design (two stages, two
// blocks a multiprocessor) ran 10-35% slower on the card: each warp re-read
// the whole K and V tile from shared memory for its 16 rows.
// Not yet: TMA one box a page, a producer warp with mbarriers instead of one
// barrier a tile, S of tile i + 1 started under the softmax of tile i, feeding
// 1-byte fragments without the conversion pass, an 8-bit product for S. The
// exp2 of the softmax (16 a clock a multiprocessor) costs half of what the
// tile's products cost and is not hidden yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Built-in faults for the smoke run's check (0 in every served build):
//  1: the last k16 step of S = Q K^T left out (the head width's tail);
//  2: the soft-cap's tanh left out (capped scores taken as scaled scores).
#ifndef PP_FAULT
#define PP_FAULT 0
#endif

namespace {

constexpr int BM = 128;       // product rows a block: TQ tokens x G heads
constexpr int KT = 64;        // keys per ring stage
constexpr int WARPS = 8;      // two warpgroups of 64 rows; a warp owns 16 rows
constexpr int THREADS = 32 * WARPS;
constexpr int MAXG = 8;       // max query heads per kv head
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may take
constexpr float NEG = -1e30f;
constexpr float LO_RATIO = 64.f;  // see the remainder pass in the kernel

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle of the
// wgmma descriptors repeats every 1024 bytes). A bf16 tile of R rows x DP
// dims is DP / 64 halves of 64 dims: [half][row][128 B], the 16-byte chunk c
// of a half-row stored at c ^ (row & 7). For Q and K that is wgmma's K-major
// operand layout (dims are the products' K), for V its MN-major one (dims
// are the output columns, 8 keys a 1 KB group).
template <int D> struct Smem {
  static constexpr int STAGES = D > 128 ? 2 : 4;  // ring stages of KT keys
  static constexpr int DP = (D + 63) / 64 * 64;  // dims staged a row
  static constexpr int Q_BYTES = BM * DP * 2;    // D 128: 32 KB
  static constexpr int TILE_BYTES = KT * DP * 2; // D 128: 16 KB: one bf16 K or V tile
  static constexpr int RAW_BYTES = KT * D;       // D 128: 8 KB: one 1-byte K or V tile
  // bf16 pool: Q | 4 x (K, V). 1-byte pools: Q | 4 x (raw K, raw V) | bf16 K,
  // V, which fits in the same bytes.
  static constexpr int BYTES = Q_BYTES + STAGES * 2 * TILE_BYTES + 1024;  // + alignment slack
  static_assert(STAGES * 2 * RAW_BYTES + 2 * TILE_BYTES <= STAGES * 2 * TILE_BYTES,
                "the 1-byte ring and its bf16 tiles fit the bf16 ring's bytes");
  static_assert(2 * RAW_BYTES % 1024 == 0, "the bf16 tiles after a 1-byte ring stay aligned");
  static_assert(BYTES <= MAX_SMEM, "a block's shared memory");
};

// byte offset of 16-byte chunk `ch` (0 .. DP / 8 - 1) of row `row` in a bf16 tile of `rows` rows
__device__ __forceinline__ uint32_t swz(int rows, int row, int ch) {
  return (uint32_t)((ch >> 3) * rows * 128 + row * 128 + (((ch & 7) ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void *src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// writes made by threads (st.shared, cp.async) become visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// S[64 x 64] (+)= Q[64 x 16] K^T[16 x 64]: both operands K-major in shared
// memory; `accumulate` 0 overwrites S (the first k16 step of a tile).
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 64] += P[64 x 16] V[16 x 64] (D 64): as wgmma_o below at N 64.
__device__ __forceinline__ void wgmma_o(float (&d)[32], const uint32_t (&af)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "l"(db), "r"(1));
}

// O[64 x 128] += P[64 x 16] V[16 x 128]: P from registers (each warp its 16
// rows, in the fragment layout of mma.m16n8k16's A), V MN-major in shared memory.
__device__ __forceinline__ void wgmma_o(float (&d)[64], const uint32_t (&af)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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

// O[64 x DP] += P[64 x 16] V[16 x DP] for the key step whose V rows start at
// v_ks: one product at N = DP (64, 128), two at N 128 for DP 256 (dims
// 0-127, then 128-255: the tile's third 64-dim quarter starts 2 KT * 128
// bytes in)
template <int N>
__device__ __forceinline__ void pv_step(float (&o)[N], const uint32_t (&af)[4], uint32_t v_ks) {
  if constexpr (N == 128) {
    wgmma_o(*reinterpret_cast<float(*)[64]>(&o[0]), af, wg_desc(v_ks, KT * 128, 1024));
    wgmma_o(*reinterpret_cast<float(*)[64]>(&o[64]), af,
            wg_desc(v_ks + 2 * KT * 128, KT * 128, 1024));
  } else {
    wgmma_o(o, af, wg_desc(v_ks, KT * 128, 1024));
  }
}

// a score q . K (dequantized) in the exp2 domain under a soft-cap:
// cap * tanh(x * sm_scale / cap) * log2 e (cap_log2 = cap * log2 e,
// scale_cap = sm_scale / cap)
__device__ __forceinline__ float capped_log2_score(float x, float cap_log2, float scale_cap,
                                                   float scale_log2) {
#if PP_FAULT == 2
  return x * scale_log2;
#else
  return cap_log2 * tanhf(x * scale_cap);
#endif
}

// OR of a predicate over the 128 threads of a warpgroup (named barrier 1 + wg)
__device__ __forceinline__ bool warpgroup_any(bool v, int wg) {
  uint32_t out;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(out)
      : "r"((uint32_t)v), "r"(1 + wg)
      : "memory");
  return out != 0;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (bits 0..15)
  return *reinterpret_cast<uint32_t *>(&v);
}

// the two bf16 halves of a packed pair, as f32
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// four 1-byte pool elements (one 32-bit word) -> four bf16, exactly
template <typename E> __device__ __forceinline__ uint2 to_bf16x4(uint32_t w);
template <> __device__ __forceinline__ uint2 to_bf16x4<int8_t>(uint32_t w) {
  // x + 128 as a byte in the low mantissa bits of 2^23, minus (2^23 + 128)
  const uint32_t x = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | i)) - 8388736.0f;
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}
template <> __device__ __forceinline__ uint2 to_bf16x4<__nv_fp8_e4m3>(uint32_t w) {
  // in pairs: one cvt.rn.f16x2.e4m3x2 for two elements; every e4m3 value is a bf16 value
  const float2 a = __half22float2(__half2(
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu), __NV_E4M3)));
  const float2 c = __half22float2(__half2(
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3)));
  return make_uint2(pack_bf16(a.x, a.y), pack_bf16(c.x, c.y));
}

template <typename E, int D>
__global__ void __launch_bounds__(THREADS, 1)
paged_prefill_kernel(const __nv_bfloat16 *__restrict__ q,        // [B, T, Hq, D]
                     const E *__restrict__ k_cache,              // rows of k_stride elems
                     const E *__restrict__ v_cache,
                     long long k_stride, long long v_stride,
                     const __nv_bfloat16 *__restrict__ k_scale,  // int8: rows of scale_stride
                     const __nv_bfloat16 *__restrict__ v_scale,  // elems, [.., Hkv]; else null
                     long long scale_stride,
                     const int *__restrict__ block_tables, int bt_stride,
                     const int *__restrict__ q_offsets, const int *__restrict__ kv_lens,
                     __nv_bfloat16 *__restrict__ out,            // [B, T, Hq, D]
                     int T, int Hq, int Hkv, int block_size, int window,
                     float scale_log2, float cap_log2, float scale_cap) {
  constexpr bool RAW = sizeof(E) == 1;  // the tile needs the conversion pass
  constexpr bool SCALED = std::is_same<E, int8_t>::value;
  constexpr int EPC = 16 / (int)sizeof(E);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks per pool row: D / 8 or D / 16
  constexpr int QC = D / 8;                 // 16-byte chunks of a bf16 row
  constexpr int DP = Smem<D>::DP, Q_BYTES = Smem<D>::Q_BYTES;
  constexpr int TILE_BYTES = Smem<D>::TILE_BYTES, RAW_BYTES = Smem<D>::RAW_BYTES;
  constexpr int STAGES = Smem<D>::STAGES;
  static_assert(D % 32 == 0 && D <= 256, "head width: a multiple of 32, at most 256");

  extern __shared__ unsigned char smem_raw[];
  __shared__ float ks_s[STAGES][KT], vs_s[STAGES][KT];  // int8: the staged keys' scales

  const int G = Hq / Hkv, TQ = BM / G, rows = TQ * G;
  const int qtile = gridDim.x - 1 - blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warpgroup index, read from lane 0 so that the compiler knows it is
  // the same for the whole warp: wgmma under a branch it takes for divergent
  // is serialised
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int tile_first = qtile * TQ;
  const int ntok = min(TQ, T - tile_first);
  const int q_off = q_offsets[b], kv_len = kv_lens[b];
  __nv_bfloat16 *out_tile = out + (((size_t)b * T + tile_first) * Hq + (size_t)kvh * G) * D;

  if (q_off + tile_first >= kv_len) {
    // every token of the tile is bucket padding: zeros, and no load at all
    const int cpt = G * QC;  // 16-byte chunks of one token's G heads, contiguous
    for (int c = tid; c < ntok * cpt; c += THREADS)
      *reinterpret_cast<uint4 *>(out_tile + (size_t)(c / cpt) * Hq * D + (c % cpt) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  const uint32_t raw_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw_base + 1023u) & ~1023u;
  unsigned char *smem = smem_raw + (sbase - raw_base);
  const uint32_t q_sa = sbase;
  const uint32_t ring = sbase + Q_BYTES;
  constexpr int STAGE_BYTES = RAW ? 2 * RAW_BYTES : 2 * TILE_BYTES;
  const uint32_t cvt_k = ring + STAGES * STAGE_BYTES;  // 1-byte pools: the bf16 tile
  const uint32_t cvt_v = cvt_k + TILE_BYTES;

  const int span = min(q_off + tile_first + ntok, kv_len);  // keys [.., span)
  const int lo = window > 0 ? max(0, q_off + tile_first - window + 1) : 0;
  const int kb0 = (lo / KT) * KT;
  const int ntiles = (span - kb0 + KT - 1) / KT;  // >= 1: span > q_off + tile_first >= lo
  const int *bt = block_tables + (size_t)b * bt_stride;

  // ---- loads: thread (key = tid / 4, part = tid % 4) copies chunks part,
  // part + 4, ... of its key's K and V rows: the four threads of a key read
  // 64 contiguous bytes a request (D 128 bf16)
  const int ld_key = tid >> 2, ld_part = tid & 3;
  float sc_reg = 0.f;  // int8: part 0 holds the key's K scale, part 1 its V scale
  auto load_tile = [&](int stage, int kb) {
    const int pos = kb + ld_key;
    const bool valid = pos < span;
    const long long slot =
        valid ? (long long)bt[pos / block_size] * block_size + pos % block_size : 0;
    const E *kp = k_cache + slot * k_stride + kvh * D;
    const E *vp = v_cache + slot * v_stride + kvh * D;
    const uint32_t st = ring + stage * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < (CPR + 3) / 4; ++i) {
      const int ch = ld_part + 4 * i;
      if (CPR % 4 && ch >= CPR) break;  // a 1-byte D 96 row: six chunks
      if constexpr (RAW) {
        cp_async16(st + ld_key * D + ch * 16, kp + ch * EPC, valid);
        cp_async16(st + RAW_BYTES + ld_key * D + ch * 16, vp + ch * EPC, valid);
      } else {
        cp_async16(st + swz(KT, ld_key, ch), kp + ch * EPC, valid);
        cp_async16(st + TILE_BYTES + swz(KT, ld_key, ch), vp + ch * EPC, valid);
      }
    }
    if constexpr (SCALED) {
      sc_reg = 0.f;
      if (valid && ld_part < 2)
        sc_reg = __bfloat162float((ld_part ? v_scale : k_scale)[slot * scale_stride + kvh]);
    }
  };

  // Q: row r of the block is (token r / G, head r % G); dead rows are zeros
  for (int c = tid; c < BM * QC; c += THREADS) {
    const int r = c / QC, ch = c % QC;
    const int tok = r / G, g = r - tok * G;
    const bool live = r < rows && tok < ntok;
    const __nv_bfloat16 *src =
        live ? q + (((size_t)b * T + tile_first + tok) * Hq + kvh * G + g) * D + ch * 8 : q;
    cp_async16(q_sa + swz(BM, r, ch), src, live);
  }
  // one commit group per ring slot, empty past the end, so that
  // wait_group<STAGES - 2> always means "tile i has landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, kb0 + s * KT);
    cp_async_commit();
    if constexpr (SCALED) {
      if (ld_part < 2) (ld_part ? vs_s : ks_s)[s][ld_key] = sc_reg;
    }
  }

  // ---- fragments: thread (g, tig) of warp w holds rows 16 w + g and
  // 16 w + g + 8 of the block (wgmma's accumulator layout is mma.m16n8's, a
  // warp of the warpgroup owning 16 of its 64 rows); of n8 tile j the
  // columns 8 j + 2 tig, + 1
  const int g = lane >> 2, tig = lane & 3;
  int qp[2];  // absolute query position of my two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) qp[h] = q_off + tile_first + (warp * 16 + g + 8 * h) / G;
  // a warpgroup starts its products together: masks and skips go by its 64 rows
  const int qmin_g = q_off + tile_first + (wg * 64) / G;
  const int qmax_g = q_off + tile_first + min(wg * 64 + 63, rows - 1) / G;

  const bool capped = cap_log2 > 0.f;
  float o[DP / 2];  // n8 tiles of the N = DP product; D 96 drops the last four
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int i = 0; i < ntiles; ++i) {
    const int kb = kb0 + i * KT;
    cp_async_wait<STAGES - 2>();
    if constexpr (!RAW) fence_async_proxy();
    __syncthreads();  // tile i landed and visible; everyone is done with tile i - 1
    const int nx = i + STAGES - 1;
    if constexpr (SCALED) {
      // the scales loaded one step ago (for tile nx - 1) have arrived by now:
      // a step's worth of work hid their latency
      if (i > 0 && ld_part < 2) (ld_part ? vs_s : ks_s)[(nx - 1) % STAGES][ld_key] = sc_reg;
    }
    if (nx < ntiles) load_tile(nx % STAGES, kb + (STAGES - 1) * KT);
    cp_async_commit();
    uint32_t k_sa = ring + (i % STAGES) * STAGE_BYTES, v_sa = k_sa + TILE_BYTES;
    if constexpr (RAW) {
      const unsigned char *raw = smem + Q_BYTES + (i % STAGES) * STAGE_BYTES;
      constexpr int RC = D / 16;  // 16-byte chunks of a 1-byte row
      static_assert(2 * RAW_BYTES % (16 * THREADS) == 0, "the conversion deals evenly");
#pragma unroll
      for (int it = 0; it < 2 * RAW_BYTES / 16 / THREADS; ++it) {
        const int idx = tid + it * THREADS;      // K chunks, then V chunks
        const int kv = idx / (RAW_BYTES / 16), row = (idx / RC) % KT, rc = idx % RC;
        const uint4 u = *reinterpret_cast<const uint4 *>(raw + idx * 16);
        const uint2 c0 = to_bf16x4<E>(u.x), c1 = to_bf16x4<E>(u.y);
        const uint2 c2 = to_bf16x4<E>(u.z), c3 = to_bf16x4<E>(u.w);
        unsigned char *dst = smem + Q_BYTES + STAGES * STAGE_BYTES + kv * TILE_BYTES;
        *reinterpret_cast<uint4 *>(dst + swz(KT, row, 2 * rc)) = make_uint4(c0.x, c0.y, c1.x, c1.y);
        *reinterpret_cast<uint4 *>(dst + swz(KT, row, 2 * rc + 1)) = make_uint4(c2.x, c2.y, c3.x, c3.y);
      }
      fence_async_proxy();
      __syncthreads();
      k_sa = cvt_k, v_sa = cvt_v;
    }
    // tiles wholly masked for this warpgroup's rows: above its diagonal, or below the window
    const bool skip = kb > qmax_g || (window > 0 && kb + KT - 1 <= qmin_g - window);
    if (!skip) {
      // ---- S = Q K^T (64 rows x 64 keys a warpgroup): D / 16 k16 steps over
      // the dims, 32 B a step inside a 64-dim half
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16 - (PP_FAULT == 1 ? 1 : 0); ++kk)
        wgmma_s(s, wg_desc(q_sa + (kk >> 2) * (BM * 128) + wg * 64 * 128 + (kk & 3) * 32, 16, 1024),
                wg_desc(k_sa + (kk >> 2) * (KT * 128) + (kk & 3) * 32, 16, 1024), kk);
      wgmma_commit();
      wgmma_wait_all();  // S of this tile, and O of the tile before
      // ---- scores in the exp2 domain; masks only where the tile needs them
      const bool need_mask = kb + KT - 1 > qmin_g || kb + KT > kv_len ||
                             (window > 0 && kb <= qmax_g - window);
      // scale (or cap) every score, then mask in a pass of its own where the
      // tile needs it: with the mask tested inside the scale loop the whole
      // kernel ran a third slower at D 128 (chip_ab_attention.py)
      if (capped) {  // soft-cap: uniform over the launch
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = s[4 * j + e];
            if constexpr (SCALED) v *= ks_s[i % STAGES][j * 8 + tig * 2 + (e & 1)];
            s[4 * j + e] = capped_log2_score(v, cap_log2, scale_cap, scale_log2);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = s[4 * j + e] * scale_log2;
            if constexpr (SCALED) v *= ks_s[i % STAGES][j * 8 + tig * 2 + (e & 1)];  // K dequant: one multiply on the score
            s[4 * j + e] = v;
          }
        }
      }
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pos = kb + j * 8 + tig * 2 + (e & 1), qpos = qp[e >> 1];
            const bool ok = pos <= qpos && pos < kv_len && (window <= 0 || pos > qpos - window);
            s[4 * j + e] = ok ? s[4 * j + e] : NEG;
          }
        }
      }
      float alpha[2], tile_max[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = exp2f(m[h] - m_new);
        tile_max[h] = mx;
        m[h] = m_new;
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row's max moved
        l[0] *= alpha[0], l[1] *= alpha[1];
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          o[4 * j] *= alpha[0], o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1], o[4 * j + 3] *= alpha[1];
        }
      }
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[4 * j + e] - m[e >> 1]);
          if (need_mask) p = s[4 * j + e] > 0.5f * NEG ? p : 0.f;
          l[e >> 1] += p;
          if constexpr (SCALED) p *= vs_s[i % STAGES][j * 8 + tig * 2 + (e & 1)];  // V dequant, after l took p
          s[4 * j + e] = p;
        }
      }
      // While a row's sum is still small, one key's probability can carry a
      // visible share of the output and its bf16 rounding (2^-9 relative)
      // would show against a few keys that cancel. A warpgroup then adds the
      // rounding remainder p - bf16(p), itself rounded to bf16, as a second
      // product. Once every row of the warpgroup has l > LO_RATIO * (largest
      // p of the tile) the remainder is below 2^-9 / sqrt(LO_RATIO) of the
      // output and is dropped: long contexts pay one product a tile.
      bool lo_pass = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lt = l[h];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        lo_pass |= exp2f(tile_max[h] - m[h]) * LO_RATIO >= lt;
      }
      lo_pass = __shfl_sync(0xffffffffu, (int)warpgroup_any(lo_pass, wg), 0) != 0;
      // ---- O += P V: the accumulator fragments of n8 tiles 2 ks, 2 ks + 1
      // are the A fragment of key step ks (16 keys = two 8-key groups of V)
      uint32_t pa[KT / 16][4], pr[KT / 16][4];
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = 2 * ks + (f >> 1), e = 2 * (f & 1);
          pa[ks][f] = pack_bf16(s[4 * j + e], s[4 * j + e + 1]);
          pr[ks][f] = pack_bf16(s[4 * j + e] - bf16_lo(pa[ks][f]),
                                s[4 * j + e + 1] - bf16_hi(pa[ks][f]));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) pv_step(o, pa[ks], v_sa + ks * 2048);
      if (lo_pass) {
#pragma unroll
        for (int ks = 0; ks < KT / 16; ++ks) pv_step(o, pr[ks], v_sa + ks * 2048);
      }
      wgmma_commit();
    }
    // O of this tile must be done before the barrier that lets the ring (or
    // the converted tile, or the scales) be written again
    wgmma_wait_all();
  }
  cp_async_wait<0>();

  // ---- normalise; each warp writes its O rows over its own Q rows (free once
  // every warpgroup's products are done), then stores 16 bytes a lane.
  // Padded rows inside a live tile are exact zeros.
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = (qp[h] < kv_len && lt > 0.f) ? 1.f / lt : 0.f;
    const int r = warp * 16 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < QC; ++j)
      *reinterpret_cast<uint32_t *>(smem + swz(BM, r, j) + tig * 4) =
          pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * QC / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = warp * 16 + idx / QC, ch = idx % QC;
    const int tok = r / G, gq = r - tok * G;
    if (r < rows && tok < ntok)
      *reinterpret_cast<uint4 *>(out_tile + ((size_t)tok * Hq + gq) * D + ch * 8) =
          *reinterpret_cast<const uint4 *>(smem + swz(BM, r, ch));
  }
}

template <typename E, int D>
int launch_prefill(const void *q, const void *k_cache, const void *v_cache, long long k_stride,
                   long long v_stride, const void *k_scale, const void *v_scale,
                   long long scale_stride, const void *block_tables, int bt_stride,
                   const void *q_offsets, const void *kv_lens, void *out, int B, int T, int Hq,
                   int Hkv, int block_size, int window, float sm_scale, float soft_cap,
                   void *stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > MAXG || T <= 0 || B <= 0 || soft_cap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // dynamic shared memory above 48 KB: once per entry
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(paged_prefill_kernel<E, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<D>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int TQ = BM / (Hq / Hkv);
  dim3 grid((T + TQ - 1) / TQ, Hkv, B);
  paged_prefill_kernel<E, D><<<grid, THREADS, Smem<D>::BYTES, st>>>(
      static_cast<const __nv_bfloat16 *>(q), static_cast<const E *>(k_cache),
      static_cast<const E *>(v_cache), k_stride, v_stride,
      static_cast<const __nv_bfloat16 *>(k_scale), static_cast<const __nv_bfloat16 *>(v_scale),
      scale_stride, static_cast<const int *>(block_tables), bt_stride,
      static_cast<const int *>(q_offsets), static_cast<const int *>(kv_lens),
      static_cast<__nv_bfloat16 *>(out), T, Hq, Hkv, block_size, window,
      sm_scale * 1.4426950408889634f, soft_cap > 0.f ? soft_cap * 1.4426950408889634f : 0.f,
      soft_cap > 0.f ? sm_scale / soft_cap : 0.f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry per pool element type and head width, one signature. k_scale /
// v_scale are read by the int8 entries only; the others ignore them.
// soft_cap 0: no cap.
#define PREFILL_ENTRY(NAME, E, D)                                                              \
  extern "C" int NAME(const void *q, const void *k_cache, const void *v_cache,                 \
                      long long k_stride, long long v_stride, const void *k_scale,             \
                      const void *v_scale, long long scale_stride, const void *block_tables,   \
                      int bt_stride, const void *q_offsets, const void *kv_lens, void *out,    \
                      int B, int T, int Hq, int Hkv, int block_size, int window,              \
                      float sm_scale, float soft_cap, void *stream) {                          \
    return launch_prefill<E, D>(q, k_cache, v_cache, k_stride, v_stride, k_scale, v_scale,     \
                                scale_stride, block_tables, bt_stride, q_offsets, kv_lens,     \
                                out, B, T, Hq, Hkv, block_size, window, sm_scale, soft_cap,    \
                                stream);                                                       \
  }

PREFILL_ENTRY(paged_prefill_bf16, __nv_bfloat16, 128)
PREFILL_ENTRY(paged_prefill_i8, int8_t, 128)
PREFILL_ENTRY(paged_prefill_e4m3, __nv_fp8_e4m3, 128)
PREFILL_ENTRY(paged_prefill_bf16_d64, __nv_bfloat16, 64)
PREFILL_ENTRY(paged_prefill_i8_d64, int8_t, 64)
PREFILL_ENTRY(paged_prefill_e4m3_d64, __nv_fp8_e4m3, 64)
PREFILL_ENTRY(paged_prefill_bf16_d96, __nv_bfloat16, 96)
PREFILL_ENTRY(paged_prefill_i8_d96, int8_t, 96)
PREFILL_ENTRY(paged_prefill_e4m3_d96, __nv_fp8_e4m3, 96)
PREFILL_ENTRY(paged_prefill_bf16_d256, __nv_bfloat16, 256)
PREFILL_ENTRY(paged_prefill_i8_d256, int8_t, 256)
PREFILL_ENTRY(paged_prefill_e4m3_d256, __nv_fp8_e4m3, 256)
