// Paged GQA decode attention (T = 1) for Hopper (sm_90a); KV pool in bf16,
// int8 with per-(slot, kv head) scales, or fp8 e4m3.
//
// Replaces the TPU kernels rtp_llm_tpu/ops/attention/pallas_decode.py
// _fullrow_kernel (contexts <= 2048 bucketed tokens) and _decode_kernel
// (longer contexts): one kernel serves both contracts, for any context up to
// max_seq_len. It also replaces _fullrow_kernel's quant mode
// (pallas_decode.py:225-240: an int8 pool whose dequantization is two
// multiplies, the K scale on the scores and the V scale on the
// probabilities) and its fp8 pool (:326-335, storage only, upcast on read).
// The element type and the head width D (64, 96, 128 or 256) are template
// parameters; the entries paged_decode_{bf16,i8,e4m3} (D 128) and their
// _d64 / _d96 / _d256 forms share one body. The JAX package runs its Pallas
// kernels at D 128 and 256 (rtp_llm_tpu/ops/attention/__init__.py, d % 128
// == 0) and serves D 64 and 96 through its plain XLA path; the port has no
// plain path on the card, so the kernel takes every width.
//
// Logit soft-cap (gemma2): with soft_cap > 0 every score, the deferred
// current token's too, is s = cap * tanh(q . K * sm_scale / cap) before the
// softmax. The JAX package sends a capped model to its XLA plain path
// (rtp_llm_tpu/ops/attention/ref.py); here it is a runtime mode of the same
// kernel, a branch uniform over the launch: the uncapped scores take the
// code they took before. tanhf (not tanh.approx, whose 2^-11 relative error a
// cap of 50 would turn into ~0.025 on a score) in f32, then the exp2 domain.
//
// What it computes: for every row b and query head h,
//   out[b, h] = softmax_p( q[b, h] . K[p] * sm_scale ) @ V[p]
// over the row's cached positions p in [max(kv_len - window, 0), cached),
// cached = kv_len - 1 when the current token arrives in cur_k / cur_v (it is
// then folded in as one more column at position kv_len - 1), else kv_len.
// K[p] / V[p] live in the paged pool [NS, Hkv*D] at slot
// block_table[b, p / block_size] * block_size + p % block_size, read at kv
// head h / G (G = Hq / Hkv). Rows with kv_len == 0 give zeros.
// With an int8 pool, ks[p] / vs[p] being the bf16 scales of that slot and kv
// head,
//   out[b, h] = sum_p softmax_p( q . K8[p] * ks[p] * sm_scale ) * vs[p] * V8[p]
// where the softmax normaliser sums the unscaled probabilities. The deferred
// current token always arrives in bf16, unquantized.
//
// What bounds it on the H100: bytes. Every K and V row of the live context
// is read once per kv head (2 * Hkv * D * 2 B per token and layer); the
// arithmetic is ~2 FLOP per byte, far below the card's ~295 FLOP/B ridge.
// A 1-byte pool halves those bytes (plus 2 * Hkv * 2 B of scales a token for
// int8) and doubles the operations per byte, still far below the ridge. So
// the design keeps as many bytes in flight as the SMs can hold and spends
// few instructions a byte.
//
// The design:
//  * One block of four warps per (context split, kv head, row) handles all
//    G <= 8 query heads of that kv head, so each K/V row is read from device
//    memory once (no zero-expanded Hq x Hkv*D query as on the TPU).
//  * Each warp works alone. It walks its own 16-token strips of the split
//    (strips j0 + w, j0 + w + 4, ...) through its own cp.async ring in
//    dynamic shared memory and keeps its own online-softmax state; nothing
//    but __syncwarp orders a strip. A bf16 ring has 3 stages (K and V strips
//    of 8 KB): two strips in flight while the warp computes the third, 96 KB
//    a block, two blocks a multiprocessor. A 1-byte ring has 2 stages of
//    4 KB, 48-50 KB a block, four blocks a multiprocessor: there more warps
//    beat a deeper ring, as the upcasts make a strip's work longer. A
//    multiprocessor holds as many blocks as its 228 KB fit, up to those
//    counts (Ring::BLOCKS): at D 256 a bf16 ring's strips are 16 KB and a
//    block (192 KB) is alone on its multiprocessor, with the same 128 KB in
//    flight as two D 128 blocks; a 1-byte block (98 KB) has a neighbour.
//  * 16-byte cp.async through the block table, one table read a token per
//    strip, made one strip ahead and handed round by shuffles. Rows outside
//    [lo, cached) use the zero-fill form (source size 0): nothing is read from
//    a dead slot, and a zero probability never meets garbage V rows. Rows are
//    stored with the 16-byte chunk index XORed with (row & 7), so ldmatrix
//    reads are conflict-free.
//    A row of D elements lies in the ring at a pitch of whole 128-byte lines
//    (D 96 bf16: 192 bytes in a 256-byte pitch; a 1-byte pool's 64 or 96 in
//    128), so the XOR stays inside the row's own chunks and ldmatrix stays
//    conflict-free at every D.
//  * Tensor cores, mma.sync.m16n8k16 (bf16 -> f32): tokens on M, the G query
//    heads of the kv head on N (G = 8 wastes nothing, 7 one column, 4 half).
//    S^T (16 tokens x 8 heads) = K . Q^T over D / 16 k-steps: K by ldmatrix
//    from the ring, Q^T as B fragments held in registers for the whole
//    block. O^T (D dims x 8
//    heads) += V^T . P^T: V by ldmatrix.trans, P^T from the S^T accumulator
//    by movmatrix.trans (no shared-memory round trip).
//  * 1-byte pools are upcast in registers, exactly (int8 by the 2^23 magic
//    number, e4m3 through f16): K between ldmatrix and mma (a 16-byte row
//    chunk is 16 dims, so a k16 step takes dims 4 tig .. 4 tig + 3 of its
//    chunk in the order the Q fragments are loaded in), V in one pass into a
//    bf16 strip in the warp's own buffer, read back by ldmatrix.trans.
//  * int8 scales are 2-byte elements, which cp.async cannot move: lanes 0-15
//    copy the K scales and 16-31 the V scales of a strip as the 4-byte words
//    that hold them (cp.async, zero-filled for a dead row: its slot may hold
//    NaN), with the strip, and note which half is theirs; a plain load would
//    stall the warp on its latency. The K scale multiplies the score in f32;
//    the V scale multiplies p after l took it, before P is rounded.
//  * Online softmax in f32 in the exp2 domain; a warp's max key has p = 1
//    exactly. P is rounded to bf16 for the product; while a warp's sum is
//    small against its strip's largest p (few keys, whose V rows may cancel)
//    the remainder p - bf16(p) goes through a second product, as in
//    paged_prefill.cu.
//  * At the end the four warps' (m, l, O) and the deferred current token (in
//    the context's last split, in f32) are merged through shared memory; one
//    thread a dim (two at D 256) writes the output, or the split's partial
//    state, which a second small kernel merges across splits.
//  * D 256: O^T is 16 m-tiles (64 f32 a lane) and Q^T 16 k-steps of B
//    fragments (32 registers); one block a multiprocessor leaves 255
//    registers a thread. G = 1 (MHA, Gemma-7B) fills one of mma's 8 N
//    columns: right, and an eighth of the tensor work useful; the bytes, not
//    the products, bound it all the same.
// Not yet: a split plan that looks at kv_lens on the device (the plan is a
// function of shapes, the engine buckets the table width), the split merge
// folded into the last block, TMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Built-in faults for the smoke run's check (0 in every served build):
//  1: strips computed from the ring stage of the wrong parity;
//  2: dead rows read from their slots instead of zero-filled;
//  3: the remainder product left out;
//  4: the last k16 step of S = K . Q^T left out (the head width's tail);
//  5: the soft-cap's tanh left out (capped scores taken as scaled scores).
#ifndef PD_FAULT
#define PD_FAULT 0
#endif

namespace {

constexpr int STRIP = 16;     // tokens a warp computes at a time: mma's M
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAXG = 8;       // query heads of one kv head: mma's N
constexpr float NEG = -1e30f;
constexpr float LO_RATIO = 64.f;  // see the remainder product in the kernel
constexpr unsigned FULL = 0xffffffffu;

constexpr int SM_SMEM = 233472;   // shared memory of a multiprocessor (228 KB)
constexpr int BLOCK_RESERVED = 1024;  // what the runtime keeps of it a block

// bytes a row of `bytes` takes in shared memory: whole 128-byte lines
constexpr int pitch_of(int bytes) { return (bytes + 127) / 128 * 128; }
constexpr int min_of(int a, int b) { return a < b ? a : b; }

// One warp's share of the dynamic shared memory, by pool element type and
// head width, and the blocks a multiprocessor holds (ops/attention/decode.py
// BLOCKS_PER_SM).
template <typename E, int D> struct Ring {
  static constexpr int ROW = D * (int)sizeof(E);           // bytes of one pool row
  static constexpr int PITCH = pitch_of(ROW);              // ... in the ring
  static constexpr int BPITCH = pitch_of(2 * D);           // a bf16 row's (the V strip's)
  static constexpr int TILE = STRIP * PITCH;               // one K or V strip
  static constexpr int STAGE = 2 * TILE;                   // K strip, then V strip
  static constexpr int STAGES = sizeof(E) == 2 ? 3 : 2;
  static constexpr int CONV = sizeof(E) == 1 ? STRIP * BPITCH : 0;  // V strip upcast to bf16
  // int8: a stage's scale words (cp.async) and the shift that picks each one's half
  static constexpr int SCALES = std::is_same<E, int8_t>::value ? STAGES * 32 * 8 : 0;
  static constexpr int WARP_BYTES = STAGES * STAGE + CONV + SCALES;  // D 128: 24 KB, 12-12.5 KB
  static constexpr int SMEM = WARPS * WARP_BYTES + 128;    // + alignment slack
  // as many blocks as the multiprocessor's shared memory fits, at most 2
  // (bf16) or 4 (1-byte): D 256 bf16 1, 1-byte 2
  static constexpr int BLOCKS =
      min_of(sizeof(E) == 2 ? 2 : 4, SM_SMEM / (SMEM + BLOCK_RESERVED));
  static_assert(BLOCKS >= 1, "one block fits a multiprocessor");
};

// byte offset of 16-byte chunk c of row r in a strip of rows PITCH bytes
// apart (a multiple of 128: the XOR stays inside c's own group of eight)
template <int PITCH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(PITCH % 128 == 0, "rows are whole 128-byte lines");
  return (uint32_t)(r * PITCH + ((c & ~7) | ((c ^ r) & 7)) * 16);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void *src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void *src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// the 8 x 8 b16 matrix held in mma fragment layout, transposed
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (bits 0..15)
  return *reinterpret_cast<uint32_t *>(&v);
}
// the two bf16 halves of a packed pair, as f32
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// a score q . K (dequantized) in the exp2 domain: x * sm_scale * log2 e, or
// with a soft-cap cap * tanh(x * sm_scale / cap) * log2 e (cap_log2 = cap *
// log2 e, scale_cap = sm_scale / cap; cap_log2 == 0: no cap)
__device__ __forceinline__ float log2_score(float x, float scale_log2, float cap_log2,
                                            float scale_cap) {
#if PD_FAULT == 5
  return x * scale_log2;
#else
  return cap_log2 > 0.f ? cap_log2 * tanhf(x * scale_cap) : x * scale_log2;
#endif
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
// max / sum over the eight lanes of a quad column (lanes tig, tig + 4, ...)
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// four 1-byte pool elements (one 32-bit word) -> four bf16, exactly:
// .x holds elements 0, 1 and .y elements 2, 3
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
__global__ void __launch_bounds__(THREADS, (Ring<E, D>::BLOCKS))
paged_decode_kernel(const __nv_bfloat16 *__restrict__ q,        // [B, Hq, D]
                    const E *__restrict__ k_cache,              // rows of k_stride elems
                    const E *__restrict__ v_cache,
                    long long k_stride, long long v_stride,
                    const __nv_bfloat16 *__restrict__ k_scale,  // int8: rows of scale_stride
                    const __nv_bfloat16 *__restrict__ v_scale,  // elems, [.., Hkv]; else null
                    long long scale_stride,
                    const int *__restrict__ block_tables, int bt_stride,
                    const int *__restrict__ kv_lens,
                    const __nv_bfloat16 *__restrict__ cur_k,    // [B, cur_stride] or null
                    const __nv_bfloat16 *__restrict__ cur_v,
                    long long cur_stride,
                    __nv_bfloat16 *__restrict__ out,            // [B, Hq, D]
                    float *__restrict__ ws_o,                   // [B, Hq, S, D] (S > 1)
                    float *__restrict__ ws_ml,                  // [B, Hq, S, 2]
                    int Hq, int Hkv, int block_size, int window,
                    float scale_log2, float cap_log2, float scale_cap, int num_splits) {
  using R = Ring<E, D>;
  constexpr bool BYTE = sizeof(E) == 1;
  constexpr bool SCALED = std::is_same<E, int8_t>::value;
  constexpr int EPC = 16 / (int)sizeof(E);    // elements a 16-byte chunk
  constexpr int CPR = R::ROW / 16;            // chunks a pool row: D / 8 or D / 16
  constexpr int CPL = STRIP * CPR / 32;       // chunks a lane copies of a K (or V) strip
  constexpr int ST = R::STAGES;
  constexpr int OP = D + 4;                   // f32 pitch of the merge buffer: conflict-free stores
  static_assert(D % 32 == 0 && D <= 256, "head width: a multiple of 32, at most 256");
  static_assert(STRIP * CPR % 32 == 0, "a strip's chunks deal evenly over the lanes");
  static_assert(WARPS * MAXG * (OP + 2) * 4 + MAXG * 4 <= WARPS * R::WARP_BYTES,
                "the merge buffer reuses the rings");

  extern __shared__ unsigned char smem_raw[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;    // fragment row group and column pair
  const int lm = lane >> 3, lr = lane & 7;    // ldmatrix: this lane's matrix and row
  const int G = Hq / Hkv, h0 = kvh * G;

  const int kv_len = kv_lens[b];
  const bool has_cur = cur_k != nullptr;
  const int cached = has_cur ? max(kv_len - 1, 0) : kv_len;
  const int lo = window > 0 ? max(kv_len - window, 0) : 0;
  // strips [s_lo, s_hi) cover the live range; a split takes `per` of them
  // and its warps deal them round-robin (ops/attention/decode.py split_strips)
  const int s_lo = lo / STRIP;
  const int s_hi = cached > lo ? (cached + STRIP - 1) / STRIP : s_lo;
  const int per = (s_hi - s_lo + num_splits - 1) / num_splits;
  const int j0 = min(s_lo + split * per, s_hi);
  const int j1 = min(j0 + per, s_hi);
  const int mine = j1 - j0 > warp ? (j1 - j0 - warp + WARPS - 1) / WARPS : 0;

  const uint32_t raw_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw_base + 127u) & ~127u;
  unsigned char *smem = smem_raw + (sbase - raw_base);
  const uint32_t ring = sbase + warp * R::WARP_BYTES;
  const uint32_t conv = ring + ST * R::STAGE;  // 1-byte pools: the V strip in bf16
  const uint32_t sc_sa = conv + R::CONV;        // int8: [ST][32] scale words
  uint32_t *sc_shift = reinterpret_cast<uint32_t *>(smem + (sc_sa - sbase) + ST * 32 * 4);

  // Q^T as the B fragments of the D / 16 k16 steps: column n = g is query head
  // h0 + g (zeros past G). k step kk covers dims 16 kk .. 16 kk + 15; a bf16
  // pool takes dims 2 tig, 2 tig + 1 | + 8, a 1-byte pool 4 tig .. 4 tig + 3,
  // the order its upcast K fragments come in.
  uint32_t qf[D / 16][2];
  {
    const bool live = g < G;
    const __nv_bfloat16 *qr = q + ((size_t)b * Hq + h0 + (live ? g : 0)) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (BYTE) {
        const uint2 u = live ? *reinterpret_cast<const uint2 *>(qr + 16 * kk + 4 * tig)
                             : make_uint2(0u, 0u);
        qf[kk][0] = u.x, qf[kk][1] = u.y;
      } else {
        qf[kk][0] = live ? *reinterpret_cast<const uint32_t *>(qr + 16 * kk + 2 * tig) : 0u;
        qf[kk][1] = live ? *reinterpret_cast<const uint32_t *>(qr + 16 * kk + 8 + 2 * tig) : 0u;
      }
    }
  }

  // ---- the ring: slot of token (lane & 15) of strip j, -1 for a dead row
  const int *bt = block_tables + (size_t)b * bt_stride;
  auto slot_of = [&](int j) -> long long {
    const int pos = j * STRIP + (lane & (STRIP - 1));
#if PD_FAULT == 2
    const int idx = min(pos / block_size, bt_stride - 1);  // fault: dead rows read too
    return (long long)bt[idx] * block_size + pos % block_size;
#else
    if (pos < lo || pos >= cached) return -1;
    return (long long)bt[pos / block_size] * block_size + pos % block_size;
#endif
  };
  // copies of one strip into `stage`; int8: lanes 0-15 also copy the K scale
  // and 16-31 the V scale of token lane & 15, as the 4-byte word that holds
  // it, and note which half it is
  auto issue = [&](int stage, long long my_slot) {
    const uint32_t st = ring + stage * R::STAGE;
#pragma unroll
    for (int it = 0; it < CPL; ++it) {
      const int idx = lane + 32 * it, r = idx / CPR, c = idx % CPR;
      const long long slot = __shfl_sync(FULL, my_slot, r);
      const long long s = slot >= 0 ? slot : 0;
      cp_async16(st + swz<R::PITCH>(r, c), k_cache + s * k_stride + kvh * D + c * EPC, slot >= 0);
      cp_async16(st + R::TILE + swz<R::PITCH>(r, c), v_cache + s * v_stride + kvh * D + c * EPC,
                 slot >= 0);
    }
    if constexpr (SCALED) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          (lane < 16 ? k_scale : v_scale) + (my_slot >= 0 ? my_slot : 0) * scale_stride + kvh);
      cp_async4(sc_sa + (stage * 32 + lane) * 4, reinterpret_cast<const void *>(a & ~uintptr_t(3)),
                my_slot >= 0);
      sc_shift[stage * 32 + lane] = (a & 2) ? 0 : 16;  // left shift: the scale to the high half
    }
  };

  float o[D / 16][4];  // O^T: dims 16 mt + g (+ 8) x heads 2 tig, 2 tig + 1
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // heads 2 tig, 2 tig + 1; l over the warp

  // one commit group per ring slot, empty past the end, so that
  // wait_group<ST - 2> always means "strip i has landed"
  long long nslot = mine > 0 ? slot_of(j0 + warp) : -1;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < mine) {
      issue(s, nslot);
      nslot = s + 1 < mine ? slot_of(j0 + warp + (s + 1) * WARPS) : -1;
    }
    cp_async_commit();
  }

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<ST - 2>();
    __syncwarp();  // strip i landed for the whole warp; every lane is done with strip i - 1
    const int cs = (i + (PD_FAULT == 1 ? 1 : 0)) % ST;
    float sc_now = 0.f;  // int8: this lane's scale of strip i
    if constexpr (SCALED) {
      const uint32_t w =
          *reinterpret_cast<const uint32_t *>(smem + (sc_sa - sbase) + (cs * 32 + lane) * 4);
      sc_now = __uint_as_float((w << sc_shift[cs * 32 + lane]) & 0xFFFF0000u);
    }
    const int nx = i + ST - 1;
    if (nx < mine) {
      issue(nx % ST, nslot);
      nslot = nx + 1 < mine ? slot_of(j0 + warp + (nx + 1) * WARPS) : -1;
    }
    cp_async_commit();
    const uint32_t kst = ring + cs * R::STAGE, vst = kst + R::TILE;
    const int j = j0 + warp + i * WARPS;

    // ---- S^T = K . Q^T: 16 tokens x 8 heads, f32
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (BYTE) {
      // one ldmatrix.x4 = tokens 0-7 / 8-15 of chunks 2 c2, 2 c2 + 1; a
      // lane's word is dims 4 tig .. 4 tig + 3 of its chunk
#pragma unroll
      for (int c2 = 0; c2 < D / 32; ++c2) {
        uint32_t w[4];
        ldsm4(w, kst + swz<R::PITCH>((lm & 1) * 8 + lr, 2 * c2 + (lm >> 1)));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 r0 = to_bf16x4<E>(w[2 * h]), r1 = to_bf16x4<E>(w[2 * h + 1]);
          const uint32_t a[4] = {r0.x, r1.x, r0.y, r1.y};
          if (PD_FAULT != 4 || 2 * c2 + h < D / 16 - 1) mma_bf16(c, a, qf[2 * c2 + h]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm4(a, kst + swz<R::PITCH>((lm & 1) * 8 + lr, 2 * kk + (lm >> 1)));
        if (PD_FAULT != 4 || kk < D / 16 - 1) mma_bf16(c, a, qf[kk]);
      }
    }

    // ---- scores in the exp2 domain; tokens g (c0, c1) and g + 8 (c2, c3)
    const int p0 = j * STRIP + g, p1 = p0 + 8;
    const bool ok[2] = {p0 >= lo && p0 < cached, p1 >= lo && p1 < cached};
    float ks[2] = {1.f, 1.f}, vs[2] = {1.f, 1.f};
    if constexpr (SCALED) {
      ks[0] = __shfl_sync(FULL, sc_now, g), ks[1] = __shfl_sync(FULL, sc_now, g + 8);
      vs[0] = __shfl_sync(FULL, sc_now, 16 + g), vs[1] = __shfl_sync(FULL, sc_now, 24 + g);
    }
    float s[4], p[4], mx[2], alpha[2];
    if (cap_log2 > 0.f) {  // soft-cap: uniform over the launch
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[e] = ok[e >> 1] ? log2_score(c[e] * ks[e >> 1], scale_log2, cap_log2, scale_cap) : NEG;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[e] = ok[e >> 1] ? c[e] * ks[e >> 1] * scale_log2 : NEG;  // K dequant on the score
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = col_max(fmaxf(s[h], s[2 + h]));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = ok[e >> 1] ? exp2f(s[e] - m[e & 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + col_sum(p[h] + p[2 + h]);
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      o[mt][0] *= alpha[0], o[mt][1] *= alpha[1];
      o[mt][2] *= alpha[0], o[mt][3] *= alpha[1];
    }
    // While a warp's sum is still small, one key's probability carries a
    // visible share of its output and the bf16 rounding of P (2^-9 relative)
    // would show against a few V rows that cancel: the warp then adds the
    // remainder p - bf16(p), itself rounded to bf16, as a second product.
    // Once l > LO_RATIO * (largest p of the strip) for every live head it is
    // dropped: long contexts pay one product a strip.
    bool small = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) small |= 2 * tig + h < G && exp2f(mx[h] - m[h]) * LO_RATIO >= l[h];
    const bool lo_pass = __any_sync(FULL, small) && PD_FAULT != 3;
    if constexpr (SCALED) {  // V dequant: on p, after l took it
      p[0] *= vs[0], p[1] *= vs[0], p[2] *= vs[1], p[3] *= vs[1];
    }
    // P^T as the B fragment: (tokens g | g + 8, heads 2 tig, 2 tig + 1)
    // transposed is (tokens 2 tig, 2 tig + 1 | + 8, head g)
    const uint32_t hi0 = pack_bf16(p[0], p[1]), hi1 = pack_bf16(p[2], p[3]);
    const uint32_t bh[2] = {movtrans(hi0), movtrans(hi1)};
    uint32_t bl[2] = {0u, 0u};
    if (lo_pass) {
      bl[0] = movtrans(pack_bf16(p[0] - bf16_lo(hi0), p[1] - bf16_hi(hi0)));
      bl[1] = movtrans(pack_bf16(p[2] - bf16_lo(hi1), p[3] - bf16_hi(hi1)));
    }

    // ---- O^T += V^T . P^T: D / 16 m16 tiles of dims, k = the strip's 16 tokens
    uint32_t vt = vst;
    if constexpr (BYTE) {
      // the landed 1-byte V strip -> a bf16 strip in this warp's buffer
      const unsigned char *raw = smem + (vst - sbase);
      unsigned char *cv = smem + (conv - sbase);
#pragma unroll
      for (int it = 0; it < STRIP * CPR / 32; ++it) {
        const int idx = lane + 32 * it, r = idx / CPR, rc = idx % CPR;
        const uint4 u = *reinterpret_cast<const uint4 *>(raw + swz<R::PITCH>(r, rc));
        const uint2 e0 = to_bf16x4<E>(u.x), e1 = to_bf16x4<E>(u.y);
        const uint2 e2 = to_bf16x4<E>(u.z), e3 = to_bf16x4<E>(u.w);
        *reinterpret_cast<uint4 *>(cv + swz<R::BPITCH>(r, 2 * rc)) =
            make_uint4(e0.x, e0.y, e1.x, e1.y);
        *reinterpret_cast<uint4 *>(cv + swz<R::BPITCH>(r, 2 * rc + 1)) =
            make_uint4(e2.x, e2.y, e3.x, e3.y);
      }
      __syncwarp();
      vt = conv;
    }
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      // matrices: tokens 0-7 / 8-15 (lm >> 1) of dim chunks 2 mt, 2 mt + 1 (lm & 1)
      uint32_t a[4];
      ldsm4_t(a, vt + swz<R::BPITCH>((lm >> 1) * 8 + lr, 2 * mt + (lm & 1)));
      mma_bf16(o[mt], a, bh);
      if (lo_pass) mma_bf16(o[mt], a, bl);
    }
  }
  cp_async_wait<0>();

  // ---- merge the four warps (and the deferred current token) in f32
  __syncthreads();  // every ring is done: the merge buffer reuses them
  float *o_s = reinterpret_cast<float *>(smem);  // [WARPS][MAXG][OP]
  float *ml_s = o_s + WARPS * MAXG * OP;          // [WARPS][MAXG][2]: m, l
  float *cur_s = ml_s + WARPS * MAXG * 2;         // [MAXG]: the current token's score
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_s[(warp * MAXG + 2 * tig + (e & 1)) * OP + 16 * mt + g + 8 * (e >> 1)] = o[mt][e];
  if (g == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml_s[(warp * MAXG + 2 * tig + h) * 2] = m[h];
      ml_s[(warp * MAXG + 2 * tig + h) * 2 + 1] = l[h];
    }
  }
  const bool fold_cur = has_cur && split == num_splits - 1 && kv_len > 0;
  if (fold_cur) {
    const __nv_bfloat16 *ck = cur_k + (size_t)b * cur_stride + kvh * D;
    for (int hh = warp; hh < G; hh += WARPS) {
      const __nv_bfloat16 *qr = q + ((size_t)b * Hq + h0 + hh) * D;
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += __bfloat162float(qr[d]) * __bfloat162float(ck[d]);
      part = warp_sum(part);
      if (lane == 0) cur_s[hh] = log2_score(part, scale_log2, cap_log2, scale_cap);
    }
  }
  __syncthreads();
  // one thread a dim (D < THREADS leaves the rest idle, D 256 takes two each)
  for (int d = tid; d < D; d += THREADS) {
    for (int h = 0; h < G; ++h) {
      float M = fold_cur ? cur_s[h] : NEG;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ml_s[(w * MAXG + h) * 2]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wt = exp2f(ml_s[(w * MAXG + h) * 2] - M);
        L += ml_s[(w * MAXG + h) * 2 + 1] * wt;
        O += o_s[(w * MAXG + h) * OP + d] * wt;
      }
      if (fold_cur) {
        const float pc = exp2f(cur_s[h] - M);
        L += pc;
        O += pc * __bfloat162float(cur_v[(size_t)b * cur_stride + kvh * D + d]);
      }
      if (num_splits == 1) {
        out[((size_t)b * Hq + h0 + h) * D + d] =
            __float2bfloat16((kv_len > 0 && L > 0.f) ? O / L : 0.f);
      } else {
        const size_t hs = ((size_t)b * Hq + h0 + h) * num_splits + split;
        ws_o[hs * D + d] = O;
        if (d == 0) {
          ws_ml[hs * 2] = M;
          ws_ml[hs * 2 + 1] = L;
        }
      }
    }
  }
}

// Merge the context splits' partial online-softmax states.
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_combine(const float *__restrict__ ws_o, const float *__restrict__ ws_ml,
                     const int *__restrict__ kv_lens, __nv_bfloat16 *__restrict__ out,
                     int Hq, int num_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t base = ((size_t)b * Hq + h) * num_splits;
  float M = NEG;
  for (int s = 0; s < num_splits; ++s) M = fmaxf(M, ws_ml[(base + s) * 2]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const float w = exp2f(ws_ml[(base + s) * 2] - M);
    L += ws_ml[(base + s) * 2 + 1] * w;
    o += ws_o[(base + s) * D + d] * w;
  }
  const float r = (kv_lens[b] > 0 && L > 0.f) ? o / L : 0.f;
  out[((size_t)b * Hq + h) * D + d] = __float2bfloat16(r);
}

template <typename T, int D>
int launch_decode(const void *q, const void *k_cache, const void *v_cache, long long k_stride,
                  long long v_stride, const void *k_scale, const void *v_scale,
                  long long scale_stride, const void *block_tables, int bt_stride,
                  const void *kv_lens, const void *cur_k, const void *cur_v,
                  long long cur_stride, void *out, void *ws_o, void *ws_ml, int B, int Hq,
                  int Hkv, int block_size, int window, float sm_scale, float soft_cap,
                  int num_splits, void *stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > MAXG || B <= 0 || block_size <= 0 || num_splits <= 0 ||
      soft_cap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // dynamic shared memory above 48 KB: once per entry
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<T, D>::SMEM);
    if (e == cudaSuccess)  // several blocks a multiprocessor need the largest carveout
      e = cudaFuncSetAttribute(paged_decode_kernel<T, D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  const float cap_log2 = soft_cap > 0.f ? soft_cap * 1.4426950408889634f : 0.f;
  const float scale_cap = soft_cap > 0.f ? sm_scale / soft_cap : 0.f;
  dim3 grid(num_splits, Hkv, B);
  paged_decode_kernel<T, D><<<grid, THREADS, Ring<T, D>::SMEM, st>>>(
      static_cast<const __nv_bfloat16 *>(q), static_cast<const T *>(k_cache),
      static_cast<const T *>(v_cache), k_stride, v_stride,
      static_cast<const __nv_bfloat16 *>(k_scale), static_cast<const __nv_bfloat16 *>(v_scale),
      scale_stride, static_cast<const int *>(block_tables), bt_stride,
      static_cast<const int *>(kv_lens), static_cast<const __nv_bfloat16 *>(cur_k),
      static_cast<const __nv_bfloat16 *>(cur_v), cur_stride, static_cast<__nv_bfloat16 *>(out),
      static_cast<float *>(ws_o), static_cast<float *>(ws_ml), Hq, Hkv, block_size, window,
      scale_log2, cap_log2, scale_cap, num_splits);
  if (num_splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    paged_decode_combine<D><<<dim3(Hq, B), D, 0, st>>>(
        static_cast<const float *>(ws_o), static_cast<const float *>(ws_ml),
        static_cast<const int *>(kv_lens), static_cast<__nv_bfloat16 *>(out), Hq, num_splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry per pool element type and head width, one signature. k_scale /
// v_scale are read by the int8 entries only; the others ignore them.
// soft_cap 0: no cap.
#define DECODE_ENTRY(NAME, T, D)                                                              \
  extern "C" int NAME(const void *q, const void *k_cache, const void *v_cache,                \
                      long long k_stride, long long v_stride, const void *k_scale,            \
                      const void *v_scale, long long scale_stride, const void *block_tables,  \
                      int bt_stride, const void *kv_lens, const void *cur_k,                  \
                      const void *cur_v, long long cur_stride, void *out, void *ws_o,          \
                      void *ws_ml, int B, int Hq, int Hkv, int block_size, int window,         \
                      float sm_scale, float soft_cap, int num_splits, void *stream) {          \
    return launch_decode<T, D>(q, k_cache, v_cache, k_stride, v_stride, k_scale, v_scale,     \
                               scale_stride, block_tables, bt_stride, kv_lens, cur_k, cur_v,  \
                               cur_stride, out, ws_o, ws_ml, B, Hq, Hkv, block_size, window,  \
                               sm_scale, soft_cap, num_splits, stream);                       \
  }

DECODE_ENTRY(paged_decode_bf16, __nv_bfloat16, 128)
DECODE_ENTRY(paged_decode_i8, int8_t, 128)
DECODE_ENTRY(paged_decode_e4m3, __nv_fp8_e4m3, 128)
DECODE_ENTRY(paged_decode_bf16_d64, __nv_bfloat16, 64)
DECODE_ENTRY(paged_decode_i8_d64, int8_t, 64)
DECODE_ENTRY(paged_decode_e4m3_d64, __nv_fp8_e4m3, 64)
DECODE_ENTRY(paged_decode_bf16_d96, __nv_bfloat16, 96)
DECODE_ENTRY(paged_decode_i8_d96, int8_t, 96)
DECODE_ENTRY(paged_decode_e4m3_d96, __nv_fp8_e4m3, 96)
DECODE_ENTRY(paged_decode_bf16_d256, __nv_bfloat16, 256)
DECODE_ENTRY(paged_decode_i8_d256, int8_t, 256)
DECODE_ENTRY(paged_decode_e4m3_d256, __nv_fp8_e4m3, 256)
