// act_quant: per-token int8 activation codes and scales on Hopper (sm_90a),
// the activation side of W8A8 and W4A8 (i8_gemm.cu):
//   scale[m] = max(amax_k |x[m, k]|, 1e-8) / 127
//   q[m, k]  = clip(rint(x[m, k] / scale[m]), -127, 127)
//
// Replaces no Pallas kernel: quantize_activations_per_token
// (rtp_llm_tpu/quant/weight_only.py:157-163) is an XLA fusion there. The
// codes and scales equal the plain version's bit for bit: the scale is a
// true IEEE division, the codes round half to even as if by a true division
// (see "the quantize" below).
//
// What bounds it: bytes, 2 B read and 1 B written an element (a 2048-row
// prefill into the Qwen2-7B down projection, K = 18944: 116 MB, 0.035 ms at
// 3.35 TB/s). At that rate the card moves 1.12 T elements a second and
// issues about 33.5 T lane-instructions (132 SMs x 4 schedulers x 32 lanes
// at 1.98 GHz): some 30 instructions an element is the whole budget, so the
// kernel has to be lean in instructions as well as in bytes.
//
// The design:
// * One read of each row. A row is cut into 8-element chunks, 16 bytes of
//   bf16; the row spans `warps` warps (T threads), thread t holding chunks
//   t, t + T, ..., VPT of them (a template parameter) in registers from the
//   amax to the codes. act_plan (ops/quant_gemm8.py) picks VPT, the warps a
//   row and the rows a block; `launch` says which VPT are built. A row
//   longer than 16 warps x 16 chunks x 32 lanes (K > 65536) is taken in
//   rounds, the last kept in registers, the earlier ones read again.
// * The amax in packed bf16 within a thread (__habs2, __hmax2: exact, the
//   max of bf16 values is one of them), to f32 once, then warp shuffles,
//   then one exchange through shared memory where a row spans warps. Every
//   thread of the row reduces the row's few warp maxima itself.
// * A short exact quantize: t = x * rn(1/s), rounded half to even by adding
//   1.5 * 2^23 (the code is the low byte of the sum's bits). The clip never
//   binds: |x| <= amax, so |t| and the quotient stay below 127 * (1 +
//   2^-21), which rounds to 127 at most. Both t and the correctly rounded
//   quotient lie within 2e-5 of x / s, so they round alike unless t lies
//   within 2^-10 of a half-integer; a chunk holding such an element is
//   quantized again by true division (__fdiv_rn), out of line. Of the
//   2,088,896 pairs of a bf16 amax in [1, 2) and a bf16 x in (0, amax], 466
//   lie in the band and 24 would round the other way without it, each at
//   x = amax / 2 (quotient 63.5; tests/test_torch_quant8.py emulates this).
//   A true division of every element (the build with ACT_DIVIDE_ALL=1,
//   which chip_smoke.py times beside this one) took 1.4-1.9x the time at
//   K = 3584 and at 64 rows on an H100 (2-5% less at K = 18944 from 1000
//   rows).
// * Codes packed with __byte_perm and stored 8 bytes a chunk, coalesced;
//   one thread a row writes the scale.
// * Ragged input (K % 8, a row stride % 8 or a pointer not 16-byte aligned)
//   takes a scalar path of the same kernel (VEC false): 2-byte loads and
//   byte stores, masked at K.
//
// Planted faults for chip_smoke.py, each built under its own define value:
//   ACT_FAULT=1  a row's amax without its last warp (without each thread's
//                first chunk where a row is one warp);
//   ACT_FAULT=2  the fast quantize without its near-half escape;
//   ACT_FAULT=3  the scalar path drops a row's last element (read as 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifndef ACT_FAULT
#define ACT_FAULT 0
#endif
#ifndef ACT_DIVIDE_ALL
#define ACT_DIVIDE_ALL 0
#endif

namespace {

constexpr int MAX_THREADS = 512, MAX_WARPS = MAX_THREADS / 32, VPT_MAX = 16;
constexpr float ROUNDER = 12582912.0f;        // 1.5 * 2^23
constexpr float NEAR_HALF = 0.5f - 0x1p-10f;  // |t - rint(t)| above this: take the division

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return h;
}

__device__ __forceinline__ __nv_bfloat162 absmax8(const uint4 &v, __nv_bfloat162 m) {
  m = __hmax2(m, __habs2(as_bf2(v.x)));
  m = __hmax2(m, __habs2(as_bf2(v.y)));
  m = __hmax2(m, __habs2(as_bf2(v.z)));
  return __hmax2(m, __habs2(as_bf2(v.w)));
}

// x * rcp plus ROUNDER: the code is the low byte of the result's bits.
// `near` is set where t lies within 2^-10 of a half-integer.
__device__ __forceinline__ uint32_t fast_code(float x, float rcp, bool &near) {
  const float t = __fmul_rn(x, rcp);
  const float u = __fadd_rn(t, ROUNDER);
  if (ACT_FAULT != 2) near |= fabsf(__fsub_rn(t, __fsub_rn(u, ROUNDER))) > NEAR_HALF;
  return __float_as_uint(u);
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ uint32_t exact_code(float x, float s) {
  return __float_as_uint(__fadd_rn(__fdiv_rn(x, s), ROUNDER));
}

// The 8 codes of a chunk by true division.
__device__ __forceinline__ uint2 divided_codes(uint4 v, float s) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[2 * i] = exact_code(lo_f(w[i]), s);
    c[2 * i + 1] = exact_code(hi_f(w[i]), s);
  }
  return make_uint2(pack4(c[0], c[1], c[2], c[3]), pack4(c[4], c[5], c[6], c[7]));
}

// Out of line: the rare chunks with an element near a half-integer.
__device__ __noinline__ uint2 exact_codes(uint4 v, float s) { return divided_codes(v, s); }

__device__ __forceinline__ uint2 chunk_codes(const uint4 &v, float s, float rcp) {
  if (ACT_DIVIDE_ALL) return divided_codes(v, s);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t c[8];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[2 * i] = fast_code(lo_f(w[i]), rcp, near);
    c[2 * i + 1] = fast_code(hi_f(w[i]), rcp, near);
  }
  if (near) return exact_codes(v, s);
  return make_uint2(pack4(c[0], c[1], c[2], c[3]), pack4(c[4], c[5], c[6], c[7]));
}

// Chunks c0 + j * T (j < VPT) of a row; zero where the chunk or element
// lies past K, or the row past M.
template <int VPT, bool VEC>
__device__ __forceinline__ void load_chunks(uint4 (&v)[VPT], const __nv_bfloat16 *xr, int K,
                                            int chunks, int c0, int T, bool live) {
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = c0 + j * T;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (!live || c >= chunks) continue;
    if (VEC) {
      v[j] = __ldg(reinterpret_cast<const uint4 *>(xr) + c);
    } else {
      const unsigned short *xs = reinterpret_cast<const unsigned short *>(xr) + 8 * c;
      const int left = K - 8 * c - (ACT_FAULT == 3);  // elements of this chunk in the row
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = e < left ? xs[e] : 0u;
      v[j] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                        h[6] | h[7] << 16);
    }
  }
}

template <int VPT, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
    act_quant_kernel(const __nv_bfloat16 *__restrict__ x, long long lda, int M, int K,
                     int warps, int8_t *__restrict__ q, float *__restrict__ scale) {
  __shared__ float wmax[MAX_WARPS];
  const int T = warps * 32, rib = threadIdx.x / T, lt = threadIdx.x - rib * T;
  const int row = blockIdx.x * (blockDim.x / T) + rib;
  const bool live = row < M;
  const int chunks = (K + 7) >> 3, stride = T * VPT;
  const int rounds = (chunks + stride - 1) / stride;
  const __nv_bfloat16 *xr = x + (size_t)(live ? row : 0) * lda;

  uint4 v[VPT];
  __nv_bfloat162 m2 = __floats2bfloat162_rn(0.f, 0.f);
  for (int r = 0; r < rounds; ++r) {
    load_chunks<VPT, VEC>(v, xr, K, chunks, r * stride + lt, T, live);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#if ACT_FAULT == 1
      if (warps == 1 && j == 0) continue;
#endif
      m2 = absmax8(v[j], m2);
    }
  }
  float m = fmaxf(__low2float(m2), __high2float(m2));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (warps > 1) {  // uniform over the block
    if ((lt & 31) == 0) wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    const float *rw = wmax + rib * warps;
    m = rw[0];
    for (int w = 1; w < warps - (ACT_FAULT == 1); ++w) m = fmaxf(m, rw[w]);
  }
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  const float rcp = __frcp_rn(s);
  if (!live) return;
  if (lt == 0) scale[row] = s;

  int8_t *qr = q + (size_t)row * K;
  for (int r = rounds - 1; r >= 0; --r) {
    if (r != rounds - 1) load_chunks<VPT, VEC>(v, xr, K, chunks, r * stride + lt, T, live);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = r * stride + j * T + lt;
      if (c >= chunks) continue;
      const uint2 codes = chunk_codes(v[j], s, rcp);
      if (VEC) {
        reinterpret_cast<uint2 *>(qr)[c] = codes;
      } else {
        const uint32_t w[2] = {codes.x, codes.y};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * c + e < K) qr[8 * c + e] = static_cast<int8_t>(w[e >> 2] >> (8 * (e & 3)));
      }
    }
  }
}

struct Args {
  const __nv_bfloat16 *x;
  long long lda;
  int M, K, warps, rows;
  int8_t *q;
  float *scale;
  cudaStream_t stream;
};

template <int VPT, bool VEC>
cudaError_t go(const Args &a) {
  act_quant_kernel<VPT, VEC><<<(a.M + a.rows - 1) / a.rows, 32 * a.warps * a.rows, 0, a.stream>>>(
      a.x, a.lda, a.M, a.K, a.warps, a.q, a.scale);
  return cudaGetLastError();
}

// The VPT built for a plan's: on the 16-byte path 1-8 as asked (a chunk a
// thread that the row does not need cost 3-8% at K = 3584 on an H100) and
// 16 past 8 (only rows over 32768 values ask for more); on the scalar path,
// which only ragged input takes, 2, 8 or 16. The chunks past the row are
// masked in load_chunks.
cudaError_t launch(bool vec, int vpt, const Args &a) {
  if (vpt > 8) return vec ? go<16, true>(a) : go<16, false>(a);
  if (!vec) return vpt > 2 ? go<8, false>(a) : go<2, false>(a);
  switch (vpt) {
    case 1: return go<1, true>(a);
    case 2: return go<2, true>(a);
    case 3: return go<3, true>(a);
    case 4: return go<4, true>(a);
    case 5: return go<5, true>(a);
    case 6: return go<6, true>(a);
    case 7: return go<7, true>(a);
    default: return go<8, true>(a);
  }
}

}  // namespace

// x [M, K] bf16 (row stride lda) -> q [M, K] s8 contiguous, scale [M] f32,
// with act_plan's (vpt, warps, rows). The 16-byte path is taken where K and
// lda are multiples of 8 and x is 16-byte aligned, q 8-byte aligned; the
// scalar path elsewhere. Returns cudaGetLastError() after the launch.
extern "C" int act_quant(const void *x, long long lda, void *q, void *scale, int M, int K,
                         int vpt, int warps, int rows, void *stream) {
  if (vpt < 1 || vpt > VPT_MAX || warps < 1 || rows < 1 || 32 * warps * rows > MAX_THREADS ||
      M < 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const bool vec = K % 8 == 0 && lda % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(q) & 7) == 0;
  return static_cast<int>(launch(
      vec, vpt,
      Args{static_cast<const __nv_bfloat16 *>(x), lda, M, K, warps, rows,
           static_cast<int8_t *>(q), static_cast<float *>(scale),
           reinterpret_cast<cudaStream_t>(stream)}));
}
