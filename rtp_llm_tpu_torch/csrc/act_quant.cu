// act_quant: per-token int8 activation codes and scales on Hopper (sm_90a),
// the activation side of W8A8 and W4A8 (i8_gemm.cu):
//   scale[m] = max(amax_k |x[m, k]|, 1e-8) / 127
//   q[m, k]  = clip(rint(x[m, k] / scale[m]), -127, 127)
//
// Replaces no Pallas kernel: quantize_activations_per_token
// (rtp_llm_tpu/quant/weight_only.py:157-163) is an XLA fusion there. The
// codes equal the plain version's bit for bit: a true IEEE division (no
// multiply by the reciprocal, no fast-math) and round-half-even.
//
// What bounds it: bytes, 2 B read and 1 B written an element (a 2048-row
// prefill into the Qwen2-7B down projection, K = 18944: 116 MB, 0.035 ms at
// 3.35 TB/s). One block of 256 threads a row: a strided pass for the row's
// amax (warp shuffles, then one value a warp through shared memory), a
// second pass for the codes; the row is read twice, the second time mostly
// from L1/L2.
//
// Planted fault for chip_smoke.py (-DACT_FAULT=1): the last warp's partial
// maximum is left out of the row's amax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ACT_FAULT
#define ACT_FAULT 0
#endif

namespace aq {

constexpr int THREADS = 256, WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
    act_quant_kernel(const __nv_bfloat16 *x, long long lda, int K, int8_t *q, float *scale) {
  __shared__ float wmax[WARPS];
  __shared__ float row_scale;
  const int row = blockIdx.x, tid = threadIdx.x;
  const __nv_bfloat16 *xr = x + (size_t)row * lda;
  float m = 0.f;
  for (int k = tid; k < K; k += THREADS) m = fmaxf(m, fabsf(__bfloat162float(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float amax = 0.f;
#if ACT_FAULT == 1
    for (int w = 0; w < WARPS - 1; ++w) amax = fmaxf(amax, wmax[w]);
#else
    for (int w = 0; w < WARPS; ++w) amax = fmaxf(amax, wmax[w]);
#endif
    row_scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
    scale[row] = row_scale;
  }
  __syncthreads();
  const float s = row_scale;
  int8_t *qr = q + (size_t)row * K;
  for (int k = tid; k < K; k += THREADS) {
    const float v = rintf(__fdiv_rn(__bfloat162float(xr[k]), s));
    qr[k] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
}

}  // namespace aq

// x [M, K] bf16 (row stride lda) -> q [M, K] s8 contiguous, scale [M] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int act_quant(const void *x, long long lda, void *q, void *scale, int M, int K,
                         void *stream) {
  aq::act_quant_kernel<<<M, aq::THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16 *>(x), lda, K, static_cast<int8_t *>(q),
      static_cast<float *>(scale));
  return static_cast<int>(cudaGetLastError());
}
