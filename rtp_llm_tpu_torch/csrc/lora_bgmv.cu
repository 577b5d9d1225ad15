// lora_bgmv: dynamic multi-LoRA on Hopper (sm_90a), each token row with its
// own adapter, read in place from the stacks of every adapter:
//   shrink: t[n, :] = bf16(x[n, :] @ A[idx[n], layer])           (held as f32)
//   expand: y[n, cols_j] += bf16(t[n, seg_j:] @ B_j[idx[n], layer]) (in place)
// with A [n_ids, L, in, R] (the members of a fused linear joined along R)
// and each member's own B_j [n_ids, L, r, o_j] bf16, contiguous, id 0 (no
// adapter) all zeros and the scale folded into B. A fused linear's output y
// holds its members' columns side by side (q | k | v, gate | up): member j
// owns columns [start_j, start_j + o_j) of y and reads its r values of t
// at seg_j, r times the members present before it. A member no adapter
// targets has no B (null): its columns keep y as it is.
//
// Replaces no Pallas kernel: the JAX package gathers each row's adapter and
// contracts with two einsums (rtp_llm_tpu/models/llama_family.py:686-693),
// which XLA fuses. PyTorch's `A[idx, layer]` followed by `bmm` writes the
// gathered [N, in, R] / [N, R, out] stacks to memory and reads them back;
// here each block indexes its row's adapter in place, so the memory reads
// are x, y, t and each distinct adapter's slices (the rest from L2).
//
// The design, simple on purpose (no tensor cores yet):
// * shrink: one block of 256 threads a (token row, chunk of 8 C ranks), C
//   a divisor of R / 8 up to 16 (a template parameter the caller picks), so
//   every R that is a multiple of 8 is served. Thread j takes rows j,
//   j + 256, ... of the chunk: C 16-byte loads a row, accumulated in C x 8
//   f32 registers, times the row's x value. Then a warp-shuffle sum of each
//   register and one exchange of the eight warps' sums through shared
//   memory. Each sum is rounded to bf16 (the JAX einsum's output type) and
//   stored as f32. A row of id 0 writes zeros and stops.
// * expand: one block a (token row, 2048-column tile) of the fused output;
//   thread j owns 8 consecutive columns, all of one member (member widths
//   are multiples of 8). Each of the member's r rows of B is one 16-byte
//   load a thread and one read of t (one address across the member's
//   threads); the 8 sums are rounded to bf16 (the delta), added to y's bf16
//   values in f32 and rounded again, as `y += delta.to(bf16)` does. Any r.
//   A row of id 0 returns at once: y stays as it is, bit for bit.
// * Ids outside [0, n_ids) are taken as 0 (the engine never passes one).
//
// Limits (the launchers return cudaErrorInvalidValue otherwise): R a
// multiple of 8 and C a divisor of R / 8 up to 16; at most three members,
// their bounds, `out` and the row stride of y multiples of 8; A, each B
// and y 16-byte aligned for the vector paths (x and t are read one value
// at a time: any stride).
//
// Planted fault for chip_smoke.py: LORA_BGMV_FAULT=1 gives odd rows with an
// adapter the neighbouring adapter id.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LORA_BGMV_FAULT
#define LORA_BGMV_FAULT 0
#endif

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, COLS = 8, MAX_C = 16, MAX_MEMBERS = 3;
constexpr int TILE_COLS = THREADS * COLS;

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ int row_id(const int *idx, int n, int n_ids) {
  int id = idx[n];
  if (id < 0 || id >= n_ids) id = 0;
#if LORA_BGMV_FAULT == 1
  if ((n & 1) && id > 0 && n_ids > 2) id = id % (n_ids - 1) + 1;
#endif
  return id;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
    shrink_kernel(const __nv_bfloat16 *__restrict__ x, long long ldx,
                  const int *__restrict__ idx, const __nv_bfloat16 *__restrict__ A, int n_ids,
                  int num_layers, int layer, int in, int R, float *__restrict__ t) {
  constexpr int RC = 8 * C;  // this block's chunk of ranks
  const int n = blockIdx.x;
  const int id = row_id(idx, n, n_ids);
  float *trow = t + static_cast<long long>(n) * R + blockIdx.y * RC;
  if (id == 0) {
    if (threadIdx.x < RC) trow[threadIdx.x] = 0.f;
    return;
  }
  const long long row_vecs = R / 8;  // 16-byte vectors a row of A
  const uint4 *a = reinterpret_cast<const uint4 *>(
                       A + (static_cast<long long>(id) * num_layers + layer) * in * R) +
                   blockIdx.y * C;
  const __nv_bfloat16 *xr = x + static_cast<long long>(n) * ldx;
  float acc[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) acc[r] = 0.f;
  for (int i = threadIdx.x; i < in; i += THREADS) {
    const float xv = __bfloat162float(xr[i]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint4 v = __ldg(a + i * row_vecs + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[8 * c + 2 * j] += xv * lo_f(w[j]);
        acc[8 * c + 2 * j + 1] += xv * hi_f(w[j]);
      }
    }
  }
  __shared__ float part[WARPS][RC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][r] = v;
  }
  __syncthreads();
  if (threadIdx.x < RC) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w][threadIdx.x];
    trow[threadIdx.x] = __bfloat162float(__float2bfloat16_rn(s));
  }
}

struct Members {
  const __nv_bfloat16 *B[MAX_MEMBERS];  // null: no adapter targets the member
  int start[MAX_MEMBERS + 1];           // column bounds; start[MAX_MEMBERS] = out
};

__global__ void __launch_bounds__(THREADS)
    expand_kernel(const float *__restrict__ t, long long ldt, const int *__restrict__ idx,
                  Members m, int n_ids, int num_layers, int layer, int r,
                  __nv_bfloat16 *__restrict__ y, long long ldy) {
  const int n = blockIdx.x;
  const int id = row_id(idx, n, n_ids);
  if (id == 0) return;
  const int col = blockIdx.y * TILE_COLS + threadIdx.x * COLS;
  if (col >= m.start[MAX_MEMBERS]) return;
  int j = 0, seg = 0;
  while (col >= m.start[j + 1]) {
    if (m.B[j]) seg += r;
    ++j;
  }
  if (!m.B[j]) return;
  const int o = m.start[j + 1] - m.start[j];
  const __nv_bfloat16 *b = m.B[j] + (static_cast<long long>(id) * num_layers + layer) * r * o +
                           (col - m.start[j]);
  const float *tp = t + static_cast<long long>(n) * ldt + seg;
  float acc[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (int rr = 0; rr < r; ++rr) {
    const uint4 v = __ldg(reinterpret_cast<const uint4 *>(b + static_cast<long long>(rr) * o));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const float tr = __ldg(tp + rr);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += tr * lo_f(w[k]);
      acc[2 * k + 1] += tr * hi_f(w[k]);
    }
  }
  uint4 *yp = reinterpret_cast<uint4 *>(y + static_cast<long long>(n) * ldy + col);
  uint4 yv = *yp;
  uint32_t *yw = reinterpret_cast<uint32_t *>(&yv);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float d0 = __bfloat162float(__float2bfloat16_rn(acc[2 * k]));
    const float d1 = __bfloat162float(__float2bfloat16_rn(acc[2 * k + 1]));
    const __nv_bfloat16 r0 = __float2bfloat16_rn(lo_f(yw[k]) + d0);
    const __nv_bfloat16 r1 = __float2bfloat16_rn(hi_f(yw[k]) + d1);
    yw[k] = static_cast<uint32_t>(__bfloat16_as_ushort(r0)) |
            (static_cast<uint32_t>(__bfloat16_as_ushort(r1)) << 16);
  }
  *yp = yv;
}

struct ShrinkArgs {
  const __nv_bfloat16 *x;
  long long ldx;
  const int *idx;
  const __nv_bfloat16 *A;
  int n_ids, num_layers, layer, in, R;
  float *t;
};

template <int C>
cudaError_t launch_shrink(int N, const ShrinkArgs &a, cudaStream_t s) {
  const dim3 grid(N, a.R / (8 * C));
  shrink_kernel<C><<<grid, THREADS, 0, s>>>(a.x, a.ldx, a.idx, a.A, a.n_ids, a.num_layers,
                                             a.layer, a.in, a.R, a.t);
  return cudaGetLastError();
}

// a chunk of 8 C ranks, C in 1..MAX_C: one instance a value
#define LORA_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

cudaError_t shrink(int c, int N, const ShrinkArgs &a, cudaStream_t s) {
  switch (c) {
#define SHRINK_CASE(V) \
  case V:              \
    return launch_shrink<V>(N, a, s);
    LORA_CASES(SHRINK_CASE)
#undef SHRINK_CASE
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void *p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// c: the chunk, 8 c ranks a block; a divisor of R / 8 up to 16.
extern "C" int lora_shrink(const void *x, long long ldx, const void *idx, const void *A,
                           int n_ids, int num_layers, int layer, int in, int R, int c, void *t,
                           int N, void *stream) {
  if (R % 8 != 0 || R < 8 || c < 1 || c > MAX_C || (R / 8) % c != 0 || N < 0 || in < 0 ||
      layer < 0 || layer >= num_layers || n_ids < 1 || !aligned16(A))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  return static_cast<int>(shrink(c, N,
                                 ShrinkArgs{static_cast<const __nv_bfloat16 *>(x), ldx,
                                            static_cast<const int *>(idx),
                                            static_cast<const __nv_bfloat16 *>(A), n_ids,
                                            num_layers, layer, in, R, static_cast<float *>(t)},
                                 reinterpret_cast<cudaStream_t>(stream)));
}

// Members j = 0, 1, 2 own columns [start_j, start_{j+1}) of y, with start_0
// = 0, start_1 = col1, start_2 = col2 and start_3 = out (col1 = col2 = out
// for one member); B_j is null for a member no adapter targets.
extern "C" int lora_expand(const void *t, long long ldt, const void *idx, const void *B0,
                           const void *B1, const void *B2, int n_ids, int num_layers, int layer,
                           int r, int col1, int col2, int out, void *y, long long ldy, int N,
                           void *stream) {
  const Members m{{static_cast<const __nv_bfloat16 *>(B0),
                   static_cast<const __nv_bfloat16 *>(B1),
                   static_cast<const __nv_bfloat16 *>(B2)},
                  {0, col1, col2, out}};
  bool ok = r >= 1 && N >= 0 && 0 <= col1 && col1 <= col2 && col2 <= out && col1 % 8 == 0 &&
            col2 % 8 == 0 && out % 8 == 0 && ldy % 8 == 0 && layer >= 0 &&
            layer < num_layers && n_ids >= 1 && aligned16(y);
  int present = 0;
  for (int j = 0; j < MAX_MEMBERS; ++j) {
    if (!m.B[j]) continue;
    ok = ok && aligned16(m.B[j]);
    ++present;
  }
  if (!ok || ldt < static_cast<long long>(present) * r)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || out == 0 || present == 0) return 0;
  const dim3 grid(N, (out + TILE_COLS - 1) / TILE_COLS);
  expand_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float *>(t), ldt, static_cast<const int *>(idx), m, n_ids, num_layers,
      layer, r, static_cast<__nv_bfloat16 *>(y), ldy);
  return static_cast<int>(cudaGetLastError());
}
