// moe_grouped_gemm (X6): the grouped expert GEMM of the mixture-of-experts
// layer on Hopper (sm_90a), over rows sorted by expert:
//   y[r, :] = x[rows[r], :] @ W[e(r)]        r in [0, R)
// with x [*, K] bf16 (row stride ldx; rows [R] int32 picks its rows, or
// null: row r itself), W [E, K, N] bf16 contiguous, offsets [E + 1] int32 on
// the device (expert e owns sorted rows [offsets[e], offsets[e + 1])), y
// [R, N] bf16 (row stride ldy). bf16 operands, f32 sums, bf16 out.
//
// Replaces no Pallas kernel: the JAX package's expert products are
// jax.lax.ragged_dot (rtp_llm_tpu/ops/moe.py:40-43), an XLA op, and PyTorch
// has no public form of it. The layer runs it twice a forward: gate-up (x
// gathered through rows = token of each sorted assignment, N = 2I) and down
// (the activation rows in sorted order, N = H).
//
// Bound: bytes at decode, operations at prefill. A decode step's few rows
// an expert read every touched expert's [K, N] slice once: the slices are
// the bytes. At prefill hundreds of rows share an expert and the tensor
// cores are the limit.
//
// Design (correct first; wgmma / TMA come later, ROADMAP B "After A1"):
// * A fixed grid, capturable in a CUDA graph: x = ceil(R / TM) + E tiles
//   (an upper bound: each expert wastes at most one partial tile), y = the
//   N / 128 column tiles. Each block finds its tile from the device offsets:
//   warp 0 takes the experts 32 at a time, lane l the tiles of expert
//   e0 + l, ceil(count / TM), in a warp-wide prefix sum; the lane whose
//   range holds blockIdx.x names (expert, first sorted row, rows). A block
//   past the last tile has no rows and exits. Nothing is read by the host.
// * TM, the rows of a tile, is 16 or 64 (the wrapper picks by the mean
//   group: ops/moe.py TILE_ROWS): at decode nearly every expert holds a few
//   rows, which should not pay for a 64-row tile; at prefill 64 rows read
//   each weight tile a quarter as often.
// * Four warps a block, mma.sync.m16n8k16 (bf16 in, f32 sums): at TM 16
//   each warp takes 32 of the block's 128 columns, at TM 64 each warp 16
//   rows and all 128 columns. A three-stage cp.async ring of 64 k a stage
//   holds the tile's x rows (gathered through rows in the copy) and W's
//   [64, 128] slice; A fragments by ldmatrix, B fragments by ldmatrix.trans
//   from W's row-major [k][n] slice (the pitches are an odd number of
//   16-byte chunks, so ldmatrix's eight rows hit eight bank groups).
// * The sums are rounded once to bf16 and stored as pairs.
//
// Limits (the launcher returns cudaErrorInvalidValue otherwise): K, N, ldx
// and ldy multiples of 8; x, W and y 16-byte aligned; TM 16 or 64.
//
// Planted faults for chip_smoke.py (MOE_GEMM_FAULT): 1 leaves the last k
// stage out of every sum; 2 gives the second tile of each expert the first
// tile's rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MOE_GEMM_FAULT
#define MOE_GEMM_FAULT 0
#endif

namespace {

constexpr int THREADS = 128;
constexpr int BN = 128;  // columns a block
constexpr int KT = 64;   // k a ring stage
constexpr int STAGES = 3;
constexpr int XP = KT + 8;  // x tile pitch, bf16 (9 chunks of 16 bytes)
constexpr int WP = BN + 8;  // W tile pitch, bf16 (17 chunks)

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void *src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: nothing is read, 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (bits 0..15)
  return *reinterpret_cast<uint32_t *>(&v);
}

struct Args {
  const __nv_bfloat16 *x;
  long long ldx;
  const int *rows;  // [R] or null
  const __nv_bfloat16 *w;
  const int *offsets;  // [E + 1]
  __nv_bfloat16 *y;
  long long ldy;
  int R, K, N, E;
};

template <int TM>
struct Ring {
  static constexpr int STAGE = TM * XP + KT * WP;  // bf16 a stage: x tile | W tile
  static constexpr int BYTES = STAGES * STAGE * 2;
};

// Warp 0: (expert, first sorted row, rows) of tile `b` into tile[0..2];
// rows 0 for a block past the last tile.
template <int TM>
__device__ __forceinline__ void find_tile(const Args &a, int b, int lane, int *tile) {
  int base = 0;  // tiles of the experts before this chunk
  if (lane == 0) tile[2] = 0;
  __syncwarp();
  for (int e0 = 0; e0 < a.E; e0 += 32) {
    const int e = e0 + lane;
    const int lo = e < a.E ? a.offsets[e] : 0;
    const int cnt = e < a.E ? a.offsets[e + 1] - lo : 0;
    const int t = (cnt + TM - 1) / TM;
    int inc = t;  // inclusive prefix sum of the chunk's tiles
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const int excl = base + inc - t;
    if (b >= excl && b < excl + t) {
      int j = b - excl;  // the tile's index in its expert
#if MOE_GEMM_FAULT == 2
      if (j == 1) j = 0;
#endif
      tile[0] = e;
      tile[1] = lo + j * TM;
      tile[2] = min(TM, cnt - (b - excl) * TM);
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
    if (b < base) break;  // warp-uniform: every lane holds the same base
  }
}

template <int TM>
__global__ void __launch_bounds__(THREADS) moe_gemm_kernel(const Args a) {
  constexpr int WARPS_M = TM / 16;      // 1 or 4
  constexpr int WARPS_N = 4 / WARPS_M;  // 4 or 1
  constexpr int NT = BN / 8 / WARPS_N;  // n8 tiles a warp: 4 or 16
  using S = Ring<TM>;
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  __shared__ int tile[3];
  __shared__ int src_row[TM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp == 0) find_tile<TM>(a, blockIdx.x, lane, tile);
  __syncthreads();
  const int ex = tile[0], first = tile[1], count = tile[2];
  if (count <= 0) return;
  for (int i = tid; i < TM; i += THREADS)
    src_row[i] = i < count ? (a.rows ? a.rows[first + i] : first + i) : -1;
  __syncthreads();

  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16 *W = a.w + static_cast<long long>(ex) * a.K * a.N;
  const int ktiles = (a.K + KT - 1) / KT;
  const uint32_t ring_s = smem_addr(ring);
  auto load = [&](int stage, int kt) {
    const int k0 = kt * KT;
    const uint32_t sx = ring_s + stage * S::STAGE * 2, sw = sx + TM * XP * 2;
    for (int e = tid; e < TM * (KT / 8); e += THREADS) {
      const int i = e / (KT / 8), c = (e % (KT / 8)) * 8, r = src_row[i];
      const bool v = r >= 0 && k0 + c < a.K;
      cp16(sx + (i * XP + c) * 2, v ? a.x + static_cast<long long>(r) * a.ldx + k0 + c : a.x, v);
    }
    for (int e = tid; e < KT * (BN / 8); e += THREADS) {
      const int kk = e / (BN / 8), c = (e % (BN / 8)) * 8;
      const bool v = k0 + kk < a.K && n0 + c < a.N;
      cp16(sw + (kk * WP + c) * 2, v ? W + static_cast<long long>(k0 + kk) * a.N + n0 + c : a.w,
           v);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const bool active = wm * 16 < count;  // a warp whose 16 rows are all past the group idles
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int kend = MOE_GEMM_FAULT == 1 ? ktiles - 1 : ktiles;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    if (!active || kt >= kend) continue;
    const uint32_t sx = ring_s + (kt % STAGES) * S::STAGE * 2, sw = sx + TM * XP * 2;
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      uint32_t af[4];
      ldsm4(af, sx + ((wm * 16 + (lane & 15)) * XP + ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldsm4_t(b, sw + ((ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WP + wn * NT * 8 +
                         jp * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(acc[2 * jp], af, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], af, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * NT * 8 + j * 8 + c2;
    if (col >= a.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wm * 16 + g + 8 * h;
      if (i < count)
        *reinterpret_cast<uint32_t *>(a.y + static_cast<long long>(first + i) * a.ldy + col) =
            pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

template <int TM>
cudaError_t launch(const Args &a, cudaStream_t stream) {
  static bool ready = false;  // the shared-memory limit, set once an instance
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<TM>::BYTES);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((a.R + TM - 1) / TM + a.E, (a.N + BN - 1) / BN);
  moe_gemm_kernel<TM><<<grid, THREADS, Ring<TM>::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int moe_grouped_gemm(const void *x, long long ldx, const void *rows, const void *w,
                                const void *offsets, void *y, long long ldy, int R, int K, int N,
                                int E, int tile_m, void *stream) {
  if (K % 8 || N % 8 || ldx % 8 || ldy % 8 || E <= 0 || R <= 0 ||
      (tile_m != 16 && tile_m != 64) || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16 *>(x), ldx, static_cast<const int *>(rows),
               static_cast<const __nv_bfloat16 *>(w), static_cast<const int *>(offsets),
               static_cast<__nv_bfloat16 *>(y), ldy, R, K, N, E};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(tile_m == 16 ? launch<16>(a, st) : launch<64>(a, st));
}
