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
// gathered [N, in, R] / [N, R, out] stacks to memory and reads them back.
//
// Bound: bytes. The shrink moves x once (N in bf16) and each live adapter's
// [in, R] slice, about R operations a byte of x; the expand reads and
// writes y (4 bytes a column a row) for r operations. Both sit far below
// the card's ~295 operations a byte: the design is about moving each byte
// once and keeping enough of them in flight.
//
// Three entries, all capturable (fixed grids from N and n_ids, no host
// read; a block with no work exits):
// * lora_segments, once a forward (the ids do not change between the
//   layers): one block counting-sorts the [N] ids, stably, into `perm` (the
//   rows in adapter order), `offsets` [n_ids + 1] and a table of tiles
//   (adapter, first position in perm, rows), at most TM rows a tile and
//   ceil(N / TM) + n_ids entries, unused entries with 0 rows. Rows of id 0
//   form no tile. Each warp counts a contiguous range of rows by id
//   (__match_any_sync groups equal ids of 32 rows), a scan over (id, warp)
//   gives every warp its first position in each id, and the warps place
//   their rows in the same order again: stable. It also zeroes the
//   shrink's split counters.
// * lora_shrink: a block of 8 warps takes one (tile, split of `in`, chunk
//   of 8 NT ranks, NT <= 16). Its tile's x rows are gathered through perm
//   and A's rows streamed, 128 k a stage, through a 4-stage cp.async ring
//   (3 stages above 8 rank tiles; A's first stages are issued before perm
//   is read). Warp w owns rows 16 (w % 4) and every other k16 step of a
//   stage (w / 4), and multiplies with mma.sync.m16n8k16 (bf16 in, f32
//   sums): A fragments by ldmatrix, B fragments by ldmatrix.trans from A's
//   row-major [k][rank] tile; the two halves are added through shared
//   memory at the end. So each adapter's slice is read once a tile of rows
//   (not once a row). The splits and chunks come from ops/lora.py's
//   shrink_plan: at decode and verify sizes a block takes 16 ranks and
//   `in` is split until a few tiles fill the multiprocessors. Every split
//   writes its f32 partial to a workspace; the block that finishes a
//   (tile, chunk) last (an integer counter, reset by that block) adds the
//   splits' partials in split order (16 loads in flight a thread) and
//   rounds once to bf16: replays give the same bits, with no float
//   atomics. Split 0's blocks also zero t's rows of id 0.
// * lora_expand: a block of 4 warps takes one (tile, 128-column tile of one
//   member). It copies the tile's y rows (through perm) and the member's
//   B [r, 128] slice into shared memory with cp.async, converts its t rows
//   to bf16 (exact: t holds bf16 values), and multiplies with mma.sync
//   (K = r, padded with zeros to 16): B is read once a tile of rows. The
//   delta is rounded to bf16, added to y's bf16 values in f32 and rounded
//   again, as `y += delta.to(bf16)` does, and the tile goes back in 16-byte
//   vectors. Rows of id 0 are in no tile: y keeps them bit for bit.
// * Ids outside [0, n_ids) are taken as 0 (the engine never passes one).
//
// Limits (the launchers return cudaErrorInvalidValue otherwise): R a
// multiple of 8 in at most MAX_RCHUNKS chunks of 8 NT ranks; `in`, the row
// strides of x and y, the members' bounds and `out` multiples of 8; at
// most three members, r <= MAX_RANK; x, A, each B and y 16-byte aligned;
// n_ids small enough for the segment pass's counts (12288 ints of shared
// memory: 32 warps up to 350 ids, fewer warps above).
//
// Planted faults for chip_smoke.py (LORA_BGMV_FAULT): 1 puts odd rows with
// an adapter into the neighbouring adapter's segment, 2 drops each tile's
// last row, 3 leaves the last split's partial out of the shrink's sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LORA_BGMV_FAULT
#define LORA_BGMV_FAULT 0
#endif

namespace {

constexpr int TM = 64;        // rows a tile
constexpr int KPARTS = 2;     // shrink warps a row group, each a part of every stage's k
constexpr int THREADS = 128 * KPARTS;  // shrink block: 4 row groups x KPARTS
constexpr int KT = 128;       // k a shrink ring stage
constexpr int XC = KT / 8;    // 16-byte chunks of an x row a stage
constexpr int XQ = TM * XC / THREADS;  // x chunks a shrink thread copies a stage
constexpr int E_THREADS = 128;         // expand block: 4 row groups of 16
constexpr int BN = 128;                // columns an expand block
constexpr int MAX_NT = 16;        // n8 rank tiles a shrink block
constexpr int MAX_RCHUNKS = 8;    // rank chunks of a shrink, counters a tile
constexpr int MAX_RANK = 256;     // r of the expand
constexpr int MAX_MEMBERS = 3;
constexpr int SEG_SMEM_INTS = 12288;  // 48 KB

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

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ void add4(float4 &s, const float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (bits 0..15)
  return *reinterpret_cast<uint32_t *>(&v);
}

// ---- lora_segments -----------------------------------------------------------

__device__ __forceinline__ int seg_id(const int *ids, int n, int n_ids) {
  int id = ids[n];
  if (id < 0 || id >= n_ids) id = 0;
#if LORA_BGMV_FAULT == 1
  if ((n & 1) && id > 0 && n_ids > 2) id = id % (n_ids - 1) + 1;
#endif
  return id;
}

// One block of 32 W threads. Shared: cnt [W][n_ids] (each warp's count of
// an id, then its next position there), total, start and tstart [n_ids + 1]
// (rows of an id, its first position, its first tile).
__global__ void segments_kernel(const int *__restrict__ ids, int N, int n_ids, int max_tiles,
                                int *__restrict__ perm, int *__restrict__ offsets,
                                int4 *__restrict__ tiles, int *__restrict__ counters) {
  extern __shared__ int seg_smem[];
  const int W = blockDim.x >> 5;
  int *cnt = seg_smem;
  int *total = cnt + W * n_ids;
  int *start = total + n_ids + 1;
  int *tstart = start + n_ids + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < W * n_ids; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int span = ((N + W - 1) / W + 31) / 32 * 32;  // rows a warp, whole chunks of 32
  const int lo = min(N, warp * span), hi = min(N, lo + span);
  int *mine = cnt + warp * n_ids;
  for (int base = lo; base < hi; base += 32) {
    const int n = base + lane;
    const int v = n < hi ? seg_id(ids, n, n_ids) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, v);
    if (v >= 0 && lane == __ffs(peers) - 1) mine[v] += __popc(peers);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n_ids; v += blockDim.x) {  // warps' prefix within an id
    int run = 0;
    for (int w = 0; w < W; ++w) {
      const int c = cnt[w * n_ids + v];
      cnt[w * n_ids + v] = run;
      run += c;
    }
    total[v] = run;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scans over the ids: first positions and first tiles
    int carry_p = 0, carry_t = 0;
    for (int v0 = 0; v0 < n_ids; v0 += 32) {
      const int v = v0 + lane;
      const int c = v < n_ids ? total[v] : 0;
      const int nt = v > 0 && v < n_ids ? (c + TM - 1) / TM : 0;
      int sp = c, st = nt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, sp, off);
        const int b = __shfl_up_sync(0xffffffffu, st, off);
        if (lane >= off) {
          sp += a;
          st += b;
        }
      }
      if (v < n_ids) {
        start[v] = carry_p + sp - c;
        tstart[v] = carry_t + st - nt;
      }
      carry_p += __shfl_sync(0xffffffffu, sp, 31);
      carry_t += __shfl_sync(0xffffffffu, st, 31);
    }
    if (lane == 0) {
      start[n_ids] = carry_p;
      tstart[n_ids] = carry_t;
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v <= n_ids; v += blockDim.x) offsets[v] = start[v];
  for (int v = threadIdx.x; v < n_ids; v += blockDim.x)
    for (int w = 0; w < W; ++w) cnt[w * n_ids + v] += start[v];
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {  // place the rows, in row order within an id
    const int n = base + lane;
    const int v = n < hi ? seg_id(ids, n, n_ids) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, v);
    if (v >= 0) perm[mine[v] + __popc(peers & ((1u << lane) - 1u))] = n;
    __syncwarp();
    if (v >= 0 && lane == __ffs(peers) - 1) mine[v] += __popc(peers);
    __syncwarp();
  }
  for (int v = 1 + threadIdx.x; v < n_ids; v += blockDim.x) {
    const int c = total[v];
    for (int k = 0; k * TM < c; ++k) {
      int rows = min(TM, c - k * TM);
#if LORA_BGMV_FAULT == 2
      if (rows > 1) --rows;
#endif
      tiles[tstart[v] + k] = make_int4(v, start[v] + k * TM, rows, 0);
    }
  }
  for (int i = tstart[n_ids] + threadIdx.x; i < max_tiles; i += blockDim.x)
    tiles[i] = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < max_tiles * MAX_RCHUNKS; i += blockDim.x) counters[i] = 0;
}

// ---- lora_shrink -------------------------------------------------------------

struct ShrinkArgs {
  const __nv_bfloat16 *x;
  long long ldx;
  const int *perm, *offsets;
  const int4 *tiles;
  int *counters;
  const __nv_bfloat16 *A;
  int num_layers, layer, in, R;
  int k_tiles, per_split;  // k-tiles of `in`, k-tiles a split
  float *ws;               // [splits, N, R]: each split's partial, by perm position
  float *t;                // [N, R]
  int N;
};

// One ring stage, bf16 offsets: x [TM][XP] | A [KT][AP]. The pitches are
// an odd number of 16-byte chunks, so ldmatrix's eight rows hit eight
// different bank groups.
template <int NT>
struct ShrinkRing {
  static constexpr int NTP = NT + (NT & 1);  // rank tiles held (pairs for ldmatrix.x4)
  static constexpr int STAGES = NT <= 8 ? 4 : 3;  // 94-157 KB
  static constexpr int XP = KT + 8;
  static constexpr int AP = 8 * (NTP + 1);
  static constexpr int STAGE = TM * XP + KT * AP;
  static constexpr int BYTES = STAGES * STAGE * 2;
};

template <int NT>
__global__ void __launch_bounds__(THREADS) shrink_kernel(const ShrinkArgs a) {
  using S = ShrinkRing<NT>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  __shared__ int last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y, c0 = blockIdx.z * 8 * NT;  // first rank of the block
  const int4 tile = a.tiles[blockIdx.x];

  if (split == 0) {  // t's rows of id 0 (perm positions below offsets[1]): zeros
    const int zero_end = a.offsets[1];
    for (int e = tid; e < TM * 2 * NT; e += THREADS) {
      const int p = blockIdx.x * TM + e / (2 * NT), col = c0 + 4 * (e % (2 * NT));
      if (p < zero_end && col < a.R)
        *reinterpret_cast<float4 *>(a.t + static_cast<long long>(a.perm[p]) * a.R + col) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int id = tile.x, first = tile.y, count = tile.z;
  if (count == 0) return;

  const __nv_bfloat16 *Ab =
      a.A + (static_cast<long long>(id) * a.num_layers + a.layer) * a.in * a.R + c0;
  const int kt0 = split * a.per_split, nk = min(a.per_split, a.k_tiles - kt0);
  const uint32_t ring_s = smem_addr(ring);
  auto load_a = [&](int stage, int kt) {
    const int k0 = kt * KT;
    const uint32_t sa = ring_s + (stage * S::STAGE + TM * S::XP) * 2;
    for (int e = tid; e < KT * S::NTP; e += THREADS) {
      const int kk = e / S::NTP, ch = e % S::NTP, k = k0 + kk;
      const bool v = ch < NT && c0 + ch * 8 < a.R && k < a.in;
      cp16(sa + (kk * S::AP + ch * 8) * 2, v ? Ab + static_cast<long long>(k) * a.R + ch * 8 : a.A,
           v);
    }
  };
  // warp: rows 16 rg .. + 16, the k16 steps kh, kh + KPARTS, .. of each stage
  const int rg = warp & 3, kh = warp >> 2;
  float acc[S::NTP][4];
#pragma unroll
  for (int j = 0; j < S::NTP; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // A's prologue stages go out before perm is read (their addresses need
  // only the tile); each prologue commit group s then holds x's stage s,
  // group 0 also every prologue stage of A: groups land in order
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nk) load_a(s, kt0 + s);

  // this thread's x copies: rows (tid + THREADS q) / XC, 16-byte chunk tid % XC
  const __nv_bfloat16 *xp[XQ];
  bool xv[XQ];
#pragma unroll
  for (int q = 0; q < XQ; ++q) {
    const int i = (tid + THREADS * q) / XC;
    xv[q] = i < count;
    xp[q] = a.x + static_cast<long long>(a.perm[first + (xv[q] ? i : 0)]) * a.ldx + (tid % XC) * 8;
  }
  auto load_x = [&](int stage, int kt) {
    const int k0 = kt * KT;
    const uint32_t sx = ring_s + stage * S::STAGE * 2;
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      const int i = (tid + THREADS * q) / XC, kc = (tid % XC) * 8;
      const bool v = xv[q] && k0 + kc < a.in;
      cp16(sx + (i * S::XP + kc) * 2, v ? xp[q] + k0 : a.x, v);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_x(s, kt0 + s);
    cp_async_commit();
  }
  const bool active = rg * 16 < count;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) {
      load_a((kt + STAGES - 1) % STAGES, kt0 + kt + STAGES - 1);
      load_x((kt + STAGES - 1) % STAGES, kt0 + kt + STAGES - 1);
    }
    cp_async_commit();
    if (!active) continue;
    const uint32_t sx = ring_s + (kt % STAGES) * S::STAGE * 2, sa = sx + TM * S::XP * 2;
#pragma unroll
    for (int ks = kh; ks < KT / 16; ks += KPARTS) {
      uint32_t af[4];
      ldsm4(af, sx + ((rg * 16 + (lane & 15)) * S::XP + ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int jp = 0; jp < S::NTP / 2; ++jp) {
        uint32_t b[4];
        ldsm4_t(b, sa + ((ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::AP + jp * 16 +
                         (lane >> 4) * 8) * 2);
        mma_bf16(acc[2 * jp], af, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], af, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the other k parts' sums through the ring, added to part 0's in order
  float *xch = reinterpret_cast<float *>(ring) + (rg * 32 + lane) * 4 * S::NTP;
  constexpr int XCH = 4 * 32 * 4 * S::NTP;  // floats a k part
  if (kh > 0 && active) {
#pragma unroll
    for (int j = 0; j < S::NTP; ++j)
      *reinterpret_cast<float4 *>(xch + (kh - 1) * XCH + 4 * j) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();

  // the split's partial, by perm position
  float *wsp = a.ws + static_cast<long long>(split) * a.N * a.R;
  if (kh == 0 && active) {
    const int g = lane >> 2, col_in = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int p = 1; p < KPARTS; ++p) {
        const float4 o = *reinterpret_cast<const float4 *>(xch + (p - 1) * XCH + 4 * j);
        acc[j][0] += o.x;
        acc[j][1] += o.y;
        acc[j][2] += o.z;
        acc[j][3] += o.w;
      }
      const int col = c0 + j * 8 + col_in;
      if (col >= a.R) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = rg * 16 + g + 8 * h;
        if (i < count)
          *reinterpret_cast<float2 *>(wsp + static_cast<long long>(first + i) * a.R + col) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  int *counter = a.counters + blockIdx.x * MAX_RCHUNKS + blockIdx.z;
  if (tid == 0) last_s = atomicAdd(counter, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the last block of the (tile, chunk): the splits' partials in split
  // order, rounded once
  const int splits = LORA_BGMV_FAULT == 3 && gridDim.y > 1 ? gridDim.y - 1 : gridDim.y;
  const long long split_stride = static_cast<long long>(a.N) * a.R / 4;  // float4s a split
  for (int e = tid; e < count * 2 * NT; e += THREADS) {
    const int i = e / (2 * NT), col = c0 + 4 * (e % (2 * NT));
    if (col >= a.R) continue;
    const float4 *src =
        reinterpret_cast<const float4 *>(a.ws + static_cast<long long>(first + i) * a.R + col);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    int sp = 0;
    for (; sp + 16 <= splits; sp += 16) {  // sixteen loads in flight, added in split order
      float4 v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = __ldcg(src + (sp + u) * split_stride);
#pragma unroll
      for (int u = 0; u < 16; ++u) add4(s, v[u]);
    }
    for (; sp + 4 <= splits; sp += 4) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldcg(src + (sp + u) * split_stride);
#pragma unroll
      for (int u = 0; u < 4; ++u) add4(s, v[u]);
    }
    for (; sp < splits; ++sp) add4(s, __ldcg(src + sp * split_stride));
    *reinterpret_cast<float4 *>(a.t + static_cast<long long>(a.perm[first + i]) * a.R + col) =
        make_float4(bf16r(s.x), bf16r(s.y), bf16r(s.z), bf16r(s.w));
  }
  if (tid == 0) *counter = 0;  // ready for the next shrink on this record
}

// ---- lora_expand -------------------------------------------------------------

struct Members {
  const __nv_bfloat16 *B[MAX_MEMBERS];  // the present members only, in column order
  int start[MAX_MEMBERS], width[MAX_MEMBERS], seg[MAX_MEMBERS];
  int tile0[MAX_MEMBERS + 1];  // first column tile of each; tile0[present] = all
  int present;
};

constexpr int YP = BN + 8;  // y and B row pitch, bf16 (an odd number of 16-byte chunks)

__global__ void __launch_bounds__(E_THREADS)
    expand_kernel(const float *__restrict__ t, long long ldt, const int *__restrict__ perm,
                  const int4 *__restrict__ tiles, const Members m, int num_layers, int layer,
                  int r, int r16, __nv_bfloat16 *__restrict__ y, long long ldy) {
  extern __shared__ __align__(16) __nv_bfloat16 es[];
  __shared__ int rows_s[TM];
  const int4 tile = tiles[blockIdx.x];
  const int id = tile.x, first = tile.y, count = tile.z;
  if (count == 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the block's member, read with constant indices (no local copy of m)
  const __nv_bfloat16 *Bm = m.B[0];
  int start = m.start[0], width = m.width[0], seg = m.seg[0], tile0 = 0;
#pragma unroll
  for (int q = 1; q < MAX_MEMBERS; ++q)
    if (q < m.present && static_cast<int>(blockIdx.y) >= m.tile0[q]) {
      Bm = m.B[q];
      start = m.start[q];
      width = m.width[q];
      seg = m.seg[q];
      tile0 = m.tile0[q];
    }
  const int col0 = (blockIdx.y - tile0) * BN;
  const int TP = r16 + 8;  // t row pitch, bf16 (odd 16-byte chunks: r16 is a multiple of 16)
  __nv_bfloat16 *ys = es, *bs = es + TM * YP, *ts = bs + r16 * YP;
  const __nv_bfloat16 *Bj =
      Bm + (static_cast<long long>(id) * num_layers + layer) * r * width + col0;
  __nv_bfloat16 *ycol = y + start + col0;
  // B first: its address needs only the tile
  for (int e = tid; e < r16 * (BN / 8); e += E_THREADS) {
    const int kk = e / (BN / 8), c = (e % (BN / 8)) * 8;
    const bool v = kk < r && col0 + c < width;
    cp16(smem_addr(bs + kk * YP + c), v ? Bj + static_cast<long long>(kk) * width + c : Bj, v);
  }
  for (int i = tid; i < TM; i += E_THREADS) rows_s[i] = i < count ? perm[first + i] : 0;
  __syncthreads();

  for (int e = tid; e < TM * (BN / 8); e += E_THREADS) {
    const int i = e / (BN / 8), c = (e % (BN / 8)) * 8;
    if (i < count && col0 + c < width)
      cp16(smem_addr(ys + i * YP + c), ycol + static_cast<long long>(rows_s[i]) * ldy + c, true);
  }
  cp_async_commit();
  const float *tseg = t + seg;
  for (int e = tid; e < TM * (r16 / 2); e += E_THREADS) {
    const int i = e / (r16 / 2), kk = 2 * (e % (r16 / 2));
    float v0 = 0.f, v1 = 0.f;
    if (i < count) {
      const float *tr = tseg + static_cast<long long>(rows_s[i]) * ldt;
      if (kk < r) v0 = tr[kk];
      if (kk + 1 < r) v1 = tr[kk + 1];
    }
    *reinterpret_cast<uint32_t *>(ts + i * TP + kk) = pack_bf16(v0, v1);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int row0 = warp * 16;  // the warp's rows; all BN columns
  if (row0 < count) {
    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const uint32_t ts_s = smem_addr(ts), bs_s = smem_addr(bs);
    for (int ks = 0; ks < r16 / 16; ++ks) {
      uint32_t af[4];
      ldsm4(af, ts_s + ((row0 + (lane & 15)) * TP + ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t b[4];
        ldsm4_t(b, bs_s + ((ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * YP + np * 16 +
                           (lane >> 4) * 8) * 2);
        mma_bf16(acc[2 * np], af, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
    const int g = lane >> 2, c_in = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = n * 8 + c_in;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = row0 + g + 8 * h;
        if (i < count && col0 + c < width) {
          uint32_t *p = reinterpret_cast<uint32_t *>(ys + i * YP + c);
          const uint32_t yv = *p;
          *p = pack_bf16(lo_f(yv) + bf16r(acc[n][2 * h]), hi_f(yv) + bf16r(acc[n][2 * h + 1]));
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < TM * (BN / 8); e += E_THREADS) {
    const int i = e / (BN / 8), c = (e % (BN / 8)) * 8;
    if (i < count && col0 + c < width)
      *reinterpret_cast<uint4 *>(ycol + static_cast<long long>(rows_s[i]) * ldy + c) =
          *reinterpret_cast<const uint4 *>(ys + i * YP + c);
  }
}

int expand_smem(int r16) { return ((TM + r16) * YP + TM * (r16 + 8)) * 2; }

// ---- launchers -----------------------------------------------------------------

// n8 rank tiles a shrink block, NT in 1..MAX_NT: one instance a value
#define LORA_NT_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

// dynamic shared memory above 48 KB, set for every instance at the first
// call (warm() makes it before any graph capture)
cudaError_t set_smem_limits() {
  static cudaError_t done = cudaErrorNotReady;
  if (done != cudaErrorNotReady) return done;
  cudaError_t e = cudaSuccess;
#define SHRINK_ATTR(V)                                                                      \
  if (e == cudaSuccess)                                                                     \
    e = cudaFuncSetAttribute(shrink_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             ShrinkRing<V>::BYTES);
  LORA_NT_CASES(SHRINK_ATTR)
#undef SHRINK_ATTR
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             expand_smem(MAX_RANK));
  done = e;
  return e;
}

cudaError_t shrink(int nt, dim3 grid, const ShrinkArgs &a, cudaStream_t s) {
  switch (nt) {
#define SHRINK_CASE(V)                                                    \
  case V:                                                                 \
    shrink_kernel<V><<<grid, THREADS, ShrinkRing<V>::BYTES, s>>>(a);      \
    return cudaGetLastError();
    LORA_NT_CASES(SHRINK_CASE)
#undef SHRINK_CASE
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void *p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int min_tiles(int N, int n_ids) { return (N + TM - 1) / TM + n_ids; }

}  // namespace

// The segment record of one forward's ids [N]: perm [N], offsets
// [n_ids + 1], tiles [max_tiles] int4 (16-byte aligned), counters
// [max_tiles * MAX_RCHUNKS]; max_tiles >= ceil(N / TM) + n_ids.
extern "C" int lora_segments(const void *ids, int N, int n_ids, int max_tiles, void *perm,
                             void *offsets, void *tiles, void *counters, void *stream) {
  if (N < 0 || n_ids < 1 || max_tiles < min_tiles(N, n_ids) || !aligned16(tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fixed = 3 * (n_ids + 1);
  const int warps = min(32, (SEG_SMEM_INTS - fixed) / n_ids);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  segments_kernel<<<1, 32 * warps, (warps * n_ids + fixed) * 4,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int *>(ids), N, n_ids, max_tiles, static_cast<int *>(perm),
      static_cast<int *>(offsets), static_cast<int4 *>(tiles), static_cast<int *>(counters));
  return static_cast<int>(cudaGetLastError());
}

// nt: n8 rank tiles a block (1..16), ceil(R / 8 / nt) <= MAX_RCHUNKS chunks;
// splits: `in`'s k-tiles of 32 dealt in ceil(k_tiles / splits) a split, none
// empty; ws [splits, N, R] f32; t [N, R] f32.
extern "C" int lora_shrink(const void *x, long long ldx, const void *perm, const void *offsets,
                           const void *tiles, void *counters, int max_tiles, const void *A,
                           int n_ids, int num_layers, int layer, int in, int R, int nt,
                           int splits, void *ws, void *t, int N, void *stream) {
  const int k_tiles = (in + KT - 1) / KT;
  const int per = splits >= 1 ? (k_tiles + splits - 1) / splits : 0;
  const int chunks = nt >= 1 ? (R / 8 + nt - 1) / nt : 0;
  if (R % 8 != 0 || R < 8 || nt < 1 || nt > MAX_NT || chunks > MAX_RCHUNKS || N < 0 || in < 8 ||
      in % 8 != 0 || ldx % 8 != 0 || layer < 0 || layer >= num_layers || n_ids < 1 ||
      max_tiles < min_tiles(N, n_ids) || splits < 1 || (splits - 1) * per >= k_tiles ||
      !aligned16(x) || !aligned16(A) || !aligned16(tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_smem_limits();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (N == 0) return 0;
  const ShrinkArgs a{static_cast<const __nv_bfloat16 *>(x), ldx, static_cast<const int *>(perm),
                     static_cast<const int *>(offsets), static_cast<const int4 *>(tiles),
                     static_cast<int *>(counters), static_cast<const __nv_bfloat16 *>(A),
                     num_layers, layer, in, R, k_tiles, per, static_cast<float *>(ws),
                     static_cast<float *>(t), N};
  return static_cast<int>(shrink(nt, dim3(max_tiles, splits, chunks), a,
                                 reinterpret_cast<cudaStream_t>(stream)));
}

// Members j = 0, 1, 2 own columns [start_j, start_{j+1}) of y, with start_0
// = 0, start_1 = col1, start_2 = col2 and start_3 = out (col1 = col2 = out
// for one member); B_j is null for a member no adapter targets.
extern "C" int lora_expand(const void *t, long long ldt, const void *perm, const void *tiles,
                           int max_tiles, const void *B0, const void *B1, const void *B2,
                           int n_ids, int num_layers, int layer, int r, int col1, int col2,
                           int out, void *y, long long ldy, int N, void *stream) {
  const __nv_bfloat16 *bs[MAX_MEMBERS] = {static_cast<const __nv_bfloat16 *>(B0),
                                          static_cast<const __nv_bfloat16 *>(B1),
                                          static_cast<const __nv_bfloat16 *>(B2)};
  const int bounds[MAX_MEMBERS + 1] = {0, col1, col2, out};
  bool ok = r >= 1 && r <= MAX_RANK && N >= 0 && 0 <= col1 && col1 <= col2 && col2 <= out &&
            col1 % 8 == 0 && col2 % 8 == 0 && out % 8 == 0 && ldy % 8 == 0 && layer >= 0 &&
            layer < num_layers && n_ids >= 1 && max_tiles >= min_tiles(N, n_ids) &&
            aligned16(y) && aligned16(tiles);
  Members m{};
  for (int j = 0; j < MAX_MEMBERS; ++j) {
    if (!bs[j]) continue;
    ok = ok && aligned16(bs[j]);
    const int p = m.present++;
    m.B[p] = bs[j];
    m.start[p] = bounds[j];
    m.width[p] = bounds[j + 1] - bounds[j];
    m.seg[p] = p * r;
    m.tile0[p + 1] = m.tile0[p] + (m.width[p] + BN - 1) / BN;
  }
  if (!ok || ldt < static_cast<long long>(m.present) * r)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_smem_limits();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (N == 0 || m.tile0[m.present] == 0) return 0;
  const int r16 = (r + 15) / 16 * 16;
  expand_kernel<<<dim3(max_tiles, m.tile0[m.present]), E_THREADS, expand_smem(r16),
                  reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float *>(t), ldt, static_cast<const int *>(perm),
      static_cast<const int4 *>(tiles), m, num_layers, layer, r, r16,
      static_cast<__nv_bfloat16 *>(y), ldy);
  return static_cast<int>(cudaGetLastError());
}
