"""Products with 8-bit weights: weight-only int8 / fp8, W8A8 and W4A8.

Port of the 8-bit branches of ``rtp_llm_tpu/quant/weight_only.py``:
``quantized_matmul`` on int8 and e4m3 codes (per tensor, per out channel,
groupwise with an optional GPTQ zero), ``quantize_activations_per_token``,
``w8a8_matmul`` and ``w4a8_matmul``. In the JAX package these are XLA
matmuls with the int8 -> bf16 convert fused into the operand; PyTorch has no
such form, so each runs a hand-written CUDA kernel on the card:

* ``w8_matmul``  -> ``csrc/w8_gemm.cu`` (X1): x bf16 @ dequant(codes);
* ``act_quant``  -> ``csrc/act_quant.cu`` (X2): per-token int8 codes;
* ``i8_matmul``  -> ``csrc/i8_gemm.cu`` (X3): the s8 x s8 contraction with
  int32 group sums.

A module of its own beside ``quant_gemm.py``: the 4-bit module is about
nibble-packed storage and its launch plan, the 8-bit codes are stored one a
byte in JAX's ``[in, out]`` layout and share neither.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. The plain versions follow their references, with the scale
products in f32 and one rounding to x's type at the end (the JAX package
rounds each product, and each group partial, to x's type first; in f32
the two agree). The integer contractions run in f64, where every partial
sum (below 2**53) is exact, so the plain version runs on the card too.

A weight is never copied: the kernels take the layer's view of the
``[L, K, N]`` stack (``w[layer]``), contiguous by construction; a weight or
scale that is not contiguous raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import I32, I64, P
from rtp_llm_tpu_torch.ops.kv_cache import FP8
from rtp_llm_tpu_torch.ops.quant_gemm import _sm_count, subtract_zero_correction

CODES = {torch.int8: 0, FP8: 1}
MODES = {"tensor": 0, "channel": 1, "group": 2}
K_TILE = 64  # k rows of an i8_gemm ring k-tile (csrc/i8_gemm.cu RKT)
I8_TILE_K = 128  # k values of an i8_gemm tile-kernel k-tile (csrc/i8_gemm.cu TKT)
W8_K_TILE = 64  # k rows of a w8_gemm k-tile (csrc/w8_gemm.cu KT), both kernels
N_TILE = 128  # columns of a block
MAX_SPLITS = 8
TILE_ROWS = 128  # from here w8_gemm and i8_gemm run their wgmma tile kernels
ACT_CHUNK = 8  # bf16 values a 16-byte load of act_quant takes (csrc/act_quant.cu)
ACT_VPT_MAX = 16  # chunks a thread of act_quant holds (csrc/act_quant.cu VPT_MAX)
ACT_THREADS = 512  # threads of an act_quant block at most (csrc/act_quant.cu MAX_THREADS)

KERNELS = {
    "w8": _kernels.Kernel("w8_gemm", "w8_gemm.cu", "w8_gemm",
                          [P, I64, P, I32, P, I32, I32, P, P, I32, I32, I32, I32, I32, I32, P]),
    "act_quant": _kernels.Kernel("act_quant", "act_quant.cu", "act_quant",
                                 [P, I64, P, P, I32, I32, I32, I32, I32, P]),
    "i8": _kernels.Kernel("i8_gemm", "i8_gemm.cu", "i8_gemm",
                          [P, P, P, P, I32, P, P, I32, I32, I32, I32, I32, I32, P]),
}
PLAIN_CALLS = _kernels.Counter("quant_gemm8_plain")


# ---- plain versions ----------------------------------------------------------


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` correctly rounded on every device. PyTorch's CUDA kernels
    multiply by the reciprocal of a Python-number divisor, which differs
    from the division in the last bit now and then; a tensor divisor keeps
    the true division (the JAX package's, and act_quant's)."""
    return a / torch.full_like(a, b)


def scale_mode(scale: torch.Tensor) -> str:
    """"tensor" (one scale), "channel" (``[N]``) or "group" (``[K/G, N]``),
    as ``quantized_matmul`` tells them apart for a 2-D weight."""
    if scale.numel() == 1 and scale.dim() <= 1:
        return "tensor"
    return "channel" if scale.dim() == 1 else "group"


def w8_matmul_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of ``w8_gemm``: ``quantized_matmul``'s per-tensor,
    per-channel and groupwise branches on int8 / e4m3 codes ``w [K, N]``.
    The codes dequantize exactly in f32; products and scales are f32 and
    the result is rounded once to x's type."""
    PLAIN_CALLS.n += 1
    xf, wf = x.float(), w.float()
    mode = scale_mode(scale)
    if mode != "group":
        y = (xf @ wf) * scale.float().reshape(-1 if mode == "channel" else ())
        return y.to(x.dtype)
    g = scale.shape[-2]
    group = w.shape[-2] // g
    y = torch.zeros((*x.shape[:-1], w.shape[-1]), dtype=torch.float32, device=x.device)
    for i in range(g):  # the two-step form: each group's partial, then its scale row
        rows = slice(i * group, (i + 1) * group)
        y += (xf[..., rows] @ wf[rows]) * scale[i].float()
    return y.to(x.dtype)


def quantize_activations_ref(x: torch.Tensor):
    """Plain version of ``act_quant``: ``quantize_activations_per_token``.
    x ``[..., K]`` -> (s8 codes ``[..., K]``, f32 scale ``[..., 1]``)."""
    PLAIN_CALLS.n += 1
    xf = x.float()
    scale = true_div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors, rounded once to f32 as a fused
    multiply-add computes it. The product of two 24-bit significands is
    exact in f64; the sum is rounded to odd in f64 (where TwoSum finds it
    inexact and its last bit even, one f64 step toward the exact value), and
    a value rounded to odd with 29 bits to spare rounds to f32 as the exact
    value would."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    toward = torch.where(err > 0, math.inf, -math.inf)
    even = (s.view(torch.int64) & 1) == 0
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def i8_matmul_ref(xq: torch.Tensor, xs: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``i8_gemm``: per group of K the int32 sum of
    ``xq . w`` (exact in f64), to f32, times its scale row plus the sum of
    the groups before it, rounded once (``fma_f32``: the kernels' fused
    multiply-add, in their group order), times the per-token scale ``xs
    [..., 1]``, in ``dtype``. ``scale`` ``[N]`` is one group (W8A8), ``[K/G,
    N]`` G-row groups (W4A8)."""
    PLAIN_CALLS.n += 1
    s = scale.float().reshape(-1, w.shape[-1])
    group = w.shape[-2] // s.shape[0]
    xd, wd = xq.double(), w.double()
    y = torch.zeros((*xq.shape[:-1], w.shape[-1]), dtype=torch.float32, device=xq.device)
    for i in range(s.shape[0]):
        rows = slice(i * group, (i + 1) * group)
        y = fma_f32((xd[..., rows] @ wd[rows]).float(), s[i], y)
    return (y * xs.float()).to(dtype)


# ---- the kernels' launch plan ------------------------------------------------


def _plan(m: int, k: int, n: int, unit: int, sm_count: int, tile: bool, grouped: bool,
          kt: int):
    """(bm, splits, k-tiles a split) of an 8-bit GEMM for an ``[m, k] x [k,
    n]`` product whose K may be split only at multiples of ``unit`` rows (a
    scale group, or a k-tile of ``kt`` rows). Depends on shapes and the SM
    count only; no split is empty.

    The ring kernel (``tile`` false; 16, 32 or 64 rows, three or four blocks
    an SM): K is split while the output tiles alone leave SMs idle (to two
    blocks an SM, at most MAX_SPLITS); with as many blocks as SMs it stays
    whole (a split to even out the rounds was slower where it was timed:
    w8_gemm at Qwen2-7B gate-up, 64 rows, 296 blocks on 132 SMs, 0.109 ms
    split in two against 0.087 whole on an H100). The tile kernel, one block
    an SM: 256 rows or 128, whichever needs fewer rounds at 1.4x the time a
    round for 256 (gw_gemm_pipe's ratio); the grouped mode always 128 (its
    partial and sum fill the registers); K split four ways at most while SMs
    stay idle."""
    unit = math.lcm(unit, kt)
    units = -(-k // unit)
    nb = -(-n // N_TILE)
    if tile:
        cost = lambda b: -(-(-(-m // b) * nb) // sm_count) * (1.4 if b == 256 else 1.0)
        bm = 128 if grouped else min((128, 256), key=cost)
        blocks = -(-m // bm) * nb
        splits = max(1, min(sm_count // blocks, 4, units))
    else:
        bm = next(b for b in (16, 32, 64) if m <= b or b == 64)
        blocks = -(-m // bm) * nb
        splits = 1
        if blocks < sm_count:
            splits = max(1, min(-(-2 * sm_count // blocks), MAX_SPLITS, units))
    per = -(-units // splits)
    return bm, -(-units // per), per * unit // kt


def plan(m: int, k: int, n: int, unit: int, sm_count: int, grouped: bool = False):
    """(bm, splits, k-tiles a split) of i8_gemm (see ``_plan``): the ring
    kernel's 64-row k-tiles below 128 rows, the tile kernel's 128-row k-tiles
    from 128. Groups that are not a multiple of 128 rows, and a K that is
    not, take the ring at every row count (the tile kernel flushes group
    partials at its k-tiles' ends)."""
    tile = m >= TILE_ROWS and k % I8_TILE_K == 0 and not (grouped and unit % I8_TILE_K)
    return _plan(m, k, n, unit, sm_count, tile, grouped, I8_TILE_K if tile else K_TILE)


def w8_plan(m: int, k: int, n: int, unit: int, sm_count: int, grouped: bool = False):
    """(bm, splits, 64-row k-tiles a split) of w8_gemm (see ``_plan``): the
    ring kernel below 128 rows, the tile kernel from 128. Groups of 32 rows
    take the ring kernel at every row count (the tile kernel flushes group
    partials at its 64-row k-tiles' ends)."""
    tile = m >= TILE_ROWS and not (grouped and unit % W8_K_TILE)
    return _plan(m, k, n, unit, sm_count, tile, grouped, W8_K_TILE)


def act_plan(m: int, k: int, sm_count: int = 132):
    """(chunks a thread, warps a row, rows a block) of act_quant for ``m``
    rows of ``k`` values. A row is cut into 8-value chunks; thread t of a
    row's ``32 * warps`` holds chunks t, t + 32 * warps, ... (``vpt`` of
    them) in registers. The plan aims at 8 chunks a thread, and at 2 while
    the rows alone give fewer than two blocks an SM (few rows: the card is
    not filled, and a short chain of work a thread ends sooner), with up to
    16 warps a row; rows share a block up to 128 threads while two blocks
    an SM remain. These were the fastest of a sweep on an H100 (2 to 12
    chunks a thread, 128 to 512 threads a block) at the W4A8 decode and
    the prefill shapes of Qwen2-7B. Past 16 warps x 16 chunks (K > 65536) a
    row is taken in rounds. The kernel runs a ``vpt`` of 9-15 (K > 32768)
    as 16, and the scalar path's as 2, 8 or 16, the chunks past the row
    masked; on the 16-byte path, 8 chunks where 7 cover the row took 3-8%
    more time at K = 3584 from 1000 rows on an H100."""
    chunks = -(-k // ACT_CHUNK)
    spread = 2 * sm_count
    per = 8 if m >= spread else 2
    warps = max(1, min(ACT_THREADS // 32, -(-chunks // (32 * per))))
    vpt = max(1, min(ACT_VPT_MAX, -(-chunks // (32 * warps))))
    rows = max(1, min(4 // warps, m // spread))
    return vpt, warps, rows


def _check_weight(w, scale, x2, k_tile):
    m, k = x2.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"weight must be [K, N] with K = {k}, got {tuple(w.shape)}")
    n = w.shape[1]
    if not w.is_contiguous() or not scale.is_contiguous():
        raise ValueError("weight and scale must be contiguous (the wrapper never copies a weight)")
    if w.device != x2.device or scale.device != x2.device:
        raise ValueError("x, weight and scale must be on one device")
    if scale.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scale.dtype}")
    if k % k_tile or n % 16:
        raise NotImplementedError(
            f"the 8-bit kernels need K % {k_tile} == 0 and N % 16 == 0; got K={k}, N={n}")
    if w.data_ptr() % 16 or scale.data_ptr() % 4:
        raise ValueError("the weight must be 16-byte aligned")
    return m, k, n


def _launch_w8(x2, w, scale):
    m, k, n = _check_weight(w, scale, x2, W8_K_TILE)
    if x2.dtype != torch.bfloat16:
        raise NotImplementedError(f"w8_gemm takes bf16 x, got {x2.dtype}")
    if w.dtype not in CODES:
        raise NotImplementedError(f"w8_gemm takes int8 or float8_e4m3fn codes, got {w.dtype}")
    mode = scale_mode(scale)
    group = k
    if mode == "channel" and scale.shape != (n,):
        raise ValueError(f"a per-channel scale must be [{n}], got {tuple(scale.shape)}")
    if mode == "group":
        g = scale.shape[0]
        if scale.shape != (g, n) or k % g:
            raise ValueError(f"a group scale must be [K/G, {n}], got {tuple(scale.shape)}")
        group = k // g
        if group % 32:
            raise NotImplementedError(f"w8_gemm needs group % 32 == 0, got {group}")
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()  # an activation, M x K: small beside the weight
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    if m == 0:
        return out
    bm, splits, tiles = w8_plan(m, k, n, group if mode == "group" else W8_K_TILE,
                                _sm_count(x2.device), grouped=mode == "group")
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x2.device) if splits > 1 else None
    KERNELS["w8"].launch(
        x2.data_ptr(), x2.stride(0), w.data_ptr(), CODES[w.dtype], scale.data_ptr(),
        MODES[mode], group, out.data_ptr(), ws.data_ptr() if ws is not None else None,
        m, k, n, splits, tiles, bm, _kernels.stream_ptr(x2.device))
    return out


def w8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, *,
              zero_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ dequant(w) for int8 / e4m3 codes ``w [K, N]`` (a layer's view
    of a stack): ``scale`` one f32 (per tensor), ``[N]`` (per out channel)
    or ``[K/G, N]`` (groupwise); ``zero_scale = zero * scale`` of a GPTQ
    checkpoint subtracts the zero points' share afterwards."""
    n = w.shape[-1]
    if x.device.type == "cpu":
        y = w8_matmul_ref(x, w, scale)
    else:
        y = _launch_w8(x.reshape(-1, x.shape[-1]), w, scale).reshape(*x.shape[:-1], n)
    if zero_scale is not None:
        y = subtract_zero_correction(y, x, zero_scale)
    return y


def act_quant(x: torch.Tensor):
    """Per-token int8 codes ``[..., K]`` and f32 scales ``[..., 1]`` of x."""
    if x.device.type == "cpu":
        return quantize_activations_ref(x)
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype != torch.bfloat16:
        raise NotImplementedError(f"act_quant takes bf16 x, got {x2.dtype}")
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    m, k = x2.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x2.device)
    if m:
        vpt, warps, rows = act_plan(m, k, _sm_count(x2.device))
        KERNELS["act_quant"].launch(x2.data_ptr(), x2.stride(0), q.data_ptr(), s.data_ptr(),
                                    m, k, vpt, warps, rows, _kernels.stream_ptr(x2.device))
    return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


def _launch_i8(xq2, xs2, w, scale):
    m, k, n = _check_weight(w, scale, xq2, K_TILE)
    if xq2.dtype != torch.int8 or w.dtype != torch.int8:
        raise NotImplementedError("i8_gemm takes int8 activations and weights")
    s = scale.reshape(-1, n)
    g = s.shape[0]
    if k % g or (k // g) % 32:
        raise NotImplementedError(f"i8_gemm needs group % 32 == 0; K={k}, groups={g}")
    group = k // g
    xq2, xs2 = xq2.contiguous(), xs2.contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq2.device)
    if m == 0:
        return out
    bm, splits, tiles = plan(m, k, n, group if g > 1 else K_TILE, _sm_count(xq2.device),
                             grouped=g > 1)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=xq2.device) if splits > 1 else None
    KERNELS["i8"].launch(
        xq2.data_ptr(), xs2.data_ptr(), w.data_ptr(), s.data_ptr(), group, out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, k, n, splits, tiles, bm,
        _kernels.stream_ptr(xq2.device))
    return out


def i8_matmul(xq: torch.Tensor, xs: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The integer contraction: xq ``[..., K]`` s8 with scales xs ``[..., 1]``
    against s8 ``w [K, N]`` with ``scale`` ``[N]`` (one group) or ``[K/G,
    N]``; the result in ``dtype`` (bf16 on the card)."""
    n = w.shape[-1]
    if xq.device.type == "cpu":
        return i8_matmul_ref(xq, xs, w, scale, dtype)
    if dtype != torch.bfloat16:
        raise NotImplementedError(f"i8_gemm writes bf16, not {dtype}")
    y = _launch_i8(xq.reshape(-1, xq.shape[-1]), xs.reshape(-1), w, scale)
    return y.reshape(*xq.shape[:-1], n)


def w4a8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """W4A8: per-token int8 activations against int4 values (int8 storage)
    with groupwise scales ``[K/G, N]``; the contraction in integers."""
    xq, xs = act_quant(x)
    return i8_matmul(xq, xs, w, scale, x.dtype)


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                decode: bool = False) -> torch.Tensor:
    """W8A8: per-token int8 activations against per-channel int8 weights,
    int32-accumulated. A decode step (one token a row) takes the
    weight-only product instead, as the JAX package does for T = 1: the
    integer form reads the same weight bytes and only adds the activation
    quantization there."""
    if decode:
        return w8_matmul(x, w, scale)
    xq, xs = act_quant(x)
    return i8_matmul(xq, xs, w, scale, x.dtype)
