"""Groupwise dequant-GEMM over nibble-packed 4-bit weights.

Port of ``rtp_llm_tpu/ops/quant_gemm.py``. ``groupwise_matmul_packed`` is the
wrapper of the hand-written CUDA kernels ``csrc/gw_gemm.cu`` (``gw_gemm``
replaces the Pallas ``_gw_kernel``, ``gw_gemm_pipe`` replaces
``_gw_kernel_pipe``) and ``csrc/gw_gemm_partial.cu`` (``gw_gemm_partial``
replaces the sweep kernels of ``benchmarks/int4_kernel_sweep.py``). A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain version.
The plain versions live here too: the CPU tests hold them against the JAX
package, and on the card the kernels are held against them.

Storage (the JAX package's, bit for bit): split-half nibble packing along the
*in* dim. ``byte[i, n]`` holds ``code(w[i, n])`` in the low nibble and
``code(w[i + K/2, n])`` in the high nibble, so each nibble plane is a
contiguous ``[K/2, N]`` matrix that meets its half of x. The out dim is not
packed. Codes: ``"s4"`` are offset codes (value = nibble - 8); ``"e2m1"`` is
fp4, sign(1) exp(2) mant(1). Group scales are f32 ``[K/G, N]`` over the
original rows: the low plane uses scale rows ``[0, K/2G)``, the high plane
rows ``[K/2G, K/G)``.

The zero point of GPTQ/AWQ weights is not in the kernels. It factors out of
the contraction as a rank-K/G correction,
``y -= (sum over each group of x) @ (zero * scale)``, applied here in f32.
The JAX package multiplies ``zero * scale`` inside the jitted step, where
XLA hoists it; PyTorch has no compiler to do that, so a caller may pass the
product, computed once at load, as ``zero_scale``.

The JAX package's stacked mode (the whole ``[L, K/2, N]`` stack plus a
scalar-prefetched layer index) exists because slicing a stack copies under
XLA. Here ``packed[layer]`` of a contiguous stack is a free contiguous view
and the kernel gets its pointer. The wrapper never copies a weight: a packed
or scale tensor that is not contiguous raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import I32, I64, P

_ARGTYPES = [P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, P]
KERNELS = {
    "base": _kernels.Kernel("gw_gemm", "gw_gemm.cu", "gw_gemm", _ARGTYPES),
    "pipe": _kernels.Kernel("gw_gemm_pipe", "gw_gemm.cu", "gw_gemm_pipe", _ARGTYPES),
    "partial": _kernels.Kernel("gw_gemm_partial", "gw_gemm_partial.cu",
                               "gw_gemm_partial", _ARGTYPES),
}
PLAIN_CALLS = _kernels.Counter("groupwise_matmul_plain")

CODES = {"s4": 0, "e2m1": 1}
K_TILE = 32  # packed rows per kernel k-tile, the unit K is split in (csrc/gw_common.cuh KT)
MAX_SPLITS = 8
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may ask for on sm_90
_E2M1 = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


# ---- packing and decoding (plain) ------------------------------------------


def pack_split_half(q: torch.Tensor, code: str = "s4") -> torch.Tensor:
    """Integer codes ``[..., K, N]`` -> u8 ``[..., K/2, N]``, low nibble = row
    k, high nibble = row k + K/2. ``"s4"`` values in [-8, 7] are stored as
    offset codes (v + 8); ``"e2m1"`` u4 codes pass through."""
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"pack_split_half needs an even in dim, got {tuple(q.shape)}")
    qi = q.to(torch.int16)
    if code == "s4":
        qi = qi + 8
        if qi.numel() and (int(qi.min()) < 0 or int(qi.max()) > 15):
            raise ValueError("s4 values must lie in [-8, 7]")
    u = (qi & 0xF).to(torch.uint8)
    return u[..., : k // 2, :] | (u[..., k // 2:, :] << 4)


def decode_nibble(c: torch.Tensor, code: str, dtype: torch.dtype) -> torch.Tensor:
    """u8 nibble values (0..15) -> the weight values they stand for."""
    if code == "s4":
        return (c.to(torch.int16) - 8).to(dtype)
    if code != "e2m1":
        raise ValueError(f"unknown 4-bit code {code!r}")
    table = torch.tensor(_E2M1 + tuple(-v for v in _E2M1), dtype=dtype, device=c.device)
    return table[c.long()]


def _planes(packed, scale, code, dtype):
    """(low, high) planes: decoded values ``[K/2, N]`` and their scale rows."""
    g = scale.shape[-2]
    if g % 2:
        raise ValueError("split-half packing needs an even number of scale groups")
    return ((decode_nibble(packed & 0xF, code, dtype), scale[: g // 2]),
            (decode_nibble(packed >> 4, code, dtype), scale[g // 2:]))


def dequantize(packed: torch.Tensor, scale: torch.Tensor, code: str = "s4") -> torch.Tensor:
    """The f32 ``[K, N]`` weight the packed bytes and scales stand for."""
    group = 2 * packed.shape[-2] // scale.shape[-2]
    return torch.cat([v * s.float().repeat_interleave(group, dim=0)
                      for v, s in _planes(packed, scale, code, torch.float32)])


def groupwise_matmul_ref(x, packed, scale, code: str = "s4") -> torch.Tensor:
    """Plain version of ``gw_gemm`` / ``gw_gemm_pipe``: dequantize in f32,
    round to x's type, ``x @ W`` with the result in x's type."""
    PLAIN_CALLS.n += 1
    return x @ dequantize(packed, scale, code).to(x.dtype)


def groupwise_matmul_partial_ref(x, packed, scale, code: str = "s4") -> torch.Tensor:
    """Plain version of ``gw_gemm_partial``: the two-step form. Per group the
    unscaled codes are multiplied with their slice of x into an f32 partial,
    which is then scaled by ``s[group, n]`` and added up in f32."""
    PLAIN_CALLS.n += 1
    k2, n = packed.shape
    group = 2 * k2 // scale.shape[-2]
    xf = x.reshape(-1, 2 * k2).float()
    y = torch.zeros((xf.shape[0], n), dtype=torch.float32, device=x.device)
    for plane, (vals, s) in enumerate(_planes(packed, scale, code, torch.float32)):
        xh = xf[:, plane * k2: (plane + 1) * k2]
        for gi in range(k2 // group):
            rows = slice(gi * group, (gi + 1) * group)
            y += (xh[:, rows] @ vals[rows]) * s[gi].float()
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


def zero_correction(x: torch.Tensor, zero_scale: torch.Tensor) -> torch.Tensor:
    """``(sum over each group of x) @ (zero * scale)`` in f32, ``[..., N]``."""
    g = zero_scale.shape[-2]
    xsum = torch.sum(x.reshape(*x.shape[:-1], g, x.shape[-1] // g), dim=-1,
                     dtype=torch.float32)
    return xsum @ zero_scale.float()


def subtract_zero_correction(y, x, zero_scale) -> torch.Tensor:
    """``y -= zero_correction(x, zero_scale)``, in place on the product the
    kernel (or the plain version) has just written. The f32 correction is
    subtracted in f32 and the difference rounded once to y's type; the JAX
    package rounds the correction to y's type first. Three launches a call."""
    return y.sub_(zero_correction(x, zero_scale))


# ---- the kernels' launch plan ----------------------------------------------


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan(m: int, k: int, n: int, sm_count: int, variant: str = "base"):
    """(bm, bn, splits) for an ``[m, k] x [k, n]`` product: the rows and
    columns one block owns and the number of K splits. Depends on shapes and
    the SM count only. No split is empty.

    ``pipe`` / ``partial``: 128-wide tiles when they alone fill the SMs, else
    64-wide ones, and K split across blocks until about two blocks per SM
    exist (o_proj / down_proj at decode: N = 3584 gives 28 wide tiles for 132
    SMs). ``base`` (gw_gemm): the same below 128 rows, but until three blocks
    per SM exist (its ring leaves room for them); from 128 rows on, 128 x 128
    blocks (two an SM) whose weights are decoded once a block, K split (four
    ways at most: every split writes its f32 partial) only while block slots
    of the SMs stay empty."""
    ktiles = k // 2 // K_TILE
    if variant == "base" and m >= 128:
        bm = bn = 128
        blocks = -(-m // bm) * -(-n // bn)
        splits = max(1, min(2 * sm_count // blocks, 4, ktiles))
    else:
        max_bm = 32 if variant == "partial" else 64
        bm = next(b for b in (16, 32, 64) if m <= b or b == max_bm)
        mb = -(-m // bm)
        bn = 128 if mb * -(-n // 128) >= sm_count else 64
        blocks = mb * -(-n // bn)
        if variant == "base":
            # its ring keeps three blocks on an SM: fill them, never overfill
            want = 3 * sm_count // blocks
            if want <= 1:
                # more blocks than SMs: the SMs that get one block more set
                # the time (296 blocks on 132 SMs: 3 rounds for 2.24 of work).
                # Splitting K evens that out while the f32 partials stay
                # under a fifth of the weight bytes (few rows only).
                rounds = lambda s: -(-blocks * s // sm_count) / s
                allowed = [s for s in (1, 2, 3, 4) if s == 1 or 80 * s * m <= k]
                want = min(allowed, key=lambda s: (round(rounds(s), 6), s))
        else:
            want = -(-2 * sm_count // blocks)
        splits = max(1, min(want, MAX_SPLITS, ktiles))
    per_split = -(-ktiles // splits)
    return bm, bn, -(-ktiles // per_split)


def ring_plan(bm: int, bn: int) -> dict:
    """The shared-memory ring of ``gw_gemm`` for a (bm, bn) block, as
    csrc/gw_gemm.cu lays it out: stages, packed rows a stage, bytes a stage
    and a block, and the packed weight bytes a block keeps in flight."""
    kt = K_TILE
    if bm >= 128:  # swizzled x tile, packed rows of pitch bn + 16, padded to 1 KB; alignment slack
        stages, extra = 4, 1024
        stage = -(-(bm * 2 * kt * 2 + kt * (bn + 16) + 2 * bn * 4) // 1024) * 1024
    else:
        stages, extra = {16: 6, 32: 5, 64: 4}[bm], 0
        stage = kt * (bn + 16) + bm * (2 * kt + 8) * 2 + 2 * bn * 4
    return {"stages": stages, "k_tile": kt, "scale_rows": 2, "stage_bytes": stage,
            "smem_bytes": stages * stage + extra,
            "weight_bytes_in_flight": (stages - 1 - (bm >= 128)) * kt * bn}


def split_rows(k: int, splits: int, index: int) -> tuple[int, int]:
    """Packed rows [r0, r1) that K split ``index`` of ``splits`` covers."""
    ktiles = k // 2 // K_TILE
    per_split = -(-ktiles // splits)
    return (min(index * per_split, ktiles) * K_TILE,
            min((index + 1) * per_split, ktiles) * K_TILE)


def _launch(x2, packed, scale, code, variant, tile):
    m, k = x2.shape
    k2, n = packed.shape
    g = scale.shape[0]
    group = k // g if g else 0
    if x2.dtype != torch.bfloat16:
        raise NotImplementedError(f"the gw_gemm kernels take bf16 x, got {x2.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError("packed must be uint8 and scale float32")
    if k != 2 * k2 or g == 0 or k % g or k % (2 * group):
        raise NotImplementedError(
            f"the gw_gemm kernels need K % (2 * group) == 0; got K={k}, groups={g}")
    if group % K_TILE:
        raise NotImplementedError(f"the gw_gemm kernels need group % {K_TILE} == 0, got {group}")
    if n % 16:
        raise NotImplementedError(f"the gw_gemm kernels load 16 bytes along N: N % 16 != 0 (N={n})")
    if scale.shape != (g, n) or not packed.is_contiguous() or not scale.is_contiguous():
        raise ValueError("packed [K/2, N] and scale [K/G, N] must be contiguous "
                         "(the wrapper never copies a weight)")
    if packed.device != x2.device or scale.device != x2.device:
        raise ValueError("x, packed and scale must be on one device")
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()  # an activation, M x K: small beside the weight
    if packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("packed and scale must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    if m == 0:
        return out
    bm, bn, splits = tile or plan(m, k, n, _sm_count(x2.device), variant)
    ws = None
    if splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
    KERNELS[variant].launch(
        x2.data_ptr(), x2.stride(0), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, k, n, group, CODES[code],
        splits, bm, bn, _kernels.stream_ptr(x2.device))
    return out


def groupwise_matmul_packed(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
    code: str = "s4", zero: Optional[torch.Tensor] = None,
    zero_scale: Optional[torch.Tensor] = None, layer: Optional[int] = None,
    variant: str = "base", tile: Optional[tuple] = None,
) -> torch.Tensor:
    """y = x @ dequant(packed) (+ the GPTQ/AWQ zero correction).

    x ``[..., K]``; packed u8 ``[K/2, N]``, or the per-layer stack
    ``[L, K/2, N]`` with ``layer`` (a view, never a copy); scale f32
    ``[K/G, N]``; ``zero`` f32 ``[K/G, N]`` or its product with the scale as
    ``zero_scale``. ``variant``: ``base`` (gw_gemm), ``pipe`` (gw_gemm_pipe,
    the same result) or ``partial`` (gw_gemm_partial, the group-partial
    form). ``tile`` overrides ``plan``'s (bm, bn, splits): the tile sweep."""
    if variant not in KERNELS:
        raise ValueError(f"unknown variant {variant!r}")
    if code not in CODES:
        raise ValueError(f"unknown 4-bit code {code!r}")
    if layer is not None:
        packed = packed[layer]
    if packed.dim() != 2:
        raise ValueError("packed must be [K/2, N], or [L, K/2, N] with a layer index")
    n = packed.shape[-1]
    if x.device.type == "cpu":
        ref = groupwise_matmul_partial_ref if variant == "partial" else groupwise_matmul_ref
        y = ref(x, packed, scale, code)
    else:
        y = _launch(x.reshape(-1, x.shape[-1]), packed, scale, code, variant, tile)
        y = y.reshape(*x.shape[:-1], n)
    if zero is not None and zero_scale is None:
        zero_scale = zero * scale
    if zero_scale is not None:
        y = subtract_zero_correction(y, x, zero_scale)
    return y
