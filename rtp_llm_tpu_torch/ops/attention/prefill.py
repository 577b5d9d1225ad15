"""Paged causal prefill attention: wrapper of ``csrc/paged_prefill.cu``.

Replaces ``rtp_llm_tpu/ops/attention/pallas_prefill.py::paged_prefill_attention``
and takes B rows at once with per-row ``q_offsets`` / ``kv_lens`` (the JAX
kernel's single-row contract is B = 1). A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version, ``paged_prefill_ref``.

The JAX package sends prefill over a quantized pool through its plain path;
here the kernel reads an int8 pool (with ``[NS, Hkv]`` bf16 scales) or an
fp8 e4m3 pool itself, one C entry per pool element type and head width
(``KERNELS_BY_DIM``, head_dim 64 / 96 / 128 / 256; ``KERNELS`` the 128
ones). ``soft_cap`` > 0 caps every score (gemma2), as in ``decode.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import F32, I32, I64, P
from rtp_llm_tpu_torch.ops.attention.decode import (
    POOL_ENTRIES, HEAD_DIM, HEAD_DIMS, MAX_GROUP, dim_suffix, check_head, check_pools,
)
from rtp_llm_tpu_torch.ops.attention.ref import paged_attention_ref
from rtp_llm_tpu_torch.ops.kv_cache import FP8

_ARGTYPES = [P, P, P, I64, I64, P, P, I64, P, I32, P, P, P,
             I32, I32, I32, I32, I32, I32, F32, F32, P]
# (pool element type, head dim) -> its C entry (launches counted per entry)
KERNELS_BY_DIM = {
    (dtype, d): _kernels.Kernel(name.replace("decode", "prefill") + dim_suffix(d),
                                "paged_prefill.cu",
                                entry.replace("decode", "prefill") + dim_suffix(d), _ARGTYPES)
    for dtype, name, entry in POOL_ENTRIES for d in HEAD_DIMS
}
# pool element type -> its head_dim 128 entry
KERNELS = {dtype: KERNELS_BY_DIM[(dtype, HEAD_DIM)] for dtype, _, _ in POOL_ENTRIES}
KERNEL = KERNELS[torch.bfloat16]


def kernel_for(dtype: torch.dtype, d: int) -> _kernels.Kernel:
    """The entry of a pool type and head width (``KERNELS`` for 128)."""
    return KERNELS[dtype] if d == HEAD_DIM else KERNELS_BY_DIM[(dtype, d)]

# the kernel's tiling (csrc/paged_prefill.cu BM, KT, Smem<D>::STAGES)
BLOCK_ROWS = 128  # product rows a block: tokens x query heads of one kv head
KEY_TILE = 64  # keys per ring stage
RING_STAGES = 4  # up to D 128; ring_stages(d)
MAX_BLOCK_SMEM = 232448  # dynamic shared memory a block may take


def ring_stages(d: int) -> int:
    """Ring stages of ``KEY_TILE`` keys at head width ``d``: four up to D
    128; two at D 256, whose Q (64 KB) and K / V tiles (32 KB each) leave
    room for no more in a block's 227 KB."""
    return RING_STAGES if d <= 128 else 2


class TilePlan(NamedTuple):
    """How the kernel cuts ``[B, T, Hq]`` queries into blocks."""

    group: int  # G = Hq / Hkv query heads stacked into a block's rows
    tokens: int  # TQ: query tokens a block
    rows: int  # live product rows a block, TQ * G <= BLOCK_ROWS
    key_tile: int
    grid: tuple  # (query tiles, kv heads, rows of the batch)
    smem_bytes: int  # dynamic shared memory a block


def staged_dims(d: int) -> int:
    """Dims a shared-memory row of Q, K and V holds for head width ``d``:
    whole 64-dim halves of 128 bytes, wgmma's 128-byte swizzle atom. D 96
    stages a second half of which it fills 32 dims: S = Q K^T runs its six
    k16 steps, P V its N 128 product, whose last 32 columns it drops."""
    return -(-d // 64) * 64


def tile_plan(b: int, t: int, hq: int, hkv: int, head_dim: int = HEAD_DIM) -> TilePlan:
    """The launch plan of ``paged_prefill_*`` (pure Python; the kernel
    derives the same numbers from Hq, Hkv and T). A block owns all G query
    heads of one kv head for ``BLOCK_ROWS // G`` tokens."""
    if hkv <= 0 or hq % hkv or not 1 <= hq // hkv <= MAX_GROUP:
        raise ValueError(f"Hq/Hkv must be an integer in 1..{MAX_GROUP}; got {hq}/{hkv}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}; got {head_dim}")
    g = hq // hkv
    tq = BLOCK_ROWS // g
    row_bytes = staged_dims(head_dim) * 2
    # Q, the ring of (K, V) stages, and slack to align the base to 1 KB
    smem = BLOCK_ROWS * row_bytes + ring_stages(head_dim) * 2 * KEY_TILE * row_bytes + 1024
    return TilePlan(g, tq, tq * g, KEY_TILE, (-(-t // tq), hkv, b), smem)


def row_token_head(plan: TilePlan, r: int):
    """Block row ``r`` -> (token within the query tile, query head within the
    kv head's group), or None for a padding row (``r >= plan.rows``)."""
    return divmod(r, plan.group) if r < plan.rows else None


def tile_is_live(plan: TilePlan, qtile: int, q_offset: int, kv_len: int) -> bool:
    """A query tile whose first position is at or past ``kv_len`` is bucket
    padding: the kernel writes its zeros and loads nothing."""
    return q_offset + qtile * plan.tokens < kv_len


def key_tiles(plan: TilePlan, qtile: int, t: int, q_offset: int, kv_len: int,
              window: int = 0) -> range:
    """First key positions of the key tiles a live query tile walks: from
    the tile holding the lowest key its first token may see to the causal
    span's end (its last token's position, capped by ``kv_len``)."""
    first = qtile * plan.tokens
    span = min(q_offset + min(first + plan.tokens, t), kv_len)
    lo = max(0, q_offset + first - window + 1) if window > 0 else 0
    return range(lo // plan.key_tile * plan.key_tile, span, plan.key_tile)


def paged_prefill_ref(q, k_cache, v_cache, block_tables, q_offsets, kv_lens,
                      sm_scale, block_size, sliding_window=0, k_scale=None,
                      v_scale=None, soft_cap=0.0):
    """Plain version: the reference attention with padded bucket-tail rows
    (query position >= kv_len) set to zero, as the kernel outputs them."""
    out = paged_attention_ref(q, k_cache, v_cache, block_tables, kv_lens,
                              q_offsets, sm_scale, block_size,
                              sliding_window=sliding_window,
                              k_scale=k_scale, v_scale=v_scale, soft_cap=soft_cap)
    t = q.shape[1]
    q_pos = q_offsets.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    live = q_pos < kv_lens.long()[:, None]
    return torch.where(live[:, :, None, None], out, torch.zeros_like(out))


def paged_prefill_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k_cache: torch.Tensor,  # [NS, Hkv*D]; this chunk's KV already written
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int
    q_offsets: torch.Tensor,  # [B] int: absolute position of q[:, 0] (reused prefix)
    kv_lens: torch.Tensor,  # [B] int: total tokens including this chunk
    sm_scale: float,
    block_size: int,
    sliding_window: int = 0,
    k_scale: torch.Tensor | None = None,  # [NS, Hkv] bf16: int8 pool only
    v_scale: torch.Tensor | None = None,
    soft_cap: float = 0.0,  # > 0: scores cap * tanh(s / cap)
) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_prefill_ref(q, k_cache, v_cache, block_tables, q_offsets,
                                 kv_lens, sm_scale, block_size, sliding_window,
                                 k_scale, v_scale, soft_cap)
    b, t, hq, d = q.shape
    hd = k_cache.shape[-1]
    hkv = hd // d
    check_head(d, hq, hkv, "paged_prefill")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"paged_prefill kernel takes bf16 queries, got {q.dtype}")
    check_pools(k_cache, v_cache, k_scale, v_scale, hd, hkv)
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    offs = q_offsets.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    kernel_for(k_cache.dtype, d).launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), v_cache.stride(0),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        k_scale.stride(0) if k_scale is not None else 0,
        bt.data_ptr(), bt.shape[1],
        offs.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, t, hq, hkv, block_size, int(sliding_window), float(sm_scale), float(soft_cap),
        _kernels.stream_ptr(q.device),
    )
    return out
