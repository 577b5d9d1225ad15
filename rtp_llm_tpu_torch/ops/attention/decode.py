"""Paged decode attention (T = 1): wrapper of ``csrc/paged_decode.cu``.

Replaces ``rtp_llm_tpu/ops/attention/pallas_decode.py::paged_decode_attention``
(its ``_fullrow_kernel`` and ``_decode_kernel`` contracts, and the former's
int8 ``quant`` mode and fp8 pool). A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version, ``paged_decode_ref``. The
kernel reads the pool through a row stride, so a ``cache[l, 0]`` view of the
``[L, 2, NS, Hkv*D]`` pool needs no copy; the int8 pool's scales arrive the
same way, as ``[NS, Hkv]`` bf16 views of its scale tensor, and are read
through the block table inside the kernel.

One C entry per pool element type and head width (``KERNELS_BY_DIM``:
head_dim 64, 80, 96, 128 and 256; ``KERNELS`` holds the 128 ones), each with
its own launch count, so a run shows which entry served. The JAX package
runs its Pallas kernels at head_dim 128 and 256 and serves 64, 80 (Phi-2)
and 96 through its plain XLA path; the port has no plain path on the card,
so the kernel takes every width itself.

Groups: the kernel holds the G = Hq / Hkv query heads of a kv head on the
N = 8 of one ``mma.m16n8k16`` up to G 8, and on two such n8 tiles up to G 16
(D 64 and D 128: StarCoder2's 9, Command R+'s 12, Falcon-40B's 16 at D 64;
the template picks at launch, each K / V strip still read once a kv head).
Wider groups, up to G 128 at D 64 and D 128 (StarCoder's 48 on one kv head,
Falcon-7B's 71), run the two-tile code in chunks of ``CHUNK`` heads, one
block a chunk (``head_chunks``): each chunk reads the kv head's strips
again. The JAX package's Pallas kernel takes any G by zero-expanding the
query over the kv heads.

``soft_cap`` > 0 (gemma2's attention logit soft-cap) caps every score,
``cap * tanh(s / cap)`` on the scaled score, in the kernel (a runtime mode of
every entry). The JAX package serves a capped model through its XLA plain
path.

``alibi_slopes`` (f32 ``[Hq]``; bloom, baichuan-13B, mpt, falcon) adds
``slope[h] * (p - (kv_len - 1))`` to the scaled score of query head h at
cache position p (0 for the current token), a runtime mode of every entry
(a null pointer turns it off), counted per entry in ``ALIBI``. The JAX
package's Pallas decode gate refuses ALiBi and serves it through its XLA
plain path. It does not combine with ``soft_cap`` (no published model has
both).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import F32, I32, I64, P
from rtp_llm_tpu_torch.ops.attention.ref import paged_attention_ref
from rtp_llm_tpu_torch.ops.kv_cache import FP8

_ARGTYPES = [P, P, P, I64, I64, P, P, I64, P, I32, P, P, P, I64, P, P, P,
             I32, I32, I32, I32, I32, F32, F32, P, I32, P]
# the head widths the kernels serve; 128 is the first served
HEAD_DIMS = (64, 80, 96, 128, 256)
HEAD_DIM = 128
POOL_ENTRIES = ((torch.bfloat16, "paged_decode", "paged_decode_bf16"),
                 (torch.int8, "paged_decode_i8", "paged_decode_i8"),
                 (FP8, "paged_decode_e4m3", "paged_decode_e4m3"))


def dim_suffix(d: int) -> str:
    return "" if d == HEAD_DIM else f"_d{d}"


# (pool element type, head dim) -> its C entry (launches counted per entry)
KERNELS_BY_DIM = {
    (dtype, d): _kernels.Kernel(name + dim_suffix(d), "paged_decode.cu", entry + dim_suffix(d),
                                _ARGTYPES)
    for dtype, name, entry in POOL_ENTRIES for d in HEAD_DIMS
}
# pool element type -> its head_dim 128 entry
KERNELS = {dtype: KERNELS_BY_DIM[(dtype, HEAD_DIM)] for dtype, _, _ in POOL_ENTRIES}
KERNEL = KERNELS[torch.bfloat16]
# launches of the two-head-tile mode (G 9-16, D 64 / 128) by pool element
# type: counted beside the entry's own count, where the wrapper launches it
WIDE_GROUP = {dtype: _kernels.Counter(name + "_g9to16") for dtype, name, _ in POOL_ENTRIES}
# launches of the head-chunk mode (G 17-128, D 64 / 128) by pool element type
GROUP_WIDE = {dtype: _kernels.Counter(name + "_gwide") for dtype, name, _ in POOL_ENTRIES}
# launches in ALiBi mode by (pool element type, head dim), beside the entry's
# own count
ALIBI = {key: _kernels.Counter(k.name + "_alibi") for key, k in KERNELS_BY_DIM.items()}


def kernel_for(dtype: torch.dtype, d: int) -> _kernels.Kernel:
    """The entry of a pool type and head width (``KERNELS`` for 128, so that
    a swap there reaches the launches)."""
    return KERNELS[dtype] if d == HEAD_DIM else KERNELS_BY_DIM[(dtype, d)]


def max_group(d: int) -> int:
    """The largest G = Hq / Hkv the kernels take at head width ``d``: 128
    at D 64 and D 128 (two n8 head tiles, in chunks past 16), one tile
    elsewhere."""
    return MAX_GROUP if d in WIDE_DIMS else N8


def head_tiles(g: int) -> int:
    """n8 tiles of query heads a block holds (``paged_decode_kernel``'s NT):
    one up to G 8, two past it (a wide group's chunks too)."""
    return 1 if g <= N8 else 2


def head_chunks(g: int) -> list[tuple[int, int]]:
    """(first head, heads) of each chunk of a kv head's group of ``g``: the
    kernel's ``blockIdx.y % chunks``; one chunk up to ``CHUNK`` heads (G 71:
    four of 16 and one of 7)."""
    return [(c, min(CHUNK, g - c)) for c in range(0, g, CHUNK)]


def check_head(d: int, hq: int, hkv: int, kernel: str) -> None:
    """Raise on a head layout the attention kernels do not take."""
    if d not in HEAD_DIMS or hkv <= 0 or hq % hkv or hq // hkv > max_group(d):
        raise NotImplementedError(
            f"{kernel} kernel takes head_dim in {HEAD_DIMS} and Hq/Hkv <= "
            f"{MAX_GROUP} at D {' / '.join(map(str, WIDE_DIMS))}, <= {N8} at the others; "
            f"got D={d}, Hq={hq}, Hkv={hkv}")

N8 = 8  # query heads an mma n8 tile holds
CHUNK = 16  # query heads a block holds at most: two n8 tiles
MAX_GROUP = 128  # query heads a kv head, in chunks of CHUNK
WIDE_DIMS = (64, 128)  # head widths that take groups past N8
# the kernel's work split (csrc/paged_decode.cu): a block of WARPS warps per
# (context split, kv head, row); each warp walks its own STRIP-token strips
# through its own cp.async ring; a multiprocessor holds as many blocks as its
# shared memory fits, at most BLOCKS_PER_SM by the pool's element bytes (the
# kernel's Ring<E, D>::BLOCKS: ring_bytes, blocks_per_sm)
STRIP = 16
WARPS = 4
BLOCKS_PER_SM = {2: 2, 1: 4}
MIN_SPLIT_STRIPS = 4 * WARPS  # strips a split at least: four a warp
SM_SMEM = 233472  # shared memory of an H100 multiprocessor (228 KB)
BLOCK_RESERVED = 1024  # what the runtime keeps of it a block


def _pitch(nbytes: int) -> int:
    """Bytes a ring row of ``nbytes`` takes: whole 128-byte lines."""
    return -(-nbytes // 128) * 128


def ring_bytes(elem_bytes: int, d: int, scaled: bool = False) -> int:
    """Dynamic shared memory of a block (``Ring<E, D>::SMEM``): each warp's
    ring of K and V strips (3 stages for bf16, 2 for a 1-byte pool), a
    1-byte pool's V strip upcast to bf16, int8's (``scaled``) scale words,
    and 128 bytes of alignment slack."""
    stages = 3 if elem_bytes == 2 else 2
    warp = stages * 2 * STRIP * _pitch(d * elem_bytes)
    if elem_bytes == 1:
        warp += STRIP * _pitch(2 * d)
    if scaled:
        warp += stages * 32 * 8
    return WARPS * warp + 128


def blocks_per_sm(elem_bytes: int, d: int = HEAD_DIM, scaled: bool = False,
                  tiles: int = 1) -> int:
    """Blocks a multiprocessor holds (``Ring<E, D>::BLOCKS``, ``blocks_of``):
    as many as its shared memory fits, at most ``BLOCKS_PER_SM`` (D 256: 1
    for bf16, 2 for a 1-byte pool); with two head tiles at most 2, which
    leave a thread the registers of two tiles' Q^T and O^T."""
    cap = BLOCKS_PER_SM[elem_bytes] if tiles == 1 else min(BLOCKS_PER_SM[elem_bytes], 2)
    return min(cap, SM_SMEM // (ring_bytes(elem_bytes, d, scaled) + BLOCK_RESERVED))


def paged_decode_ref(q, k_cache, v_cache, block_tables, kv_lens, sm_scale,
                     block_size, sliding_window=0, cur_k=None, cur_v=None,
                     k_scale=None, v_scale=None, soft_cap=0.0, alibi_slopes=None):
    """Plain version: decode query at position kv_len - 1."""
    q_offsets = (kv_lens.long() - 1).clamp_min(0)
    return paged_attention_ref(
        q[:, None], k_cache, v_cache, block_tables, kv_lens, q_offsets,
        sm_scale, block_size, sliding_window=sliding_window,
        cur_k=cur_k, cur_v=cur_v, k_scale=k_scale, v_scale=v_scale,
        soft_cap=soft_cap, alibi_slopes=alibi_slopes)[:, 0]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def num_splits(batch: int, hkv: int, max_blocks: int, block_size: int,
               sm_count: int, elem_bytes: int = 2, d: int = HEAD_DIM, group: int = 1) -> int:
    """Context splits per (row, kv head): as many as fill one round of the
    blocks all ``sm_count`` SMs hold (``blocks_per_sm`` of the pool's
    element bytes, head width and the group's head tiles) without starting
    a second (a block keeps enough bytes in flight that one round reads at
    speed, and a round begun by a few blocks is a tail), and no split of
    fewer than ``MIN_SPLIT_STRIPS`` strips of the table's width. Depends only on
    shapes (no host sync on kv_lens): the engine buckets the block-table
    width to the batch's deepest row."""
    max_strips = -(-max_blocks * block_size // STRIP)
    blocks = batch * hkv * len(head_chunks(group))  # a split's blocks: one a head chunk
    fit = blocks_per_sm(elem_bytes, d, tiles=head_tiles(group)) * sm_count // max(blocks, 1)
    return max(1, min(fit, max_strips // MIN_SPLIT_STRIPS))


def split_strips(kv_len: int, window: int, has_cur: bool, splits: int,
                 split: int, warp: int) -> list[int]:
    """The strips (of ``STRIP`` tokens) that warp ``warp`` of split ``split``
    computes for a row, in order: the kernel's arithmetic, for the tests."""
    cached = max(kv_len - 1, 0) if has_cur else kv_len
    lo = max(kv_len - window, 0) if window > 0 else 0
    s_lo = lo // STRIP
    s_hi = -(-cached // STRIP) if cached > lo else s_lo
    per = -(-(s_hi - s_lo) // splits)
    j0 = min(s_lo + split * per, s_hi)
    j1 = min(j0 + per, s_hi)
    return list(range(j0 + warp, j1, WARPS))


def check_pools(k_cache, v_cache, k_scale, v_scale, hd, hkv):
    """Raise on a pool the CUDA kernels do not take: bf16, int8 (with bf16
    ``[NS, Hkv]`` scales of one row stride) or fp8 e4m3 (no scales), rows of
    unit inner stride that start on 16-byte boundaries."""
    if k_cache.dtype not in KERNELS or v_cache.dtype != k_cache.dtype:
        raise NotImplementedError(
            f"the CUDA kernels take a bf16, int8 or float8_e4m3fn pool, got "
            f"{k_cache.dtype} / {v_cache.dtype}")
    for name, cache in (("k_cache", k_cache), ("v_cache", v_cache)):
        if cache.dim() != 2 or cache.shape[1] != hd or cache.stride(1) != 1:
            raise ValueError(f"{name}: expected a [NS, {hd}] pool with unit inner stride")
        if cache.stride(0) * cache.element_size() % 16 or cache.data_ptr() % 16:
            raise ValueError(f"{name}: pool rows must be 16-byte aligned")
    if (k_cache.dtype == torch.int8) != (k_scale is not None and v_scale is not None):
        raise ValueError("an int8 pool needs k_scale and v_scale; no other pool takes them")
    if k_scale is None:
        if v_scale is not None:
            raise ValueError("v_scale without k_scale")
        return
    for name, scale in (("k_scale", k_scale), ("v_scale", v_scale)):
        if scale.dtype != torch.bfloat16:
            raise NotImplementedError(f"{name}: scales are bf16, got {scale.dtype}")
        if (scale.dim() != 2 or scale.shape != (k_cache.shape[0], hkv)
                or scale.stride(1) != 1 or scale.stride(0) != k_scale.stride(0)):
            raise ValueError(f"{name}: expected a [{k_cache.shape[0]}, {hkv}] view "
                             "with unit inner stride, one row stride for both")


def check_alibi(alibi_slopes, hq, soft_cap, device):
    """Raise on ALiBi slopes the CUDA kernels do not take: f32 ``[Hq]``,
    contiguous, on the queries' card, and no soft-cap beside them."""
    if alibi_slopes is None:
        return
    if soft_cap > 0:
        raise NotImplementedError("the attention kernels take ALiBi or a soft-cap, not both")
    if (alibi_slopes.dtype != torch.float32 or tuple(alibi_slopes.shape) != (hq,)
            or not alibi_slopes.is_contiguous() or alibi_slopes.device != device):
        raise ValueError(f"alibi_slopes: expected a contiguous f32 [{hq}] tensor on {device}, "
                         f"got {alibi_slopes.dtype} {tuple(alibi_slopes.shape)} on "
                         f"{alibi_slopes.device}")


def paged_decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,  # [NS, Hkv*D] (a strided view is fine)
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int
    kv_lens: torch.Tensor,  # [B] int — includes the current token
    sm_scale: float,
    block_size: int,
    sliding_window: int = 0,
    cur_k: Optional[torch.Tensor] = None,  # [B, Hkv*D]: deferred current token;
    cur_v: Optional[torch.Tensor] = None,  # the cache then holds kv_len-1 tokens
    k_scale: Optional[torch.Tensor] = None,  # [NS, Hkv] bf16: int8 pool only
    v_scale: Optional[torch.Tensor] = None,
    soft_cap: float = 0.0,  # > 0: scores cap * tanh(s / cap)
    alibi_slopes: Optional[torch.Tensor] = None,  # [Hq] f32: ALiBi
) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_cache, v_cache, block_tables, kv_lens,
                                sm_scale, block_size, sliding_window, cur_k, cur_v,
                                k_scale, v_scale, soft_cap, alibi_slopes)
    b, hq, d = q.shape
    hd = k_cache.shape[-1]
    hkv = hd // d
    check_head(d, hq, hkv, "paged_decode")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"paged_decode kernel takes bf16 queries, got {q.dtype}")
    check_pools(k_cache, v_cache, k_scale, v_scale, hd, hkv)
    check_alibi(alibi_slopes, hq, soft_cap, q.device)
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    cur_stride = 0
    if cur_k is not None:
        if cur_k.dtype != torch.bfloat16 or cur_v.dtype != torch.bfloat16:
            raise NotImplementedError("cur_k/cur_v must be bf16")
        cur_k = cur_k.reshape(b, hd).contiguous()
        cur_v = cur_v.reshape(b, hd).contiguous()
        cur_stride = hd
    mb = bt.shape[1]
    splits = num_splits(b, hkv, mb, block_size, _sm_count(q.device), k_cache.element_size(), d,
                        hq // hkv)
    out = torch.empty_like(q)
    ws_o = ws_ml = None
    if splits > 1:
        ws_o = torch.empty((b, hq, splits, d), dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32, device=q.device)
    kernel_for(k_cache.dtype, d).launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), v_cache.stride(0),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        k_scale.stride(0) if k_scale is not None else 0,
        bt.data_ptr(), mb, lens.data_ptr(),
        cur_k.data_ptr() if cur_k is not None else None,
        cur_v.data_ptr() if cur_v is not None else None, cur_stride,
        out.data_ptr(),
        ws_o.data_ptr() if ws_o is not None else None,
        ws_ml.data_ptr() if ws_ml is not None else None,
        b, hq, hkv, block_size, int(sliding_window), float(sm_scale), float(soft_cap),
        alibi_slopes.data_ptr() if alibi_slopes is not None else None, splits,
        _kernels.stream_ptr(q.device),
    )
    count_group(hq // hkv, k_cache.dtype, WIDE_GROUP, GROUP_WIDE)
    if alibi_slopes is not None:
        ALIBI[(k_cache.dtype, d)].n += 1
    return out


def count_group(g: int, dtype: torch.dtype, two_tiles: dict, chunked: dict) -> None:
    """Count a launch of the two-tile mode (G 9-16) or the head-chunk mode
    (G > 16) under its pool type."""
    if g > CHUNK:
        chunked[dtype].n += 1
    elif g > N8:
        two_tiles[dtype].n += 1
