"""Paged decode attention (T = 1): wrapper of ``csrc/paged_decode.cu``.

Replaces ``rtp_llm_tpu/ops/attention/pallas_decode.py::paged_decode_attention``
(its ``_fullrow_kernel`` and ``_decode_kernel`` contracts). A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version,
``paged_decode_ref``. The kernel reads the pool through a row stride, so a
``cache[l, 0]`` view of the ``[L, 2, NS, Hkv*D]`` pool needs no copy.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import F32, I32, I64, P
from rtp_llm_tpu_torch.ops.attention.ref import paged_attention_ref

KERNEL = _kernels.Kernel(
    "paged_decode", "paged_decode.cu", "paged_decode_bf16",
    [P, P, P, I64, I64, P, I32, P, P, P, I64, P, P, P,
     I32, I32, I32, I32, I32, F32, I32, P],
)
HEAD_DIM = 128
MAX_GROUP = 8
TILE = 64  # context tokens per kernel tile (csrc/paged_decode.cu)


def paged_decode_ref(q, k_cache, v_cache, block_tables, kv_lens, sm_scale,
                     block_size, sliding_window=0, cur_k=None, cur_v=None):
    """Plain version: decode query at position kv_len - 1."""
    q_offsets = (kv_lens.long() - 1).clamp_min(0)
    return paged_attention_ref(
        q[:, None], k_cache, v_cache, block_tables, kv_lens, q_offsets,
        sm_scale, block_size, sliding_window=sliding_window,
        cur_k=cur_k, cur_v=cur_v)[:, 0]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def num_splits(batch: int, hkv: int, max_blocks: int, block_size: int,
               sm_count: int) -> int:
    """Context splits per (row, kv head): enough blocks for ~2 waves over the
    ``sm_count`` SMs, never more splits than tiles. Depends only on shapes
    (no host sync on kv_lens): the engine buckets the block-table width to
    the batch's deepest row."""
    max_tiles = max(1, -(-max_blocks * block_size // TILE))
    want = -(-2 * sm_count // max(batch * hkv, 1))
    return max(1, min(want, max_tiles))


def _check_pool(name, cache, hd):
    if cache.dtype != torch.bfloat16:
        raise NotImplementedError(f"{name}: the CUDA kernel takes a bf16 pool, got {cache.dtype}")
    if cache.dim() != 2 or cache.shape[1] != hd or cache.stride(1) != 1:
        raise ValueError(f"{name}: expected a [NS, {hd}] pool with unit inner stride")
    if cache.stride(0) % 8 or cache.data_ptr() % 16:
        raise ValueError(f"{name}: pool rows must be 16-byte aligned")


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
) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_cache, v_cache, block_tables, kv_lens,
                                sm_scale, block_size, sliding_window, cur_k, cur_v)
    b, hq, d = q.shape
    hd = k_cache.shape[-1]
    hkv = hd // d
    if d != HEAD_DIM or hq % hkv or hq // hkv > MAX_GROUP:
        raise NotImplementedError(
            f"paged_decode kernel takes head_dim {HEAD_DIM} and Hq/Hkv <= "
            f"{MAX_GROUP}; got D={d}, Hq={hq}, Hkv={hkv}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"paged_decode kernel takes bf16 queries, got {q.dtype}")
    _check_pool("k_cache", k_cache, hd)
    _check_pool("v_cache", v_cache, hd)
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
    splits = num_splits(b, hkv, mb, block_size, _sm_count(q.device))
    out = torch.empty_like(q)
    ws_o = ws_ml = None
    if splits > 1:
        ws_o = torch.empty((b, hq, splits, d), dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32, device=q.device)
    KERNEL.launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), v_cache.stride(0), bt.data_ptr(), mb, lens.data_ptr(),
        cur_k.data_ptr() if cur_k is not None else None,
        cur_v.data_ptr() if cur_v is not None else None, cur_stride,
        out.data_ptr(),
        ws_o.data_ptr() if ws_o is not None else None,
        ws_ml.data_ptr() if ws_ml is not None else None,
        b, hq, hkv, block_size, int(sliding_window), float(sm_scale), splits,
        _kernels.stream_ptr(q.device),
    )
    return out
