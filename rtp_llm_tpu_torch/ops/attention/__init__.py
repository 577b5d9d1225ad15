"""Paged attention dispatch (port of ``rtp_llm_tpu/ops/attention/__init__.py``).

* a CPU tensor (or ``backend="plain"``) takes the plain version;
* a CUDA tensor with T == 1 takes the decode kernel (the query is the token
  at position kv_len - 1), T > 1 the prefill kernel;
* on a CUDA tensor, what the kernels do not take raises: it never falls back
  to the plain version;
* ``soft_cap`` > 0 (gemma2) caps the scores in whichever path runs: a
  runtime mode of both kernels (the JAX dispatch sends it to its plain path);
* ``k_scale`` / ``v_scale`` (``[slots, Hkv]`` bf16, the int8 pool's scales)
  pass through to either: the kernels read them through the block table, so
  the JAX dispatch's gathered scale operand (``_expand_kv_scales``) and its
  gate on the bucketed context have no counterpart: one kernel serves any
  context.

The JAX package's mesh / shard_map wrapper and its full-cache + layer-index
operands do not come over: ``cache[l, 0]`` is a free strided view here.
"""

from __future__ import annotations

from typing import Optional

import torch

from rtp_llm_tpu_torch.ops.attention.decode import paged_decode_attention
from rtp_llm_tpu_torch.ops.attention.prefill import paged_prefill_attention
from rtp_llm_tpu_torch.ops.attention.ref import PLAIN_CALLS, paged_attention_ref


def paged_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k_cache: torch.Tensor,  # [slots, Hkv*D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB]
    kv_lens: torch.Tensor,  # [B]
    q_offsets: torch.Tensor,  # [B]
    sm_scale: float,
    block_size: int,
    sliding_window: int = 0,
    soft_cap: float = 0.0,
    backend: str = "auto",  # auto | plain
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    cur_k: Optional[torch.Tensor] = None,  # [B, Hkv*D] deferred current-token K/V
    cur_v: Optional[torch.Tensor] = None,  # (decode T=1: cache holds kv_len-1)
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if alibi_slopes is not None:
        raise NotImplementedError(
            "ALiBi is not ported: neither the plain version nor the CUDA kernels take it")
    if soft_cap < 0:
        raise ValueError(f"soft_cap must be >= 0 (0: no cap), got {soft_cap}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if backend == "plain" or q.device.type == "cpu":
        return paged_attention_ref(
            q, k_cache, v_cache, block_tables, kv_lens, q_offsets, sm_scale,
            block_size, sliding_window=sliding_window, cur_k=cur_k, cur_v=cur_v,
            k_scale=k_scale, v_scale=v_scale, soft_cap=soft_cap)
    if backend != "auto":
        raise ValueError(f"unknown attention backend {backend!r}")
    if q.shape[1] == 1:
        return paged_decode_attention(
            q[:, 0], k_cache, v_cache, block_tables, kv_lens, sm_scale,
            block_size, sliding_window=sliding_window, cur_k=cur_k,
            cur_v=cur_v, k_scale=k_scale, v_scale=v_scale, soft_cap=soft_cap)[:, None]
    if cur_k is not None:
        raise NotImplementedError("deferred current-token K/V is a decode (T=1) mode")
    return paged_prefill_attention(
        q, k_cache, v_cache, block_tables, q_offsets, kv_lens, sm_scale,
        block_size, sliding_window=sliding_window, k_scale=k_scale,
        v_scale=v_scale, soft_cap=soft_cap)


__all__ = ["paged_attention", "paged_attention_ref", "paged_decode_attention",
           "paged_prefill_attention", "PLAIN_CALLS"]
