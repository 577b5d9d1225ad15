"""Paged causal prefill attention: wrapper of ``csrc/paged_prefill.cu``.

Replaces ``rtp_llm_tpu/ops/attention/pallas_prefill.py::paged_prefill_attention``
and takes B rows at once with per-row ``q_offsets`` / ``kv_lens`` (the JAX
kernel's single-row contract is B = 1). A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version, ``paged_prefill_ref``.

The JAX package sends prefill over a quantized pool through its plain path;
here the kernel reads an int8 pool (with ``[NS, Hkv]`` bf16 scales) or an
fp8 e4m3 pool itself, one C entry per pool element type (``KERNELS``).
"""

from __future__ import annotations

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import F32, I32, I64, P
from rtp_llm_tpu_torch.ops.attention.decode import HEAD_DIM, MAX_GROUP, check_pools
from rtp_llm_tpu_torch.ops.attention.ref import paged_attention_ref
from rtp_llm_tpu_torch.ops.kv_cache import FP8

_ARGTYPES = [P, P, P, I64, I64, P, P, I64, P, I32, P, P, P,
             I32, I32, I32, I32, I32, I32, F32, P]
# pool element type -> its C entry (launches counted per entry)
KERNELS = {
    dtype: _kernels.Kernel(name, "paged_prefill.cu", entry, _ARGTYPES)
    for dtype, name, entry in (
        (torch.bfloat16, "paged_prefill", "paged_prefill_bf16"),
        (torch.int8, "paged_prefill_i8", "paged_prefill_i8"),
        (FP8, "paged_prefill_e4m3", "paged_prefill_e4m3"))
}
KERNEL = KERNELS[torch.bfloat16]


def paged_prefill_ref(q, k_cache, v_cache, block_tables, q_offsets, kv_lens,
                      sm_scale, block_size, sliding_window=0, k_scale=None,
                      v_scale=None):
    """Plain version: the reference attention with padded bucket-tail rows
    (query position >= kv_len) set to zero, as the kernel outputs them."""
    out = paged_attention_ref(q, k_cache, v_cache, block_tables, kv_lens,
                              q_offsets, sm_scale, block_size,
                              sliding_window=sliding_window,
                              k_scale=k_scale, v_scale=v_scale)
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
) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_prefill_ref(q, k_cache, v_cache, block_tables, q_offsets,
                                 kv_lens, sm_scale, block_size, sliding_window,
                                 k_scale, v_scale)
    b, t, hq, d = q.shape
    hd = k_cache.shape[-1]
    hkv = hd // d
    if d != HEAD_DIM or hq % hkv or hq // hkv > MAX_GROUP:
        raise NotImplementedError(
            f"paged_prefill kernel takes head_dim {HEAD_DIM} and Hq/Hkv <= "
            f"{MAX_GROUP}; got D={d}, Hq={hq}, Hkv={hkv}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"paged_prefill kernel takes bf16 queries, got {q.dtype}")
    check_pools(k_cache, v_cache, k_scale, v_scale, hd, hkv)
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    offs = q_offsets.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    KERNELS[k_cache.dtype].launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), v_cache.stride(0),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        k_scale.stride(0) if k_scale is not None else 0,
        bt.data_ptr(), bt.shape[1],
        offs.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, t, hq, hkv, block_size, int(sliding_window), float(sm_scale),
        _kernels.stream_ptr(q.device),
    )
    return out
