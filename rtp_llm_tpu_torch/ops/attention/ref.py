"""Plain paged attention in PyTorch.

Port of ``rtp_llm_tpu/ops/attention/ref.py`` and the plain version of both
attention kernels (``decode.py``, ``prefill.py``): the path every CPU call
takes, and what the kernels are held against on the GPU.

Semantics: query token t of row b has absolute position q_offsets[b] + t and
attends to cache positions p with p <= q_pos and p < kv_lens[b] (and, with a
sliding window, p > q_pos - window). Fully masked rows give zeros, not NaN.
With ``soft_cap`` > 0 (gemma2) every scaled score, the deferred current
token's too, becomes ``cap * tanh(s / cap)`` before the mask and softmax.
With ``alibi_slopes`` (f32 ``[Hq]``; bloom, baichuan-13B, mpt, falcon) the
scaled (and capped) score of query head h gains ``slopes[h] * (kv_pos -
q_pos)``, 0 on the diagonal and for the deferred current token, before the
mask (the JAX ``ref.py``'s order).

Quantized pools: an int8 pool comes with ``k_scale`` / ``v_scale``
``[num_slots, Hkv]`` and is dequantized per (slot, kv head); an fp8 (e4m3)
pool is upcast as it is. The deferred current token always arrives
unquantized.
"""

from __future__ import annotations

from typing import Optional

import torch

from rtp_llm_tpu_torch._kernels import Counter
from rtp_llm_tpu_torch.ops.kv_cache import storage_view

# calls of the plain version; a serving run on the GPU must make none
PLAIN_CALLS = Counter("paged_attention_ref")


def paged_attention_ref(
    q: torch.Tensor,  # [B, T, Hq, D]
    k_cache: torch.Tensor,  # [num_slots, Hkv*D] (num_slots = NB * block_size)
    v_cache: torch.Tensor,  # [num_slots, Hkv*D]
    block_tables: torch.Tensor,  # [B, max_blocks] int
    kv_lens: torch.Tensor,  # [B] int — total valid kv length per row
    q_offsets: torch.Tensor,  # [B] int — absolute position of first query token
    sm_scale: float,
    block_size: int,
    sliding_window: int = 0,
    cur_k: Optional[torch.Tensor] = None,  # [B, Hkv*D] current token K (deferred
    cur_v: Optional[torch.Tensor] = None,  #  writes: cache holds kv_len-1 tokens)
    k_scale: Optional[torch.Tensor] = None,  # [num_slots, Hkv] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
    soft_cap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,  # [Hq] f32
) -> torch.Tensor:
    PLAIN_CALLS.n += 1
    b, t, hq, d = q.shape
    hkv = k_cache.shape[1] // d
    g = hq // hkv
    dev = q.device
    s = block_tables.shape[1] * block_size
    kv_lens = kv_lens.long()
    q_offsets = q_offsets.long()

    idx = (block_tables.long()[:, :, None] * block_size
           + torch.arange(block_size, device=dev)[None, None, :]).reshape(b, s)
    gather = lambda c: storage_view(c)[idx].view(c.dtype).reshape(b, s, hkv, -1).float()
    kf, vf = gather(k_cache), gather(v_cache)
    if k_scale is not None:  # int8 pool: per-(slot, head) dequant
        kf = kf * gather(k_scale)
    if v_scale is not None:
        vf = vf * gather(v_scale)
    qf = q.reshape(b, t, hkv, g, d).float()
    cap = (lambda x: soft_cap * torch.tanh(x / soft_cap)) if soft_cap > 0 else (lambda x: x)
    scores = cap(torch.einsum("bthgd,bshd->bhgts", qf, kf) * sm_scale)

    kv_pos = torch.arange(s, device=dev)[None, :].expand(b, s)
    if cur_k is not None:
        # deferred-write decode (T=1): append the current token at kv_len-1
        cached_lens = (kv_lens - 1).clamp_min(0)
        ckf = cur_k.reshape(b, 1, hkv, d).float()
        cvf = cur_v.reshape(b, 1, hkv, d).float()
        vf = torch.cat([vf, cvf], dim=1)
        scores_cur = cap(torch.einsum("bthgd,bshd->bhgts", qf, ckf) * sm_scale)
        scores = torch.cat([scores, scores_cur], dim=-1)
        kv_pos = torch.cat([kv_pos, cached_lens[:, None]], dim=1)
        valid_cached = torch.cat(
            [torch.arange(s, device=dev)[None, :] < cached_lens[:, None],
             (kv_lens > 0)[:, None]], dim=1)
    kv_pos = kv_pos[:, None, :]  # [B,1,S]
    q_pos = q_offsets[:, None, None] + torch.arange(t, device=dev)[None, :, None]
    if alibi_slopes is not None:  # score += slope[h] * (kv_pos - q_pos)
        rel = (kv_pos - q_pos).float()  # [B,T,S]
        slopes = alibi_slopes.float().reshape(hkv, g)
        scores = scores + slopes[None, :, :, None, None] * rel[:, None, None, :, :]
    mask = (kv_pos <= q_pos) & (kv_pos < kv_lens[:, None, None])  # [B,T,S]
    if cur_k is not None:
        mask = mask & valid_cached[:, None, :]
    if sliding_window > 0:
        mask = mask & (kv_pos > q_pos - sliding_window)
    mask5 = mask[:, None, None, :, :]
    scores = torch.where(mask5, scores, torch.full_like(scores, float("-inf")))

    # safe softmax: fully-masked rows (inactive slots) produce zeros, not NaN
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    e = torch.where(mask5, e, torch.zeros_like(e))
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom.clamp_min(1e-20)
    out = torch.einsum("bhgts,bshd->bthgd", p, vf)
    return out.reshape(b, t, hq, d).to(q.dtype)
