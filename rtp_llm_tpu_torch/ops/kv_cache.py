"""Paged KV cache ops: slot computation and row writes.

Port of ``rtp_llm_tpu/ops/kv_cache.py``. The pool layout is the same:
``[L, 2, num_blocks * block_size, Hkv * D]`` — per layer and plane (k, v) a
flat slot-major row table with all kv heads in one row. A token at absolute
position ``p`` of a request with block table ``bt`` lives at flat slot
``bt[p // block_size] * block_size + p % block_size``. Block 0 is the
reserved null block: padded block-table entries point there.

Invalid tokens (padding, inactive rows) get slot ``2**30``. The JAX package
relies on scatter ``mode="drop"`` to discard them; ``index_put_`` has no such
mode, so ``write_kv`` masks them explicitly: an invalid row is redirected to
slot 0 and writes back the value slot 0 already holds, which leaves the pool
bit-for-bit unchanged without a host synchronisation.
"""

from __future__ import annotations

import torch

INVALID_SLOT = 2**30


def token_slots(
    positions: torch.Tensor, block_table: torch.Tensor, block_size: int,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Flat cache slots for tokens at ``positions`` (int64). Invalid -> 2**30.

    positions: [...]; block_table: [..., max_blocks] aligned with positions'
    leading dims (or 1-D for a single sequence); valid: bool [...].
    """
    positions = positions.long()
    block_idx = torch.div(positions, block_size, rounding_mode="floor")
    offs = positions - block_idx * block_size
    bt = block_table.long()
    mb = bt.shape[-1]
    safe_idx = block_idx.clamp(0, mb - 1)  # invalid positions may overrun
    if bt.dim() == 1:
        blocks = bt[safe_idx]
    else:
        blocks = torch.gather(bt, -1, safe_idx)
    slots = blocks * block_size + offs
    return torch.where(valid, slots, torch.full_like(slots, INVALID_SLOT))


def write_kv(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    slots: torch.Tensor,
) -> None:
    """Write new KV rows into the paged cache in place.

    k_cache/v_cache: [num_slots, Hkv*D] (views into the [L, 2, NS, HD] pool
    work: writes land in the pool); k_new/v_new: [T, Hkv, D] or [T, Hkv*D];
    slots: [T] flat slots, out-of-range = dropped.
    """
    t = k_new.shape[0]
    ns = k_cache.shape[0]
    valid = (slots >= 0) & (slots < ns)
    safe = torch.where(valid, slots, torch.zeros_like(slots))
    keep = valid.unsqueeze(-1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        rows = new.reshape(t, -1).to(cache.dtype)
        # invalid rows rewrite slot 0 with its own current contents
        cache[safe] = torch.where(keep, rows, cache[safe])
