"""The engine <-> model batch contract (port of ``rtp_llm_tpu/models/batch.py``).

One layout serves both phases: decode is T=1 with up to max_batch rows;
prefill is T=bucket with one or more rows. Inactive (padding) rows carry
``kv_len == 0`` so their tokens mask out of attention and their KV writes
are dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ModelInputs(NamedTuple):
    """Batched model inputs (all on the model's device).

    tokens:       [B, T] int — input token ids (padded with 0)
    positions:    [B, T] int — absolute positions (q_offset + t for valid tokens)
    block_tables: [B, MAX_BLOCKS] int — KV block ids per row (0 = null block)
    kv_lens:      [B] int — total valid KV length per row *after* this call
                  (0 => inactive row)
    q_offsets:    [B] int — absolute position of the row's first query token
                  (= reused-prefix length for prefill; kv_len-1 for decode)
    """

    tokens: torch.Tensor
    positions: torch.Tensor
    block_tables: torch.Tensor
    kv_lens: torch.Tensor
    q_offsets: torch.Tensor


class ModelOutputs(NamedTuple):
    """logits: [B, V] f32 at each row's last valid token.

    kv_writes: with deferred decode writes, every layer's current-token K and
    V rows ``([L, B, Hkv*D], [L, B, Hkv*D])``, unquantized, for the engine's
    one batched scatter; else None."""

    logits: torch.Tensor
    kv_writes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
