"""The engine <-> model batch contract (port of ``rtp_llm_tpu/models/batch.py``).

Two layouts. Padded ``[B, T]``: decode (T=1 over the fixed decode batch)
and any caller that pads; inactive (padding) rows carry ``kv_len == 0`` so
their tokens mask out of attention and their KV writes are dropped. Packed
(``row_lens`` set, the engine's prefill): only real tokens, row after row,
so no pad row reaches a linear; only the attention kernel's operands are
padded, to the longest row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

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
    row_lens:     packed form: each row's real token count on the host
                  (``kv_lens[r] - q_offsets[r]``); ``tokens`` and ``positions``
                  are then ``[sum(row_lens)]``, row r's tokens after row r-1's.
                  On the host because the shapes follow from them: read from
                  the device they would wait for the work in flight.
    adapter_ids:  [B] int — each row's LoRA adapter id (0 = none), or None;
                  the model gives every token row its row's id.
    state_slots:  [B] int — each row's decode slot, whose per-slot state it
                  reads and writes (a split pool's sliding-window ring), or
                  None: row r is slot r (the decode batch).
    rope_lens:    [B] int — each row's length that picks its RoPE table where
                  the model keeps two (longrope: the long one past
                  ``original_max_position_embeddings``), or None: ``kv_lens``
                  (the row's last position in this forward + 1). A prefill in
                  chunks passes the whole context's length, so that every
                  chunk rotates as one forward of the whole context would.
    """

    tokens: torch.Tensor
    positions: torch.Tensor
    block_tables: torch.Tensor
    kv_lens: torch.Tensor
    q_offsets: torch.Tensor
    row_lens: Optional[Tuple[int, ...]] = None
    adapter_ids: Optional[torch.Tensor] = None
    state_slots: Optional[torch.Tensor] = None
    rope_lens: Optional[torch.Tensor] = None


class ModelOutputs(NamedTuple):
    """logits: [B, V] f32 at each row's last valid token.

    kv_writes: with deferred decode writes, every layer's current-token K and
    V rows ``([L, B, Hkv*D], [L, B, Hkv*D])``, unquantized, for the engine's
    one batched scatter; else None.

    all_logits / all_hidden: when asked for, the f32 logits ``[N, V]`` and
    the final-normed hidden states ``[N, H]`` of every token row (N = B * T
    padded, the real tokens packed); else None."""

    logits: torch.Tensor
    kv_writes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    all_logits: Optional[torch.Tensor] = None
    all_hidden: Optional[torch.Tensor] = None


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``. For the card it is staged in pinned
    memory and copied without blocking: a copy from pageable memory waits
    for all the work queued before it (a decode window in flight)."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def packed_index(row_lens: Sequence[int], device: torch.device):
    """(pad ``[N]``: each packed token's index in the padded ``[B * T_max]``
    layout, last ``[B]``: each row's last token in the packed layout), int64
    on ``device``, built on the host from ``row_lens``."""
    t = max(row_lens)
    pad = torch.cat([torch.arange(n) + r * t for r, n in enumerate(row_lens)])
    last = torch.tensor(row_lens).cumsum(0) - 1
    both = upload(torch.cat([pad, last]), device)
    return both[: pad.numel()], both[pad.numel():]
