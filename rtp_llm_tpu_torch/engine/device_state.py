"""On-device decode batch state (port of ``rtp_llm_tpu/engine/device_state.py``).

The decode batch lives on the device — last sampled token, kv lengths, block
tables, penalty statistics, per-slot sampling params — and the fused
decode+sample step updates it in place. The host only touches single slots
on stream insert / removal and reads back the sampled tokens.
"""

from __future__ import annotations

import dataclasses

import torch

from rtp_llm_tpu_torch.config.generate_config import GenerateConfig
from rtp_llm_tpu_torch.ops.sampling import SamplingParams


def params_row_from_config(cfg: GenerateConfig, ban_eos: bool) -> dict:
    """Scalar per-slot sampling params for one request."""
    return dict(
        temperature=float(cfg.temperature), top_k=int(cfg.top_k),
        top_p=float(cfg.top_p), do_sample=bool(cfg.do_sample),
        repetition_penalty=float(cfg.repetition_penalty),
        presence_penalty=float(cfg.presence_penalty),
        frequency_penalty=float(cfg.frequency_penalty), ban_eos=bool(ban_eos),
    )


@dataclasses.dataclass
class DecodeState:
    last_tokens: torch.Tensor  # [B] i64 — token to feed this step
    kv_lens: torch.Tensor  # [B] i32 — tokens already in cache (0 = inactive)
    block_tables: torch.Tensor  # [B, MB] i32
    prompt_mask: torch.Tensor  # [B, V] bool
    output_counts: torch.Tensor  # [B, V] i32
    params: SamplingParams  # [B] each

    @staticmethod
    def init(batch: int, max_blocks: int, vocab: int, device) -> "DecodeState":
        return DecodeState(
            last_tokens=torch.zeros(batch, dtype=torch.int64, device=device),
            kv_lens=torch.zeros(batch, dtype=torch.int32, device=device),
            block_tables=torch.zeros((batch, max_blocks), dtype=torch.int32, device=device),
            prompt_mask=torch.zeros((batch, vocab), dtype=torch.bool, device=device),
            output_counts=torch.zeros((batch, vocab), dtype=torch.int32, device=device),
            params=SamplingParams.zeros(batch, device),
        )

    def insert_slot(self, slot: int, token: int, kv_len: int,
                    block_row: torch.Tensor, prompt_mask_row: torch.Tensor,
                    params_row: dict, counts_row: torch.Tensor = None):
        """Write one slot's state in place. ``counts_row`` restores the output
        counts of a recomputed (preempted) stream; by default the counts hold
        just the first generated token."""
        self.last_tokens[slot] = token
        self.kv_lens[slot] = kv_len
        self.block_tables[slot] = block_row
        self.prompt_mask[slot] = prompt_mask_row
        if counts_row is None:
            self.output_counts[slot].zero_()
            self.output_counts[slot, token] = 1
        else:
            self.output_counts[slot] = counts_row
        for name, value in params_row.items():
            getattr(self.params, name)[slot] = value

    def clear_slot(self, slot: int):
        """Deactivate a slot (kv_len=0 masks it everywhere)."""
        self.kv_lens[slot] = 0
