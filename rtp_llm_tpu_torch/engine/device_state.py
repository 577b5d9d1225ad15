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

MAX_LOGIT_BIAS = 32  # per-request cap on logit_bias entries


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
    forced_tokens: torch.Tensor  # [B] i64 — next-token override (-1 = none)
    bias_ids: torch.Tensor  # [B, MAX_LOGIT_BIAS] i64 (-1 = empty)
    bias_vals: torch.Tensor  # [B, MAX_LOGIT_BIAS] f32
    adapter_ids: torch.Tensor  # [B] i32 — each slot's LoRA adapter (0 = none)

    @staticmethod
    def init(batch: int, max_blocks: int, vocab: int, device) -> "DecodeState":
        return DecodeState(
            last_tokens=torch.zeros(batch, dtype=torch.int64, device=device),
            kv_lens=torch.zeros(batch, dtype=torch.int32, device=device),
            block_tables=torch.zeros((batch, max_blocks), dtype=torch.int32, device=device),
            prompt_mask=torch.zeros((batch, vocab), dtype=torch.bool, device=device),
            output_counts=torch.zeros((batch, vocab), dtype=torch.int32, device=device),
            params=SamplingParams.zeros(batch, device),
            forced_tokens=torch.full((batch,), -1, dtype=torch.int64, device=device),
            bias_ids=torch.full((batch, MAX_LOGIT_BIAS), -1, dtype=torch.int64, device=device),
            bias_vals=torch.zeros((batch, MAX_LOGIT_BIAS), dtype=torch.float32, device=device),
            adapter_ids=torch.zeros(batch, dtype=torch.int32, device=device),
        )

    def insert_slot(self, slot: int, token: int, kv_len: int,
                    block_row: torch.Tensor, prompt_mask_row: torch.Tensor,
                    params_row: dict, counts_row: torch.Tensor = None,
                    bias_row: tuple = None, adapter_id: int = 0):
        """Write one slot's state in place and clear its forcing. ``counts_row``
        restores the output counts of a recomputed (preempted) stream; by
        default the counts hold just the first generated token. ``bias_row``
        is the request's ``(ids, vals)`` ``[MAX_LOGIT_BIAS]`` on the device,
        None for no bias; ``adapter_id`` its LoRA adapter."""
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
        self.forced_tokens[slot] = -1
        self.adapter_ids[slot] = adapter_id
        if bias_row is None:
            self.bias_ids[slot] = -1
            self.bias_vals[slot] = 0.0
        else:
            self.bias_ids[slot] = bias_row[0]
            self.bias_vals[slot] = bias_row[1]

    def clear_forced(self):
        """One-shot forcing: the decode body clears every row after applying
        it, so a window dispatched before the host re-arms it cannot fire it
        again."""
        self.forced_tokens.fill_(-1)

    def clear_slot(self, slot: int):
        """Deactivate a slot (kv_len=0 masks it everywhere)."""
        self.kv_lens[slot] = 0
        self.adapter_ids[slot] = 0
