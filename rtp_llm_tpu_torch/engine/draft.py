"""Draft-model speculative proposer (the ``vanilla`` method).

Port of ``rtp_llm_tpu/engine/draft.py``. A small model of the target's
vocabulary (or a smaller one: its ids are target ids) proposes K greedy
tokens a stream; the target verifies them in its T = K+1 window.

* The draft keeps its own bf16 KV pool but shares the target engine's block
  tables and slot ids: block bookkeeping is done once, the draft's pool
  mirrors the block ids (a small model's pool is small).
* Its prefill runs every stream's full prompt (prefix reuse is ignored:
  reused blocks are written again with the same rows).
* The rollout is K+1 T = 1 forwards over the whole decode batch, from the
  decode state's pending tokens and lengths: the last step writes the K-th
  draft's KV row (its logits are discarded), so a fully accepted window
  leaves no hole. On the card the engine replays it as one captured graph
  (``decode_graphs.py``); rejected rows need no rollback, the next rollout
  writes them again.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from rtp_llm_tpu_torch.models.batch import ModelInputs


class DraftRunner:
    """Owns the draft model's weights (fused as served) and KV pool."""

    def __init__(self, model, weights: dict, num_blocks: int, block_size: int,
                 target_vocab: int):
        if model.cfg.vocab_size > target_vocab:
            raise ValueError(f"the draft's vocabulary ({model.cfg.vocab_size}) exceeds the "
                             f"target's ({target_vocab}): its ids would not be target ids")
        self.model = model
        fused = model.fuse_weights(weights)
        weights.clear()  # no unfused copy stays alive beside the fused one
        weights.update(fused)
        self.weights = weights
        # bf16 whatever the target's pool: the proposer's accuracy gates
        # acceptance, and its pool is small
        self.kv = model.init_cache(num_blocks, block_size, torch.bfloat16)
        self.vocab = model.cfg.vocab_size

    def prefill(self, prompt: List[int], block_row: torch.Tensor, chunk: int,
                make_inputs: Callable) -> None:
        """Write the stream's whole prompt into the draft's pool, in chunks
        of ``chunk`` tokens; ``make_inputs`` is the engine's packed-input
        builder. Ids past the draft's vocabulary read its last row."""
        for pos in range(0, len(prompt), chunk):
            toks = [min(int(t), self.vocab - 1) for t in prompt[pos: pos + chunk]]
            _, self.kv = self.model.forward(self.weights, self.kv,
                                            make_inputs([(toks, pos)], block_row[None]))

    def rollout(self, state, kv_blocks: int, k: int, drafts: torch.Tensor) -> None:
        """K+1 greedy T = 1 steps from each slot's pending token; the first
        K tokens land in ``drafts [B, K]``. Reads nothing back."""
        active = state.kv_lens > 0
        cur, pos = state.last_tokens, state.kv_lens.long()
        bt = state.block_tables[:, :kv_blocks]
        out = []
        for _ in range(k + 1):
            inputs = ModelInputs(cur.clamp(max=self.vocab - 1)[:, None],
                                 torch.where(active, pos, 0)[:, None], bt,
                                 torch.where(active, pos + 1, 0), pos)
            o, self.kv = self.model.forward(self.weights, self.kv, inputs)
            cur = torch.where(active, torch.argmax(o.logits, dim=-1), cur)
            out.append(cur)
            pos = pos + 1
        drafts.copy_(torch.stack(out[:k], dim=1))
