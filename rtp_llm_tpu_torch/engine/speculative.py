"""Speculative decoding: the prompt-lookup proposer and greedy acceptance.

Port of ``rtp_llm_tpu/engine/speculative.py``. K draft tokens a stream are
verified in one T = K+1 forward of the target (``LlmEngine._verify_window``);
the accepted prefix and the target's own next token advance the stream by up
to K+1 tokens a step. Rejected drafts' KV rows need no rollback: their slots
lie past the accepted length and the next step writes them again. Greedy
acceptance only: a stream that samples takes the normal decode window.
"""

from __future__ import annotations

from typing import List

import torch


def propose_prompt_lookup(token_ids: List[int], k: int, ngram_min: int = 2,
                          ngram_max: int = 4) -> List[int]:
    """The k tokens that followed the most recent earlier occurrence of the
    trailing n-gram (longest n first), padded with the last token when no
    continuation is found (a padding draft is simply rejected). Host Python,
    as in the JAX package."""
    n_tokens = len(token_ids)
    out: List[int] = []
    for n in range(min(ngram_max, n_tokens - 1), ngram_min - 1, -1):
        tail = token_ids[-n:]
        # right to left, the tail's own occurrence left out
        for start in range(n_tokens - n - 1, -1, -1):
            if token_ids[start: start + n] == tail:
                cont = token_ids[start + n: start + n + k]
                if cont:
                    out = list(cont)
                break
        if out:
            break
    pad = token_ids[-1] if token_ids else 0
    while len(out) < k:
        out.append(pad)
    return out[:k]


def greedy_verify(all_logits: torch.Tensor, drafts: torch.Tensor):
    """``all_logits [B, T, V]`` (T = K+1, bans applied), ``drafts [B, K]``
    -> (greedy tokens ``[B, T]`` int64, tokens emitted a row ``[B]``: the
    draft prefix that equals the greedy tokens, plus the target's own next
    token)."""
    g = torch.argmax(all_logits, dim=-1)  # [B, T]
    match = (drafts.to(g.dtype) == g[:, :-1]).to(torch.int64)  # [B, K]
    accepted = torch.cumprod(match, dim=-1).sum(dim=-1)  # [B] in 0..K
    return g, accepted + 1
