"""On-device batched sampling (port of ``rtp_llm_tpu/ops/sampling.py``).

Penalties and top-k/top-p filtering run on the whole decode batch on the
device; per-request token statistics (``prompt_mask``, ``output_counts``)
live on the device too, so sampling never round-trips to the host. Random
draws come from an explicit ``torch.Generator`` (the JAX package's PRNG keys
give other numbers: only greedy tokens are comparable across the two).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

NEG_INF = -1e30
# candidate cap for top-k/top-p filtering (exact for top_k <= cap; for top-p
# exact whenever the nucleus fits in the cap)
TOPK_CAP = 64


class SamplingParams(NamedTuple):
    """Per-slot sampling controls, shape [B] each."""

    temperature: torch.Tensor  # f32; applied after penalties
    top_k: torch.Tensor  # i32; 0 disables
    top_p: torch.Tensor  # f32; 1.0 disables
    do_sample: torch.Tensor  # bool; False => greedy
    repetition_penalty: torch.Tensor  # f32; 1.0 disables
    presence_penalty: torch.Tensor  # f32; 0.0 disables
    frequency_penalty: torch.Tensor  # f32; 0.0 disables
    ban_eos: torch.Tensor  # bool; True while min_new_tokens not reached / ignore_eos

    @staticmethod
    def zeros(batch: int, device) -> "SamplingParams":
        f32 = dict(dtype=torch.float32, device=device)
        return SamplingParams(
            temperature=torch.ones(batch, **f32),
            top_k=torch.zeros(batch, dtype=torch.int32, device=device),
            top_p=torch.ones(batch, **f32),
            do_sample=torch.zeros(batch, dtype=torch.bool, device=device),
            repetition_penalty=torch.ones(batch, **f32),
            presence_penalty=torch.zeros(batch, **f32),
            frequency_penalty=torch.zeros(batch, **f32),
            ban_eos=torch.zeros(batch, dtype=torch.bool, device=device),
        )


def apply_penalties(
    logits: torch.Tensor,  # [B, V] f32
    prompt_mask: torch.Tensor,  # [B, V] bool — token appeared in the prompt
    output_counts: torch.Tensor,  # [B, V] int — occurrences in generated output
    params: SamplingParams,
) -> torch.Tensor:
    seen_out = output_counts > 0
    seen = prompt_mask | seen_out
    rep = params.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, penalized, logits)
    logits = logits - params.presence_penalty[:, None] * seen_out
    logits = logits - params.frequency_penalty[:, None] * output_counts.float()
    return logits


def _topk_topp_mask(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Mask logits outside the per-row top-k / top-p nucleus with NEG_INF.

    Rows with top_k disabled (<=0 or > cap) keep their full distribution on
    the k side; rows with top_p >= 1 keep it on the p side."""
    v = logits.shape[-1]
    cap = min(TOPK_CAP, v)
    sorted_logits = torch.topk(logits, cap, dim=-1).values  # [B, cap] desc
    k_active = (params.top_k > 0) & (params.top_k <= cap)
    k = torch.where(k_active, params.top_k.clamp(1, cap),
                    torch.full_like(params.top_k, cap)).long()
    kth = torch.gather(sorted_logits, -1, (k - 1)[:, None])  # [B, 1]
    keep_k = (logits >= kth) | ~k_active[:, None]
    p_active = params.top_p < 1.0
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    probs_sorted = torch.exp(sorted_logits - lse)  # [B, cap]
    cum = torch.cumsum(probs_sorted, dim=-1)
    # keep sorted idx i if cum[i] - p_i < top_p (always keeps the first token)
    keep_sorted = (cum - probs_sorted) < params.top_p[:, None]
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.min(dim=-1, keepdim=True).values
    keep_p = (logits >= thresh) | ~p_active[:, None]
    return torch.where(keep_k & keep_p, logits, torch.full_like(logits, NEG_INF))


def eos_ban_row(eos_token_ids: Sequence[int], vocab: int, device) -> torch.Tensor:
    """``[V]`` bool, True at the EOS ids: what ``ban_eos`` rows mask."""
    row = torch.zeros(vocab, dtype=torch.bool, device=device)
    row[list(eos_token_ids)] = True
    return row


def _in_vocab(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """True at the ids that name a token: ``-1`` padding and any id outside
    ``[0, V)`` are dropped, as the reference's ``mode="drop"`` scatters
    drop them (an id past V must never reach a scatter on the card)."""
    return (ids >= 0) & (ids < vocab)


def _row_marks(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """``[B, V]`` bool, True at each row's ids ``[B, M]``; ``-1`` entries
    and ids outside the vocabulary mark nothing (they land in a spare
    column V that is cut off). A fixed shape and no host copy, so a graph
    can capture it."""
    safe = torch.where(_in_vocab(ids, vocab), ids, torch.full_like(ids, vocab)).long()
    marks = torch.zeros((ids.shape[0], vocab + 1), dtype=torch.bool, device=ids.device)
    return marks.scatter_(1, safe, True)[:, :vocab]


def sample_tokens(
    logits: torch.Tensor,  # [B, V] (pre-temperature)
    params: SamplingParams,
    prompt_mask: torch.Tensor,
    output_counts: torch.Tensor,
    eos_token_ids: Sequence[int],
    generator: Optional[torch.Generator],
    need_sampling: bool = True,
    active: Optional[torch.Tensor] = None,
    need_stats: bool = True,
    ban_row: Optional[torch.Tensor] = None,
    forced_tokens: Optional[torch.Tensor] = None,  # [B], -1 = not forced
    ban_tokens: Optional[torch.Tensor] = None,  # [B, M], -1 = empty (n-gram bans)
    bias_ids: Optional[torch.Tensor] = None,  # [B, M], -1 = empty (logit_bias)
    bias_vals: Optional[torch.Tensor] = None,  # [B, M] f32
    allow_tokens: Optional[torch.Tensor] = None,  # [B, M], -1-padded; all -1 = free
):
    """Returns (tokens [B] i64, logprobs [B] f32); updates ``output_counts``
    in place (rows in ``active`` only).

    In the reference's order: the logit bias is added, then the penalties,
    the EOS ban, the n-gram bans and the trie's allow-list (a row with any
    allowed id keeps only those) mask, greedy rows take the argmax and
    sampling rows draw from the temperature/top-k/top-p distribution with
    the Gumbel trick, and last a forced token replaces the draw (its logprob
    and count are the forced token's). ``need_sampling=False`` skips the
    sort; ``need_stats=False`` skips the penalties, the chosen-token logprob
    (zeros) and the count update. ``ban_row`` is ``eos_ban_row(eos_token_ids,
    ...)`` built once by the caller: building it here copies the ids from
    the host on every call, which a CUDA graph cannot capture. Every operand
    keeps its fixed shape: the bias is a scatter-add that adds 0 for a
    ``-1`` entry or an id outside the vocabulary."""
    logits = logits.float()
    if bias_ids is not None:
        keep = _in_vocab(bias_ids, logits.shape[1])
        logits = logits.scatter_add(
            1, torch.where(keep, bias_ids, torch.zeros_like(bias_ids)).long(),
            torch.where(keep, bias_vals.float(), torch.zeros_like(bias_vals, dtype=torch.float32)))
    if need_stats:
        logits = apply_penalties(logits, prompt_mask, output_counts, params)
    if ban_row is None and len(eos_token_ids) > 0:
        ban_row = eos_ban_row(eos_token_ids, logits.shape[1], logits.device)
    if ban_row is not None:
        logits = torch.where(params.ban_eos[:, None] & ban_row[None, :],
                             torch.full_like(logits, NEG_INF), logits)
    if ban_tokens is not None:
        logits = torch.where(_row_marks(ban_tokens, logits.shape[1]),
                             torch.full_like(logits, NEG_INF), logits)
    if allow_tokens is not None:
        constrained = (allow_tokens >= 0).any(dim=1)
        keep = _row_marks(allow_tokens, logits.shape[1])
        logits = torch.where(constrained[:, None] & ~keep,
                             torch.full_like(logits, NEG_INF), logits)

    greedy = torch.argmax(logits, dim=-1)
    if need_sampling:
        temp = params.temperature.clamp_min(1e-5)[:, None]
        filtered = _topk_topp_mask(logits / temp, params)
        u = torch.rand(filtered.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        sampled = torch.argmax(filtered + gumbel, dim=-1)
        tokens = torch.where(params.do_sample, sampled, greedy)
    else:
        tokens = greedy
    if forced_tokens is not None:
        tokens = torch.where(forced_tokens >= 0, forced_tokens.long(), tokens)

    if not need_stats:
        return tokens, torch.zeros(tokens.shape, dtype=torch.float32, device=tokens.device)
    lse = torch.logsumexp(logits, dim=-1)
    logprobs = torch.gather(logits, -1, tokens[:, None])[:, 0] - lse
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    inc = (torch.ones_like(tokens) if active is None else active.long())
    output_counts.index_put_((rows, tokens), inc.to(output_counts.dtype),
                             accumulate=True)
    return tokens, logprobs
