"""Beam search's host state (port of ``rtp_llm_tpu/engine/beam.py``).

A beam group runs as ``num_beams`` rows of one eager forward at T = 1 over
the paged KV pool, outside the decode slots; the engine
(``engine/engine.py``) owns the device side: the forward, the
``log_softmax`` read back to the host, and the block ownership of each
beam (full blocks shared by reference, the partial tail copied into a fresh
block when a parent has several children). Here, on the host, is the
selection: the top 2k candidates over ``[beams x vocab]``, EOS-terminated
hypotheses with length-penalised scores, the stopping rule and the best
hypothesis. The arithmetic and the tie order are the JAX module's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class BeamHypothesis:
    tokens: List[int]  # generated tokens (no prompt)
    cum_logprob: float
    blocks: List[int]  # owned block ids (ref'd)

    def score(self, length_penalty: float = 1.0) -> float:
        n = max(len(self.tokens), 1)
        return self.cum_logprob / (n ** length_penalty)


@dataclasses.dataclass
class Beam:
    tokens: List[int]
    cum_logprob: float
    blocks: List[int]


class BeamGroup:
    """Host state for one request's beam search."""

    def __init__(self, stream, num_beams: int, cache_mgr, block_size: int):
        self.stream = stream
        self.k = num_beams
        self.cache_mgr = cache_mgr
        self.block_size = block_size
        self.beams: List[Beam] = []
        self.finished: List[BeamHypothesis] = []
        self.done = False
        # effective new-token budget (engine clamps to max_seq_len headroom)
        self.max_new = stream.config.max_new_tokens

    @property
    def prompt_len(self) -> int:
        return self.stream.prompt_len

    def width_at(self, out_len: int) -> int:
        """Beam width once out_len output tokens exist (reference:
        GenerateStream::numBeams; variable_num_beams schedule)."""
        return max(1, min(self.stream.config.beam_width_at(out_len), self.k))

    def seq_len(self, beam: Beam) -> int:
        return self.prompt_len + len(beam.tokens)

    def init_from_prefill(self, alloc_blocks: List[int], first_logprobs: np.ndarray,
                          eos_ids, max_new: int):
        """Branch the prefilled sequence into k beams using the first-token
        distribution. Beam 0 owns the original blocks; others share them
        (full blocks by ref; tail block copied by the engine)."""
        top = np.argsort(-first_logprobs)[: self.width_at(1)]
        self.beams = []
        for rank, tok in enumerate(top):
            self.beams.append(Beam(
                tokens=[int(tok)],
                cum_logprob=float(first_logprobs[tok]),
                blocks=list(alloc_blocks),  # engine fixes ownership/copies
            ))

    def advance(self, logprobs: np.ndarray, eos_ids, max_new: int,
                length_penalty: float = 1.0):
        """One beam step. logprobs: [k, V] log-softmax rows aligned with
        self.beams. Returns list of (parent_idx, token) for the new beams;
        the engine then fixes KV block ownership for each child."""
        k, v = logprobs.shape
        assert k == len(self.beams)
        # next step's target width (variable_num_beams schedule)
        k_next = self.width_at(len(self.beams[0].tokens) + 1)
        scores = logprobs + np.array(
            [b.cum_logprob for b in self.beams]
        )[:, None]  # [k, V]
        flat = scores.reshape(-1)
        # 2k candidates so eos-terminated ones don't starve the beam
        npick = min(2 * max(k, k_next), flat.size - 1)
        top = np.argpartition(-flat, npick)[: npick]
        top = top[np.argsort(-flat[top])]

        new_children: List[tuple] = []
        for cand in top:
            parent, tok = divmod(int(cand), v)
            score = float(flat[cand])
            if tok in eos_ids:
                b = self.beams[parent]
                self.finished.append(BeamHypothesis(
                    tokens=b.tokens + [],  # eos not included in output
                    cum_logprob=score,
                    blocks=[],
                ))
                continue
            if len(new_children) < k_next:
                new_children.append((parent, tok, score))
        # termination: best possible remaining score can't beat worst finished
        if len(self.finished) >= self.k:
            best_alive = max(
                (s for (_p, _t, s) in new_children),
                default=-math.inf,
            )
            worst_kept = sorted(
                (h.score(length_penalty) for h in self.finished), reverse=True
            )[self.k - 1]
            # optimistic alive score with one more token
            n = len(self.beams[0].tokens) + 1
            if best_alive / (n ** length_penalty) <= worst_kept:
                self.done = True
        if self.beams and len(self.beams[0].tokens) >= max_new:
            self.done = True
        return new_children

    def best(self, length_penalty: float = 1.0) -> BeamHypothesis:
        pool = list(self.finished)
        for b in self.beams:
            pool.append(BeamHypothesis(
                tokens=list(b.tokens), cum_logprob=b.cum_logprob, blocks=[]
            ))
        return max(pool, key=lambda h: h.score(length_penalty))
