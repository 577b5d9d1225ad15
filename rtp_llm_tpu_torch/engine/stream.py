"""Per-request stream state machine (port of ``rtp_llm_tpu/engine/stream.py``).

Token accumulation, stop criteria, think-budget and trie state, an
incremental output queue for streaming consumers and the block allocation
handle.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import time
from typing import List, Optional

from rtp_llm_tpu_torch.cache.kv_cache_manager import BlockAllocation
from rtp_llm_tpu_torch.config.generate_config import GenerateConfig


class StreamState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    STOPPED = "stopped"  # error / cancel


class FinishReason(str, enum.Enum):
    STOP = "stop"  # eos or stop word / stop token
    LENGTH = "length"  # max_new_tokens or max_seq_len
    CANCELLED = "cancelled"
    ERROR = "error"


@dataclasses.dataclass
class StreamOutput:
    """One incremental output chunk pushed to the consumer."""

    new_tokens: List[int]
    finished: bool
    finish_reason: Optional[FinishReason] = None
    logprobs: Optional[List[float]] = None
    error: Optional[str] = None


class GenerateStream:
    def __init__(
        self,
        prompt_token_ids: List[int],
        config: Optional[GenerateConfig] = None,
        stop_token_sequences: Optional[List[List[int]]] = None,
    ):
        self.prompt_token_ids = list(prompt_token_ids)
        self.output_token_ids: List[int] = []
        self.output_logprobs: List[float] = []
        self.config = config or GenerateConfig()
        self.state = StreamState.WAITING
        self.finish_reason: Optional[FinishReason] = None
        self.error: Optional[str] = None
        # token-id sequences that terminate generation (tokenized stop words)
        self.stop_token_sequences = [list(s) for s in (stop_token_sequences or []) if s]

        # engine-owned runtime fields
        self.alloc: Optional[BlockAllocation] = None
        self.slot: int = -1  # decode batch slot, -1 = none
        self.reuse_len: int = 0
        # think-mode budget tracking
        self.thinking = False
        self.think_tokens = 0
        # trie-constrained decode walk (engine/logits_processors.py); set by
        # the engine at enqueue when it has a TreeDecodeConfig
        self.tree_state = None
        # LoRA: the adapter's id and the prefix cache's key for it, set by
        # the engine at enqueue (0 = the base model)
        self.adapter_id = 0
        self.cache_salt = 0
        # beam search: every hypothesis at the end, best first, as (output
        # tokens, cumulative logprob); set when the group finishes
        self.beam_hypotheses: Optional[list] = None

        self._out_q: "queue.Queue[StreamOutput]" = queue.Queue()
        self.enqueue_time = time.time()  # preemption order, timeouts, TTFT
        self.first_token_time: Optional[float] = None

    # ---- engine-side API ----

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.output_token_ids)

    @property
    def all_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def is_recompute(self) -> bool:
        """True when re-admitted after preemption with generated output: the
        prefill covers the generated tokens too (recompute)."""
        return bool(self.output_token_ids)

    @property
    def context_token_ids(self) -> List[int]:
        """Tokens the prefill computes KV for: the full history minus the
        pending last generated token (which re-enters decode directly)."""
        if self.output_token_ids:
            return self.all_token_ids[:-1]
        return self.prompt_token_ids

    def is_finished(self) -> bool:
        return self.state in (StreamState.FINISHED, StreamState.STOPPED)

    def forced_next_token(self) -> int:
        """-1 = no forcing; otherwise the token the sampler must emit next
        (think budget spent => think_end_token_id)."""
        cfg = self.config
        if (cfg.max_thinking_tokens and cfg.think_end_token_id is not None
                and self.thinking and self.think_tokens >= cfg.max_thinking_tokens):
            return int(cfg.think_end_token_id)
        return -1

    def needs_eos_ban(self) -> bool:
        return (self.config.ignore_eos
                or len(self.output_token_ids) < self.config.min_new_tokens)

    def append_token(self, token: int, eos_token_ids, logprob: Optional[float] = None,
                     max_seq_len: int = 0) -> bool:
        """Record one generated token, evaluate stop criteria and push an
        incremental chunk. Returns True if the stream finished."""
        if self.first_token_time is None:
            self.first_token_time = time.time()
        self.output_token_ids.append(int(token))
        if self.tree_state is not None:
            self.tree_state.update(int(token))
        cfg = self.config
        if cfg.think_start_token_id is not None:
            if token == cfg.think_start_token_id:
                self.thinking = True
                self.think_tokens = 0
            elif self.thinking:
                if token == cfg.think_end_token_id:
                    self.thinking = False
                else:
                    self.think_tokens += 1
        if logprob is not None:
            self.output_logprobs.append(float(logprob))

        n_out = len(self.output_token_ids)
        below_min = n_out < cfg.min_new_tokens
        eos_hit = (not cfg.ignore_eos) and (not below_min) and token in eos_token_ids
        stop_hit = (not below_min) and token in cfg.stop_token_ids
        reason = None
        if eos_hit or stop_hit or self._hits_stop_sequence():
            reason = FinishReason.STOP
        elif n_out >= cfg.max_new_tokens:
            reason = FinishReason.LENGTH
        elif max_seq_len and self.total_len >= max_seq_len:
            reason = FinishReason.LENGTH
        elif cfg.timeout_ms and (time.time() - self.enqueue_time) * 1000 > cfg.timeout_ms:
            reason = FinishReason.CANCELLED
        if reason is not None:
            self.finish(reason)
            return True
        self._out_q.put(StreamOutput(new_tokens=[int(token)], finished=False,
                                     logprobs=[logprob] if logprob is not None else None))
        return False

    def _hits_stop_sequence(self) -> bool:
        out = self.output_token_ids
        return any(len(out) >= len(s) and out[-len(s):] == s
                   for s in self.stop_token_sequences)

    def finish(self, reason: FinishReason, emit_all: bool = False):
        """``emit_all``: the final chunk carries the whole output (beam
        search delivers whole sequences, not incremental tokens)."""
        self.state = (StreamState.FINISHED
                      if reason in (FinishReason.STOP, FinishReason.LENGTH)
                      else StreamState.STOPPED)
        self.finish_reason = reason
        if self.first_token_time is None:
            self.first_token_time = time.time()
        last = list(self.output_token_ids) if emit_all else self.output_token_ids[-1:]
        self._out_q.put(StreamOutput(new_tokens=last, finished=True, finish_reason=reason))

    def abort(self, error: Optional[str] = None):
        self.state = StreamState.STOPPED
        self.finish_reason = FinishReason.ERROR if error else FinishReason.CANCELLED
        self.error = error
        self._out_q.put(StreamOutput(new_tokens=[], finished=True,
                                     finish_reason=self.finish_reason, error=error))

    # ---- consumer-side API ----

    def next_output(self, timeout: Optional[float] = None) -> StreamOutput:
        """Block for the next incremental chunk."""
        return self._out_q.get(timeout=timeout)
