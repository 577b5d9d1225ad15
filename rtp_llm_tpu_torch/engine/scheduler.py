"""FIFO continuous-batching scheduler with KV-memory admission.

Port of ``rtp_llm_tpu/engine/scheduler.py``: a waiting queue and a running
set; admission checks that the KV pool covers a new stream's peak need plus
a watermark; a running stream that outgrows the pool evicts the newest
running stream (recompute on re-admission).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List

from rtp_llm_tpu_torch.cache.kv_cache_manager import KVCacheManager
from rtp_llm_tpu_torch.config.engine_config import SchedulerConfig
from rtp_llm_tpu_torch.engine.stream import GenerateStream, StreamState


class FIFOScheduler:
    def __init__(self, config: SchedulerConfig, cache_manager: KVCacheManager):
        self.config = config
        self.cache = cache_manager
        self.waiting: Deque[GenerateStream] = deque()
        self.running: List[GenerateStream] = []
        # victims evicted by running-memory pressure this step; the engine
        # drains this to clear their decode slots
        self.preempted_this_step: List[GenerateStream] = []

    def enqueue(self, stream: GenerateStream) -> bool:
        if len(self.waiting) >= self.config.max_queue_size:
            stream.abort("overloaded: queue full")
            return False
        if stream.prompt_len + 1 > self.config.max_seq_len:
            stream.abort(f"prompt length {stream.prompt_len} exceeds max_seq_len "
                         f"{self.config.max_seq_len}")
            return False
        self.waiting.append(stream)
        return True

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def schedule(self) -> List[GenerateStream]:
        """Drop finished streams, admit waiting ones under KV + slot budget;
        returns the streams admitted this step (they need a prefill)."""
        self.running = [s for s in self.running if not s.is_finished()]
        new_streams: List[GenerateStream] = []
        watermark = max(1, int(self.cache.pool.num_blocks * self.config.watermark_frac))
        # with decodes running, bound the prompt tokens admitted per step
        tok_budget = self.config.max_prefill_tokens_per_step if self.running else 0
        admitted_tokens = 0
        while self.waiting:
            if len(self.running) + len(new_streams) >= self.config.max_batch_size:
                break
            s = self.waiting[0]
            if s.is_finished():  # cancelled while waiting
                self.waiting.popleft()
                continue
            ctx_len = s.total_len - 1 if s.output_token_ids else s.prompt_len
            if tok_budget and new_streams and admitted_tokens + ctx_len > tok_budget:
                break  # always admit at least one stream
            need = self.cache.estimate_peak_blocks(
                ctx_len, min(s.config.max_new_tokens - len(s.output_token_ids),
                             self.config.max_seq_len - ctx_len))
            if need + watermark > self.cache.free_blocks:
                break  # strict FIFO: do not skip ahead
            alloc = self.cache.allocate(s.all_token_ids)
            if alloc is None:
                break
            self.waiting.popleft()
            s.alloc = alloc
            s.reuse_len = min(alloc.reuse_len, ctx_len - 1)
            s.state = StreamState.RUNNING
            new_streams.append(s)
            admitted_tokens += ctx_len - s.reuse_len
        self.running.extend(new_streams)
        return new_streams

    def grow_for_decode(self, stream: GenerateStream, extra: int = 0) -> bool:
        """Ensure the stream's allocation covers this step's write. On OOM,
        evict the newest other running stream first; only if ``stream`` is
        itself the newest does it yield. Returns False if ``stream`` was
        preempted; victims are reported in ``preempted_this_step``."""
        if stream.alloc is None:
            return False  # already evicted as a victim
        if self.cache.extend(stream.alloc, stream.total_len + extra):
            return True
        victims = [s for s in self.running if s is not stream and s.alloc is not None]
        victims.sort(key=lambda s: s.enqueue_time, reverse=True)
        for v in victims:
            if stream.enqueue_time > v.enqueue_time:
                break  # stream itself is newer: it should yield instead
            self._preempt(v)
            self.preempted_this_step.append(v)
            if self.cache.extend(stream.alloc, stream.total_len + extra):
                return True
        self._preempt(stream)
        self.preempted_this_step.append(stream)
        return False

    def _preempt(self, stream: GenerateStream):
        """Release blocks and requeue at the front (recompute)."""
        self.cache.free(stream.alloc)
        stream.alloc = None
        stream.state = StreamState.WAITING
        self.waiting.appendleft(stream)
        self.running = [s for s in self.running if s is not stream]

    def release(self, stream: GenerateStream):
        """Free a finished stream's blocks, offering them to the prefix cache.
        Only tokens whose KV was written are offered: the last generated
        token is never fed back through the model."""
        if stream.alloc is not None:
            self.cache.free(stream.alloc, token_ids=stream.context_token_ids)
            stream.alloc = None
