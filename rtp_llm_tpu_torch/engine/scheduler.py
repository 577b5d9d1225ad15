"""FIFO continuous-batching scheduler with KV-memory admission.

Port of ``rtp_llm_tpu/engine/scheduler.py``: a waiting queue and a running
set; admission checks that the KV pool covers a new stream's peak need plus
a watermark; a running stream that outgrows the pool evicts the newest
running stream (recompute on re-admission). Admission controls: a cap on
the streams and (with decodes running) the prompt tokens admitted a step,
decode-only steps between prefill rounds, and shedding of new requests whose
projected queue wait exceeds the TTFT SLO.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, Tuple

from rtp_llm_tpu_torch.cache.kv_cache_manager import KVCacheManager, long_rope_salt
from rtp_llm_tpu_torch.config.engine_config import SchedulerConfig
from rtp_llm_tpu_torch.engine.stream import GenerateStream, StreamState
from rtp_llm_tpu_torch.utils.metrics import METRICS


class FIFOScheduler:
    def __init__(self, config: SchedulerConfig, cache_manager: KVCacheManager):
        self.config = config
        self.cache = cache_manager
        self.waiting: Deque[GenerateStream] = deque()
        self.running: List[GenerateStream] = []
        # victims evicted by running-memory pressure this step; the engine
        # drains this to clear their decode slots
        self.preempted_this_step: List[GenerateStream] = []
        # ratio control: decode-only steps since the last prefill round
        self._steps_since_prefill = 0
        # (time, prompt tokens) of each admission in the last 30 s: the drain
        # rate behind the projected queue wait
        self._admit_events: Deque[Tuple[float, int]] = deque()
        # a longrope model's switch length (0: one RoPE table), set by the
        # engine: a stream whose context passes it prefills on the long table
        # and keys its prefix blocks apart (``long_rope_salt``); a shorter
        # one offers only the blocks below it, whose keys turn by the short one
        self.rope_switch = 0

    def projected_wait_s(self) -> float:
        """Estimated queue wait of a new request: the prompt tokens queued
        ahead of it over the admitted prompt tokens a second, observed over
        the last 30 s (or the span observed so far, at least 1 s)."""
        now = time.time()
        while self._admit_events and now - self._admit_events[0][0] > 30.0:
            self._admit_events.popleft()
        if not self.waiting:
            return 0.0
        span = 30.0
        if self._admit_events:
            span = min(30.0, max(1.0, now - self._admit_events[0][0]))
        tok_rate = sum(n for _, n in self._admit_events) / span
        if tok_rate <= 0.0:
            # no drain observed: overloaded only past a full batch queued
            return float("inf") if len(self.waiting) > self.config.max_batch_size else 0.0
        return sum(max(s.prompt_len, 1) for s in self.waiting) / tok_rate

    def enqueue(self, stream: GenerateStream) -> bool:
        if len(self.waiting) >= self.config.max_queue_size:
            stream.abort("overloaded: queue full")
            return False
        slo = self.config.ttft_slo_ms
        if slo > 0:
            wait_s = self.projected_wait_s()
            if wait_s * 1e3 > slo:
                METRICS.inc("scheduler.sla_rejections")
                stream.abort(f"overloaded: projected queue wait {wait_s:.1f}s "
                             f"exceeds ttft_slo_ms={slo}")
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
        # ratio control: space prefill rounds apart while decodes are running
        spacing = self.config.decode_steps_per_prefill
        if spacing and self.running and self._steps_since_prefill < spacing:
            self._steps_since_prefill += 1
            return new_streams
        watermark = max(1, int(self.cache.pool.num_blocks * self.config.watermark_frac))
        cap = self.config.max_prefills_per_step
        # with decodes running, bound the prompt tokens admitted per step
        tok_budget = self.config.max_prefill_tokens_per_step if self.running else 0
        admitted_tokens = 0
        while self.waiting:
            if cap and len(new_streams) >= cap:
                break
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
                             self.config.max_seq_len - ctx_len),
            ) * max(1, s.config.max_num_beams)  # beams fork the KV footprint
            if need + watermark > self.cache.free_blocks:
                break  # strict FIFO: do not skip ahead
            long = bool(self.rope_switch) and ctx_len > self.rope_switch
            alloc = self.cache.allocate(
                s.all_token_ids, salt=long_rope_salt(s.cache_salt) if long else s.cache_salt)
            if alloc is None:
                break
            s.rope_keep = self.rope_switch if self.rope_switch and not long else None
            self.waiting.popleft()
            s.alloc = alloc
            s.reuse_len = min(alloc.reuse_len, ctx_len - 1)
            s.state = StreamState.RUNNING
            new_streams.append(s)
            admitted_tokens += ctx_len - s.reuse_len
            METRICS.inc("cache.prefix_reused_tokens", s.reuse_len)
            METRICS.inc("cache.prefill_context_tokens", ctx_len)
        if new_streams:
            self._steps_since_prefill = 0
            now = time.time()
            self._admit_events.extend((now, max(s.prompt_len, 1)) for s in new_streams)
        else:
            self._steps_since_prefill += 1
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
        token is never fed back through the model; of a longrope model's
        short stream, only those whose keys turn by the short table."""
        if stream.alloc is not None:
            ids = stream.context_token_ids
            self.cache.free(stream.alloc, token_ids=ids if stream.rope_keep is None
                            else ids[: stream.rope_keep])
            stream.alloc = None
