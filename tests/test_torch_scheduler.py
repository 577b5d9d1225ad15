"""The port's FIFO scheduler against the JAX ``FIFOScheduler``.

The same enqueue / schedule / finish sequences run through both schedulers
(each over its own KV cache manager and streams); the streams admitted at
every step must be the same, under the PD-fusion ratio control
(``max_prefills_per_step``, ``decode_steps_per_prefill``), the mixed-load
prompt-token budget (``max_prefill_tokens_per_step``) and KV admission.
The TTFT-SLO guard (``ttft_slo_ms``) must project the same queue wait and
shed the same requests with both clocks patched. Mirrors
``tests/test_engine.py:308`` and ``:333``.
"""

import time

import numpy as np
import pytest

from rtp_llm_tpu.cache.kv_cache_manager import KVCacheManager as JCache
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine.scheduler import FIFOScheduler as JScheduler
from rtp_llm_tpu.engine.stream import GenerateStream as JStream
from rtp_llm_tpu_torch.cache.kv_cache_manager import KVCacheManager
from rtp_llm_tpu_torch.config import GenerateConfig, SchedulerConfig
from rtp_llm_tpu_torch.engine.scheduler import FIFOScheduler
from rtp_llm_tpu_torch.engine.stream import GenerateStream

import torch

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each


class Pair:
    """The two schedulers side by side, streams enqueued to both."""

    def __init__(self, num_blocks=64, block_size=4, **sched):
        self.j = JScheduler(JSched(**sched), JCache(num_blocks, block_size,
                                                    backend="python"))
        self.t = FIFOScheduler(SchedulerConfig(**sched), KVCacheManager(num_blocks, block_size))
        self.js, self.ts = [], []

    def enqueue(self, prompt, max_new=4):
        kw = dict(max_new_tokens=max_new, ignore_eos=True)
        js = JStream(list(prompt), JGen(**kw))
        ts = GenerateStream(list(prompt), GenerateConfig(**kw))
        ok = (self.j.enqueue(js), self.t.enqueue(ts))
        self.js.append(js)
        self.ts.append(ts)
        assert (js.error, js.state.value) == (ts.error, ts.state.value)
        return ok

    def schedule(self):
        """Admissions of one step, as stream indices: (JAX, port)."""
        jn = self.j.schedule().new_streams
        tn = self.t.schedule()
        return ([self.js.index(s) for s in jn], [self.ts.index(s) for s in tn])

    def finish(self, i):
        for sched, s in ((self.j, self.js[i]), (self.t, self.ts[i])):
            s.abort()
            sched.release(s)


def test_ratio_control_matches_jax():
    """tests/test_engine.py:308: one admission a step, then two decode-only
    steps, on both schedulers."""
    p = Pair(max_batch_size=8, max_seq_len=64, prefill_buckets=(16,),
             max_prefills_per_step=1, decode_steps_per_prefill=2)
    for _ in range(3):
        assert p.enqueue([1, 2, 3]) == (True, True)
    got = [p.schedule() for _ in range(6)]
    assert all(j == t for j, t in got)
    assert [t for _, t in got] == [[0], [], [], [1], [], []]


def test_prefill_token_budget_matches_jax():
    """tests/test_engine.py:333: an idle engine admits freely; with decodes
    running the budget admits two 32-token prompts a step, and an oversized
    prompt alone."""
    p = Pair(num_blocks=256, max_batch_size=16, max_seq_len=256, prefill_buckets=(64,),
             max_prefill_tokens_per_step=64)
    prompt = list(range(1, 33))
    for _ in range(4):
        p.enqueue(prompt)
    steps = [p.schedule()]
    for _ in range(5):
        p.enqueue(prompt)
    steps += [p.schedule(), p.schedule()]
    p.enqueue(list(range(1, 129)))
    steps += [p.schedule(), p.schedule()]
    assert all(j == t for j, t in steps)
    assert [len(t) for _, t in steps] == [4, 2, 2, 1, 1]


# (max_prefills_per_step, decode_steps_per_prefill, max_prefill_tokens_per_step)
CONTROLS = [(0, 0, 0), (0, 0, 40), (1, 0, 2048), (2, 1, 2048), (3, 2, 60), (0, 3, 0)]


@pytest.mark.parametrize("cap,spacing,budget", CONTROLS,
                         ids=[f"cap{c}-space{s}-budget{b}" for c, s, b in CONTROLS])
@pytest.mark.parametrize("seed", range(3))
def test_random_sequences_match_jax(cap, spacing, budget, seed):
    """Random enqueues, schedule steps and finishes over a pool small enough
    to refuse admissions: the same streams admitted at every step."""
    rng = np.random.default_rng(seed)
    p = Pair(num_blocks=48, max_batch_size=6, max_seq_len=64, prefill_buckets=(16, 32),
             max_prefills_per_step=cap, decode_steps_per_prefill=spacing,
             max_prefill_tokens_per_step=budget)
    admitted = 0
    for _ in range(40):
        for _ in range(int(rng.integers(0, 3))):
            p.enqueue(rng.integers(1, 100, int(rng.integers(1, 30))).tolist(),
                      max_new=int(rng.integers(1, 20)))
        j, t = p.schedule()
        assert j == t
        admitted += len(t)
        running = [i for i, s in enumerate(p.ts) if s.state.value == "running"]
        for i in running:
            if rng.random() < 0.3:
                p.finish(i)
    assert admitted > 5
    assert p.j.cache.free_blocks == p.t.cache.free_blocks


@pytest.fixture
def clock(monkeypatch):
    """Both schedulers read ``time.time``; the test sets it."""
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


def test_projected_wait_matches_jax(clock):
    """The queue wait a new request would see: queued prompt tokens over the
    admitted prompt tokens a second in the last 30 s (or the span observed,
    at least 1 s); infinite with no drain observed past a full batch."""
    p = Pair(num_blocks=64, max_batch_size=2, max_seq_len=256)
    waits = [(p.j.projected_wait_s(), p.t.projected_wait_s())]
    for n in (10, 20, 30):
        p.enqueue(list(range(1, n + 1)))
    waits.append((p.j.projected_wait_s(), p.t.projected_wait_s()))  # no drain, depth 3 > 2
    for dt in (0.5, 2.0, 10.0, 25.0, 31.0, 45.0):
        clock[0] += dt
        p.schedule()
        p.enqueue(list(range(1, 16)))
        waits.append((p.j.projected_wait_s(), p.t.projected_wait_s()))
        for i, s in enumerate(p.ts):
            if s.state.value == "running":
                p.finish(i)
    assert all(j == t for j, t in waits)
    assert waits[0][1] == 0.0 and waits[1][1] == float("inf")
    assert len({t for _, t in waits}) > 3


@pytest.mark.parametrize("slo_ms", [1, 1500, 30000])
def test_ttft_slo_shedding_matches_jax(clock, slo_ms):
    """With ``ttft_slo_ms`` set both schedulers shed the same requests with
    an error starting "overloaded" (the frontend answers 429)."""
    p = Pair(num_blocks=256, max_batch_size=4, max_seq_len=256, ttft_slo_ms=slo_ms)
    rng = np.random.default_rng(slo_ms)
    decisions = []
    for _ in range(30):
        clock[0] += float(rng.uniform(0.05, 2.0))
        for _ in range(int(rng.integers(1, 4))):
            decisions.append(p.enqueue(rng.integers(1, 100, int(rng.integers(5, 60))).tolist()))
        j, t = p.schedule()
        assert j == t
        for i, s in enumerate(p.ts):
            if s.state.value == "running" and rng.random() < 0.5:
                p.finish(i)
    assert all(j == t for j, t in decisions)
    shed = [s for s in p.ts if s.error]
    assert all(s.error.startswith("overloaded") for s in shed)
    if slo_ms == 1:
        assert shed
    if slo_ms == 30000:
        assert not shed


def test_overloaded_queue_full_matches_jax():
    p = Pair(max_batch_size=2, max_seq_len=64, max_queue_size=2)
    assert [p.enqueue([1, 2]) for _ in range(3)] == [(True, True)] * 2 + [(False, False)]
    assert p.ts[2].error == "overloaded: queue full"


@pytest.mark.parametrize("argv,want", [
    ([], dict(max_prefill_tokens_per_step=2048, max_prefills_per_step=0,
              decode_steps_per_prefill=0, ttft_slo_ms=0)),
    (["--max-prefill-tokens-per-step", "512", "--max-prefills-per-step", "2",
      "--decode-steps-per-prefill", "3", "--ttft-slo-ms", "1500"],
     dict(max_prefill_tokens_per_step=512, max_prefills_per_step=2,
          decode_steps_per_prefill=3, ttft_slo_ms=1500)),
], ids=["defaults", "set"])
def test_cli_flags_reach_the_scheduler_config(argv, want):
    """``serve``'s admission flags land in ``SchedulerConfig``; the defaults
    are the JAX config's."""
    from rtp_llm_tpu_torch.cli import config_from_args, parse_args

    sc = config_from_args(parse_args(["serve", "/ckpt", *argv])).scheduler
    assert {k: getattr(sc, k) for k in want} == want
    if not argv:
        assert want == {k: getattr(JSched(), k) for k in want}
