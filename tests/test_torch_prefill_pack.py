"""Packed, pipelined prefill of the port against the JAX engine.

The JAX engine packs the new streams of a step into batched prefill calls
(``_run_prefills_packed``), dispatches each group's forward and first-token
sample in one step and finishes it (token fetch, slot insertion) in the
next. The port does the same at each row's real length. Both engines run on
the CPU at tiny shapes (f32 weights and KV, blocks of 4 tokens, prefill
buckets (16, 64), 8 decode slots so that six streams are admitted at once):
greedy tokens must be equal. Mirrors ``tests/test_engine.py:696``
(``TestDeferredPrefillFinish``).
"""

import numpy as np
import pytest
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import llama_family

BS, BATCH, MSL, BUCKETS = 4, 8, 256, (16, 64)
CONFIGS = [(1, False), (1, True), (4, False), (4, True)]  # (decode_steps, async_decode)
IDS = ["n1-sync", "n1-async", "n4-sync", "n4-async"]
# packed first-token logits against the same stream prefilled alone, f32:
# within this share of the largest logit
LOGITS_TOL = 1e-5


def port_engine(ckpt, steps=1, asy=True, num_blocks=128, batch=BATCH, **sched):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=num_blocks),
        scheduler=SchedulerConfig(max_batch_size=batch, max_seq_len=MSL,
                                  prefill_buckets=BUCKETS, decode_steps=steps,
                                  async_decode=asy, **sched),
        quant=QuantConfig(kv_cache_dtype="float32"))
    weights = CheckpointLoader(cfg, device="cpu").load(ckpt)
    return LlmEngine(llama_family.LlamaFamilyModel(cfg, device="cpu"), weights, econf,
                     device="cpu")


def jax_engine(ckpt, steps=1, asy=True, num_blocks=128, batch=BATCH):
    cfg = tiny_config("qwen2", dtype="float32")
    econf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=num_blocks),
        scheduler=JSched(max_batch_size=batch, max_seq_len=MSL, prefill_buckets=BUCKETS,
                         decode_steps=steps, async_decode=asy))
    econf.quant.kv_cache_dtype = "float32"
    return JEngine(create_model(cfg), JLoader(cfg).load(ckpt), econf)


def greedy(n, **kw):
    return dict(max_new_tokens=n, do_sample=False, ignore_eos=True, **kw)


def run(engine, reqs, gen_cls, steps=600, watch=None):
    """Enqueue (prompt, config kwargs) pairs together and step until all
    finish. ``watch(streams)`` runs after every step."""
    streams = [engine.enqueue(p, gen_cls(**kw)) for p, kw in reqs]
    for _ in range(steps):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
        if watch is not None:
            watch(streams)
    assert all(s.is_finished() for s in streams)
    return streams


def drain_and_check_no_leak(te, batch=BATCH):
    """Step until nothing is in flight; then every slot is free and every
    used block is the prefix cache's."""
    for _ in range(20):
        if not te.has_work():
            break
        te.step()
    assert not te.has_work() and te._pending is None and not te._prefill_pending
    assert sorted(te._free_slots) == list(range(batch))
    assert all(s is None for s in te.slots)
    assert te.cache_mgr.pool.used_blocks == len(te.cache_mgr.prefix_cache)


def prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 128, n).tolist()


PREFIX = prompt(1, 24)
# six streams of lengths across the JAX buckets: 5 and 12 (16), 20 and 40
# (64), 70 (> 64: chunked), one behind a reused 24-token prefix; one samples
# with top_k = 1 (its draw is the argmax)
SIX = [(prompt(2, 5), greedy(9)), (prompt(3, 20), greedy(7)),
       (PREFIX + prompt(4, 9), greedy(8)), (prompt(5, 70), greedy(6)),
       (prompt(6, 40), dict(max_new_tokens=10, do_sample=True, top_k=1, ignore_eos=True)),
       (prompt(7, 12), greedy(11))]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("pack")), tiny_config("qwen2"))


@pytest.fixture(scope="module")
def jax_engines(ckpt):
    engines = {}

    def get(steps, asy):
        if (steps, asy) not in engines:
            engines[steps, asy] = jax_engine(ckpt, steps, asy)
        return engines[steps, asy]
    return get


class _spy:
    """Records what the model's linears and attention see: the row count M
    of each linear, the (B, T) of each attention call."""

    def __init__(self, monkeypatch, engine):
        self.m, self.bt = [], []
        model = engine.model
        linear, attention = model._linear, llama_family.paged_attention

        def spy_linear(w, name, i, x, *rest):
            self.m.append(x.shape[0])
            return linear(w, name, i, x, *rest)

        def spy_attention(q, *a, **kw):
            self.bt.append(tuple(q.shape[:2]))
            return attention(q, *a, **kw)
        monkeypatch.setattr(model, "_linear", spy_linear)
        monkeypatch.setattr(llama_family, "paged_attention", spy_attention)


def _logits_of(engine, monkeypatch):
    """Record the first-token logits of every prefill: [(streams, [n, V])]."""
    seen = []
    sample = engine._sample_first

    def spy(streams, logits, bt):
        seen.append((list(streams), logits.clone()))
        return sample(streams, logits, bt)
    monkeypatch.setattr(engine, "_sample_first", spy)
    return seen


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
def test_six_streams_greedy_match_jax(ckpt, jax_engines, steps, asy):
    """Six streams at once (one group of four, one pair beside a chunked
    prompt), one of them behind a prefix a first request cached: the JAX
    engine's tokens. Both engines pack; the port's groups ran as groups."""
    je = jax_engines(steps, asy)
    te = port_engine(ckpt, steps, asy)
    groups = []
    dispatch = te._dispatch_prefill_group

    def spy(group):
        groups.append(len(group))
        return dispatch(group)
    te._dispatch_prefill_group = spy
    first = [(PREFIX + prompt(8, 3), greedy(4))]
    assert ([s.output_token_ids for s in run(te, first, GenerateConfig)]
            == [s.output_token_ids for s in run(je, first, JGen)])
    want = run(je, SIX, JGen)
    got = run(te, SIX, GenerateConfig)
    assert [s.output_token_ids for s in got] == [s.output_token_ids for s in want]
    assert got[2].reuse_len == want[2].reuse_len == 24
    assert [len(s.output_token_ids) for s in got] == [9, 7, 8, 6, 10, 11]
    # 5 + 20 + 9 + 40 = 74 real tokens pass the 64-token cap: the fourth
    # stream opens a second group
    assert groups == [3, 2]
    drain_and_check_no_leak(te)


def test_packed_rows_equal_solo_prefill(ckpt, monkeypatch):
    """Each packed row's first-token logits equal the same stream prefilled
    alone (one behind a reused prefix), within LOGITS_TOL of the largest
    logit, f32."""
    reqs = [(prompt(10, 7), greedy(2)), (PREFIX + prompt(11, 17), greedy(2)),
            (prompt(12, 30), greedy(2)), (prompt(13, 1), greedy(2))]
    solo = []
    for p, kw in reqs:
        te = port_engine(ckpt)
        if p[:24] == PREFIX:
            run(te, [(PREFIX + [5], greedy(1))], GenerateConfig)
        seen = _logits_of(te, monkeypatch)
        run(te, [(p, kw)], GenerateConfig)
        solo.append(seen[0][1][0])
    te = port_engine(ckpt)
    run(te, [(PREFIX + [5], greedy(1))], GenerateConfig)
    seen = _logits_of(te, monkeypatch)
    streams = run(te, reqs, GenerateConfig)
    (group, packed), = seen
    assert group == streams and streams[1].reuse_len == 24
    for r, want in enumerate(solo):
        err = float((packed[r] - want).abs().max())
        assert err <= LOGITS_TOL * float(want.abs().max()), (r, err)
        assert int(packed[r].argmax()) == int(want.argmax())


def test_no_pad_row_reaches_a_linear(ckpt, monkeypatch):
    """A group's linears run at M = its real tokens, never n x bucket; its
    attention takes B = the group's rows at T = its longest row. A prompt
    longer than the largest bucket runs a full chunk, then its remainder."""
    te = port_engine(ckpt)
    spy = _spy(monkeypatch, te)
    lens = (5, 20, 33, 3)
    streams = [te.enqueue(prompt(20 + i, n), GenerateConfig(**greedy(2)))
               for i, n in enumerate(lens)]
    te.step()
    layers = te.model.cfg.num_layers
    assert spy.m == [sum(lens)] * 4 * layers
    assert spy.bt == [(4, 33)] * layers
    assert all(s.slot < 0 for s in streams) and len(te._prefill_pending) == 1

    spy.m.clear(), spy.bt.clear()
    run(te, [(prompt(30, 70), greedy(1))], GenerateConfig)
    prefill_m = [m for m in spy.m if m != BATCH]  # the decode windows run M = 8
    assert prefill_m == [64] * 4 * layers + [6] * 4 * layers
    assert (1, 64) in spy.bt and (1, 6) in spy.bt and (1, 16) not in spy.bt
    drain_and_check_no_leak(te)


@pytest.mark.parametrize("seed", range(8))
def test_group_cap_cross_checks(ckpt, seed):
    """Groups hold at most PREFILL_PACK streams and at most the largest
    bucket's real tokens, keep FIFO order and cover every stream; a group
    closes only when the next stream would break a limit."""
    te = port_engine(ckpt)
    rng = np.random.default_rng(seed)
    cap = BUCKETS[-1]
    streams = [te.enqueue(prompt(100 + i, int(n)), GenerateConfig(**greedy(1)))
               for i, n in enumerate(rng.integers(1, cap + 1, int(rng.integers(1, 13))))]
    for s in streams:
        s.reuse_len = int(rng.integers(0, s.prompt_len))
    groups = te._pack_groups(streams)
    assert [s for g in groups for s in g] == streams
    real = [sum(s.prompt_len - s.reuse_len for s in g) for g in groups]
    assert all(1 <= len(g) <= te.PREFILL_PACK for g in groups)
    assert all(n <= cap for n in real)
    for g, nxt, n in zip(groups, groups[1:], real):
        assert (len(g) == te.PREFILL_PACK
                or n + nxt[0].prompt_len - nxt[0].reuse_len > cap)


class TestDeferredPrefillFinish:
    """Port of ``tests/test_engine.py:696``: groups dispatched in step N
    finish (token fetch + slot insert) in step N+1; every deferral must flush
    and never lose or duplicate a first token."""

    def test_groups_defer_and_flush(self, ckpt, jax_engines):
        prompts = [[1, 2, 3, i % 5 + 4] for i in range(6)]
        want = run(jax_engines(1, True), [(p, greedy(6)) for p in prompts], JGen)
        te = port_engine(ckpt)
        streams = [te.enqueue(p, GenerateConfig(**greedy(6))) for p in prompts]
        te.step()  # admits all 6: a group of four and a pair, both pending
        assert [len(g.streams) for g in te._prefill_pending] == [4, 2]
        assert all(s.slot < 0 and not s.output_token_ids for s in streams)
        assert te.has_work()
        firsts = []
        for _ in range(60):
            if all(s.is_finished() for s in streams):
                break
            te.step()
            firsts.append(sum(bool(s.output_token_ids) for s in streams))
        assert firsts[0] == 6  # all inserted by the next step, together
        assert [s.output_token_ids for s in streams] == [s.output_token_ids for s in want]
        drain_and_check_no_leak(te)

    def test_abort_between_dispatch_and_finish(self, ckpt, jax_engines):
        prompts = [[9, 8, 7, i + 1] for i in range(4)]
        want = run(jax_engines(1, True), [(p, greedy(6)) for p in prompts], JGen)
        te = port_engine(ckpt)
        streams = [te.enqueue(p, GenerateConfig(**greedy(6))) for p in prompts]
        te.step()
        assert te._prefill_pending
        streams[2].abort()
        for _ in range(60):
            if all(s.is_finished() for s in streams):
                break
            te.step()
        assert streams[2].output_token_ids == [] and streams[2].slot < 0
        for i in (0, 1, 3):
            assert streams[i].output_token_ids == want[i].output_token_ids
        drain_and_check_no_leak(te)

    def test_abort_all_drops_pending_groups(self, ckpt):
        te = port_engine(ckpt)
        streams = [te.enqueue(prompt(40 + i, 6), GenerateConfig(**greedy(4))) for i in range(3)]
        te.step()
        assert te._prefill_pending
        te.abort_all("test")
        assert not te._prefill_pending and all(s.is_finished() for s in streams)
        drain_and_check_no_leak(te)


def _pending_streams(te):
    return {id(s) for g in te._prefill_pending for s in g.streams}


# per (decode_steps, async_decode): (steps the two older streams run
# before the newer pair is enqueued, blocks in the pool (block 0 is the
# null block), max_new_tokens of the newer pair). The pair fits at
# admission; the older streams' growth in the step that dispatches the pair
# leaves no block for the second of them, which evicts the newest stream.
EVICTION = {(1, False): (7, 15, 1), (1, True): (2, 14, 5), (4, False): (1, 14, 5),
            (4, True): (1, 14, 5)}


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
def test_victim_preempted_while_group_pending_matches_jax(ckpt, steps, asy):
    """A small pool: two older streams decoding grow in the step that
    dispatches a group and evict one of the group's streams before the group
    finishes. The victim takes no slot at the finish, prefills again when it
    is re-admitted and still gives the JAX engine's tokens."""
    before, blocks, new_tokens = EVICTION[steps, asy]
    older = [(prompt(50, 10), greedy(24)), (prompt(53, 10), greedy(24))]
    newer = [(prompt(51, 7), greedy(new_tokens)), (prompt(52, 11), greedy(new_tokens))]

    def serve(engine, gen_cls, victims=None):
        streams = [engine.enqueue(p, gen_cls(**kw)) for p, kw in older]
        for _ in range(before):
            engine.step()
        streams += [engine.enqueue(p, gen_cls(**kw)) for p, kw in newer]
        for _ in range(300):
            if all(s.is_finished() for s in streams):
                break
            pending = _pending_streams(engine) if victims is not None else set()
            engine.step()
            if victims is not None:
                victims.extend(s for s in streams
                               if id(s) in pending and s.state.value == "waiting")
                assert all(s.slot < 0 for s in victims if s.alloc is None)
        assert all(s.is_finished() for s in streams)
        return [s.output_token_ids for s in streams]

    want = serve(jax_engine(ckpt, steps, asy, num_blocks=blocks), JGen)
    te = port_engine(ckpt, steps, asy, num_blocks=blocks)
    victims = []
    assert serve(te, GenerateConfig, victims) == want
    assert victims, "the pool must be small enough to evict a pending stream"
    drain_and_check_no_leak(te)


def test_victim_readmitted_before_its_group_finishes(ckpt, monkeypatch):
    """A stream evicted from a pending group and admitted again in the next
    step, while that group is finished: the old group skips it (its
    allocation is not the one the group wrote), the new prefill inserts it
    once, and its tokens are those of the stream run alone."""
    p = prompt(60, 9)
    want = port_engine(ckpt).generate(p, GenerateConfig(**greedy(6))).output_token_ids
    te = port_engine(ckpt)
    inserts = []
    insert = te.state.insert_slot

    def spy(slot, token, *a, **kw):
        inserts.append(slot)
        return insert(slot, token, *a, **kw)
    monkeypatch.setattr(te.state, "insert_slot", spy)
    streams = [te.enqueue(prompt(61, 5), GenerateConfig(**greedy(6))),
               te.enqueue(p, GenerateConfig(**greedy(6)))]
    te.step()
    victim = streams[1]
    (group,) = te._prefill_pending
    te.scheduler._preempt(victim)  # as grow_for_decode evicts a victim
    te.step()  # re-admits the victim: a new single prefill, then the old group finishes
    assert victim.alloc is not None and victim.alloc is not group.allocs[1]
    for _ in range(60):
        if all(s.is_finished() for s in streams):
            break
        te.step()
    assert len(inserts) == 2 and victim.output_token_ids == want
    drain_and_check_no_leak(te)


def test_reference_inserts_a_readmitted_victim_twice(ckpt):
    """The JAX engine's fault in the same case (ROADMAP section C): its
    ``_still_live`` checks only that the stream holds an allocation and is
    running, so the old group inserts the re-admitted victim too. The
    stream decodes from two slots, its tokens go wrong and one decode slot
    leaks."""
    p = prompt(60, 9)
    want = jax_engine(ckpt).generate(p, JGen(**greedy(6))).output_token_ids
    je = jax_engine(ckpt)
    streams = [je.enqueue(prompt(61, 5), JGen(**greedy(6))), je.enqueue(p, JGen(**greedy(6)))]
    je.step()
    assert len(je._prefill_pending) == 1
    je.scheduler._preempt(streams[1])
    for _ in range(60):
        if all(s.is_finished() for s in streams):
            break
        je.step()
    assert streams[1].output_token_ids != want
    assert streams[1].output_token_ids[:2] == [want[0]] * 2  # the first token twice
    assert len(je._free_slots) == BATCH - 1


def test_prefill_dispatch_makes_no_blocking_copy(ckpt, monkeypatch):
    """The prefill path reads nothing back and copies to the device only
    through ``upload`` (pinned, non-blocking on the card): no ``.cpu()``,
    ``.item()``, ``.tolist()`` or ``nonzero()`` of a tensor while a group is
    dispatched."""
    from rtp_llm_tpu_torch.engine import engine as engine_mod

    te = port_engine(ckpt)
    streams = [te.enqueue(prompt(70 + i, 4 + 3 * i), GenerateConfig(**greedy(3)))
               for i in range(3)]
    te.scheduler.schedule()
    banned = []
    for name in ("cpu", "item", "tolist", "nonzero"):
        orig = getattr(torch.Tensor, name)

        def trap(self, *a, _name=name, _orig=orig, **kw):
            banned.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, trap)
    uploads = []
    upload = engine_mod.upload

    def spy(host, device):
        uploads.append(host.device.type)
        return upload(host, device)
    monkeypatch.setattr(engine_mod, "upload", spy)
    g = te._dispatch_prefill_group(streams)
    assert banned == [] and uploads and set(uploads) == {"cpu"}
    monkeypatch.undo()
    te._prefill_pending.append(g)
    for _ in range(30):
        if all(s.is_finished() for s in streams):
            break
        te.step()
    assert all(len(s.output_token_ids) == 3 for s in streams)
    drain_and_check_no_leak(te)

