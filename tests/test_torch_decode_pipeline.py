"""Multi-step and pipelined decode of the port against the JAX engine.

Each case runs on the CPU at tiny shapes (f32 weights and KV, blocks of 4
tokens) with ``decode_steps`` in {1, 4} and ``async_decode`` off and on,
the JAX engine of the same configuration beside it (one per configuration
for the module): greedy tokens must be equal. Mirrors
``tests/test_engine.py:371`` (multi-step equals single-step, also sampled)
and ``:755`` (warmup covers every decode program serving dispatches).
"""

import pytest

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
from rtp_llm_tpu_torch.engine.decode_graphs import WindowKey
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs

import torch

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

BS, NB, BATCH, MSL = 4, 24, 4, 64
CONFIGS = [(1, False), (1, True), (4, False), (4, True)]  # (decode_steps, async_decode)
IDS = ["n1-sync", "n1-async", "n4-sync", "n4-async"]
EOS_PROMPT = [7, 7, 8]


def port_engine(ckpt, steps, asy, eos=None, num_blocks=NB, max_seq_len=MSL, **sched):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    if eos is not None:
        cfg.eos_token_id = [eos]
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=num_blocks),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=max_seq_len,
                                  prefill_buckets=(16, 64), decode_steps=steps,
                                  async_decode=asy, **sched),
        quant=QuantConfig(kv_cache_dtype="float32"))
    weights = CheckpointLoader(cfg, device="cpu").load(ckpt)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), weights, econf, device="cpu")


def jax_engine(ckpt, steps, asy, eos=None, num_blocks=NB, max_seq_len=MSL):
    extra = {} if eos is None else {"eos_token_id": [eos]}
    cfg = tiny_config("qwen2", dtype="float32", **extra)
    econf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=num_blocks),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=max_seq_len,
                         prefill_buckets=(16, 64), decode_steps=steps, async_decode=asy))
    econf.quant.kv_cache_dtype = "float32"
    return JEngine(create_model(cfg), JLoader(cfg).load(ckpt), econf)


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


def drain_and_check_no_leak(te):
    """Step until nothing is in flight; then every slot is free and every
    used block is the prefix cache's."""
    for _ in range(20):
        if not te.has_work():
            break
        te.step()
    assert not te.has_work() and te._pending is None
    assert sorted(te._free_slots) == list(range(BATCH))
    assert all(s is None for s in te.slots)
    assert te.cache_mgr.pool.used_blocks == len(te.cache_mgr.prefix_cache)


def blocks_cover_writes(te):
    """A watch: every KV position a dispatched window writes (below the
    slot's device length) lies in a block the stream holds."""
    def watch(_):
        for s in te.scheduler.running:
            if s.slot >= 0 and s.alloc is not None:
                assert len(s.alloc.blocks) * BS >= int(te.state.kv_lens[s.slot])
    return watch


def greedy(n, **kw):
    return dict(max_new_tokens=n, do_sample=False, ignore_eos=True, **kw)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("pipe")), tiny_config("qwen2"))


@pytest.fixture(scope="module")
def eos(ckpt):
    """(token, index): a token the greedy output of EOS_PROMPT first reaches
    at output index j with j % 4 != 0, i.e. inside a window of 4 decode
    steps (index 0 comes from the prefill, windows cover 1-4, 5-8, ..)."""
    out = port_engine(ckpt, 1, False).generate(
        EOS_PROMPT, GenerateConfig(max_new_tokens=16, do_sample=False)).output_token_ids
    for j in range(2, len(out)):
        if j % 4 and out[j] not in out[:j]:
            return out[j], j
    raise AssertionError(f"no mid-window first occurrence in {out}")


@pytest.fixture(scope="module")
def jax_engines(ckpt, eos):
    engines = {}

    def get(steps, asy):
        if (steps, asy) not in engines:
            engines[steps, asy] = jax_engine(ckpt, steps, asy, eos=eos[0])
        return engines[steps, asy]
    return get


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
def test_mid_window_eos_stop_matches_jax(ckpt, eos, jax_engines, steps, asy):
    token, index = eos
    kw = dict(max_new_tokens=16, do_sample=False)
    want = run(jax_engines(steps, asy), [(EOS_PROMPT, kw)], JGen)[0]
    te = port_engine(ckpt, steps, asy, eos=token)
    got = run(te, [(EOS_PROMPT, kw)], GenerateConfig)[0]
    assert got.output_token_ids == want.output_token_ids
    assert len(got.output_token_ids) == index + 1 and got.output_token_ids[-1] == token
    assert got.finish_reason.value == "stop"
    drain_and_check_no_leak(te)


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
def test_staggered_finishes_match_jax(ckpt, eos, jax_engines, steps, asy):
    reqs = [([1, 5, 9, 42, 7], greedy(6)), ([2, 4, 6], greedy(11)),
            ([100, 3, 55, 8, 9, 10], greedy(14)), ([64, 65], greedy(3))]
    want = run(jax_engines(steps, asy), reqs, JGen)
    te = port_engine(ckpt, steps, asy, eos=eos[0])
    got = run(te, reqs, GenerateConfig, watch=blocks_cover_writes(te))
    assert [s.output_token_ids for s in got] == [s.output_token_ids for s in want]
    assert [len(s.output_token_ids) for s in got] == [6, 11, 14, 3]
    drain_and_check_no_leak(te)


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
def test_preemption_under_multi_step_matches_jax(ckpt, eos, jax_engines, steps, asy):
    """23 usable blocks, two streams that peak at 12 each: growing them
    preempts the newer one, which recomputes its context."""
    reqs = [([3, 1, 4, 1, 5, 9, 2, 6], greedy(40)), ([2, 7, 1, 8, 2, 8], greedy(40))]
    want = run(jax_engines(steps, asy), reqs, JGen)
    te = port_engine(ckpt, steps, asy, eos=eos[0])
    preempted = []

    def watch(streams):
        preempted.extend(s for s in streams
                         if s.state.value == "waiting" and s.output_token_ids)
    got = run(te, reqs, GenerateConfig, watch=watch)
    assert preempted, "the pool must be small enough to preempt"
    assert [s.output_token_ids for s in got] == [s.output_token_ids for s in want]
    drain_and_check_no_leak(te)


def reference_kv(te, token_ids):
    """K and V of ``token_ids`` from one prefill into a fresh pool:
    ``[L, 2, T, Hkv*D]``."""
    t = len(token_ids)
    nb = -(-t // BS)
    cache = te.model.init_cache(nb + 1, BS, te.kv.dtype)
    inputs = ModelInputs(
        tokens=te.kv.new_tensor(token_ids).long()[None],
        positions=te.kv.new_tensor(list(range(t))).int()[None],
        block_tables=te.kv.new_tensor(list(range(1, nb + 1))).int()[None],
        kv_lens=te.kv.new_tensor([t]).int(), q_offsets=te.kv.new_tensor([0]).int())
    te.model.forward(te.weights, cache, inputs)
    return cache[:, :, BS: BS + t]


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
def test_prefix_reuse_after_mid_window_finish_matches_jax(ckpt, eos, jax_engines, steps, asy):
    """A stream that stops inside a window (index 6 of 7 tokens) offers its
    blocks to the prefix cache on release; a second request reuses them.
    The blocks offered hold only KV that was written: every cached slot
    equals a fresh prefill of the same tokens, and no block past the
    context (the overshoot's rows) is cached. The reuse gives the JAX
    engine's tokens."""
    prompt = [11, 12, 13, 14, 15, 16, 17, 18, 19, 20]
    je = jax_engines(steps, asy)
    te = port_engine(ckpt, steps, asy, eos=eos[0])
    want_a = run(je, [(prompt, greedy(7))], JGen)[0]
    a = run(te, [(prompt, greedy(7))], GenerateConfig)[0]
    assert a.output_token_ids == want_a.output_token_ids
    drain_and_check_no_leak(te)

    ctx = a.context_token_ids  # 16 tokens: 4 full blocks
    blocks = te.cache_mgr.prefix_cache.match(a.all_token_ids + [0], BS)
    assert len(blocks) == len(ctx) // BS == 4
    slots = [b * BS + i for b in blocks for i in range(BS)]
    ref = reference_kv(te, ctx)
    got = te.kv[:, :, slots]
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())

    second = a.all_token_ids + [5]
    want_b = run(je, [(second, greedy(5))], JGen)[0]
    b = run(te, [(second, greedy(5))], GenerateConfig)[0]
    assert b.reuse_len == 16
    assert b.output_token_ids == want_b.output_token_ids
    drain_and_check_no_leak(te)


@pytest.mark.parametrize("asy", [False, True], ids=["sync", "async"])
def test_sampled_multi_step_matches_single(ckpt, asy):
    """Port of tests/test_engine.py:371's sampled case: one seed, the same
    draws in the same order, so decode_steps 4 and 1 give the same tokens."""
    kw = dict(max_new_tokens=10, do_sample=True, temperature=0.8, top_k=8, ignore_eos=True)
    outs = [port_engine(ckpt, steps, asy).generate([1, 5, 9, 42, 7], GenerateConfig(**kw))
            for steps in (1, 4)]
    assert outs[0].output_token_ids == outs[1].output_token_ids
    assert len(set(outs[0].output_token_ids)) > 1


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
def test_max_seq_len_boundary_matches_single_step_jax(ckpt, steps, asy):
    """Streams that run into max_seq_len beside shorter ones: the port at
    every configuration gives the JAX engine's single-step synchronous
    tokens, never asks for more blocks than a row holds, and holds a block
    for every position it writes."""
    msl = 24
    # prompts of every length mod 4: at the first single step after a window
    # of 4, one of them crosses into a block that only the window in flight
    # accounts for
    reqs = [([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], greedy(100)), ([7, 7, 8, 9], greedy(40)),
            ([2, 7, 1, 8, 2, 8, 1], greedy(40)), ([1, 6, 1, 8, 0], greedy(40))]
    want = run(jax_engine(ckpt, 1, False, num_blocks=64, max_seq_len=msl), reqs, JGen)
    te = port_engine(ckpt, steps, asy, num_blocks=64, max_seq_len=msl)
    got = run(te, reqs, GenerateConfig, watch=blocks_cover_writes(te))
    assert [s.output_token_ids for s in got] == [s.output_token_ids for s in want]
    assert [s.total_len for s in got] == [msl] * 4
    drain_and_check_no_leak(te)


def test_reference_multi_step_async_overruns_the_block_row(ckpt):
    """The JAX engine's fault at the same boundary (ROADMAP section C): with
    decode_steps 4 and async decode it grows a stream by its stale host
    length plus 2N - 1 and asks for more blocks than max_seq_len allows."""
    reqs = [([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], greedy(100)), ([7, 7, 8], greedy(40))]
    with pytest.raises(ValueError, match="could not broadcast"):
        run(jax_engine(ckpt, 4, True, num_blocks=64, max_seq_len=24), reqs, JGen)


def test_has_work_while_window_pending(ckpt):
    """A window in flight is work: the engine loop must step until it is
    read back, even when the scheduler has nothing left."""
    te = port_engine(ckpt, 1, True)
    s = te.enqueue([1, 2, 3], GenerateConfig(**greedy(3)))
    seen_pending = False
    while not s.is_finished():
        te.step()
        seen_pending |= te._pending is not None
    assert seen_pending and te._pending is not None  # the overshoot window
    te.scheduler.schedule()  # drops the finished stream, as the next step would
    assert not te.scheduler.has_work()
    assert te.has_work()
    te.step()
    assert te._pending is None and not te.has_work()
    assert len(s.output_token_ids) == 3


def test_warmup_covers_serving_keys(ckpt):
    """Port of tests/test_engine.py:755: after warmup(), a serving pass
    (greedy and sampled, rows crossing kv buckets, single steps near
    max_seq_len) dispatches no need_stats=False window that warmup did not
    ready; the stats windows are readied at first use."""
    te = port_engine(ckpt, 4, True, num_blocks=64, max_seq_len=48)
    te.warmup()
    assert te.warm_keys == {WindowKey(kvb, ns, False, n, False) for kvb in (8, 12)
                            for ns in (False, True) for n in (1, 4)}
    reqs = [([1, 2, 3, 4], greedy(44)), ([5, 6, 7], greedy(10)),
            ([9, 8], dict(max_new_tokens=20, do_sample=True, temperature=0.7, top_k=5)),
            ([4, 4, 4], greedy(6, return_logprobs=True))]
    run(te, reqs, GenerateConfig)
    drain_and_check_no_leak(te)
    plain = {k for k in te.decode_keys if not k[2]}
    assert plain <= te.warm_keys
    assert {k[0] for k in plain} == {8, 12} and {k[3] for k in plain} == {1, 4}
    assert any(k[2] for k in te.decode_keys)
