"""Port engine vs the JAX ``LlmEngine``: greedy generation token for token.

Mirrors tests/test_e2e_generate.py:48 (prefix reuse with reuse_len > 0) and
:70 (batched equals sequential) on the CPU, f32 weights and KV, both engines
loading the same fake checkpoint with their own loaders.
"""

import dataclasses

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
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel


def jax_engine(mt, ckpt):
    cfg = tiny_config(mt, dtype="float32")
    econf = JEngineConfig(
        cache=JCache(block_size=4, test_num_blocks=64),
        scheduler=JSched(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 64)))
    econf.quant.kv_cache_dtype = "float32"
    return JEngine(create_model(cfg), JLoader(cfg).load(ckpt), econf)


def port_engine(ckpt, **sched):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    econf = EngineConfig(
        cache=CacheConfig(block_size=4, num_blocks=64),
        scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=256,
                                  prefill_buckets=(16, 64), **sched),
        quant=QuantConfig(kv_cache_dtype="float32"))
    weights = CheckpointLoader(cfg, device="cpu").load(ckpt)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), weights, econf, device="cpu")


def greedy(n, cls=GenerateConfig):
    return cls(max_new_tokens=n, do_sample=False, ignore_eos=True)


@pytest.fixture(scope="module")
def qwen2_ckpt(tmp_path_factory):
    cfg = tiny_config("qwen2")
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("q2")), cfg)


def test_greedy_matches_jax_with_prefix_reuse(qwen2_ckpt):
    prompt = [1, 5, 9, 42, 7]
    je, te = jax_engine("qwen2", qwen2_ckpt), port_engine(qwen2_ckpt)
    want = je.generate(prompt, greedy(12, JGen)).output_token_ids
    got = te.generate(prompt, greedy(12))
    assert got.output_token_ids == want
    assert got.finish_reason.value == "length"

    # prefix-cache path: a longer prompt reuses the first stream's blocks
    want2 = je.generate(prompt + [100, 3], greedy(6, JGen))
    got2 = te.generate(prompt + [100, 3], greedy(6))
    assert got2.output_token_ids == want2.output_token_ids
    assert got2.reuse_len > 0 and got2.reuse_len == want2.reuse_len


def test_batched_matches_sequential_and_jax(tmp_path):
    ckpt = write_fake_checkpoint(str(tmp_path / "q3"), tiny_config("qwen3"))
    prompts = [[1, 5, 9], [42, 7], [100, 3, 55, 8]]
    je = jax_engine("qwen3", ckpt)
    want = [je.generate(p, greedy(6, JGen)).output_token_ids for p in prompts]
    seq = [port_engine(ckpt).generate(p, greedy(6)).output_token_ids for p in prompts]
    assert seq == want
    eng = port_engine(ckpt)
    streams = [eng.enqueue(p, greedy(6)) for p in prompts]
    for _ in range(100):
        if all(s.is_finished() for s in streams):
            break
        eng.step()
    assert [s.output_token_ids for s in streams] == want
    assert eng.cache_mgr.pool.used_blocks == len(eng.cache_mgr.prefix_cache)  # no leak


def test_chunked_prefill_matches_jax(qwen2_ckpt):
    """A prompt longer than the largest bucket prefills in chunks."""
    prompt = list(range(1, 90))  # > 64-token bucket
    want = jax_engine("qwen2", qwen2_ckpt).generate(prompt, greedy(5, JGen))
    assert port_engine(qwen2_ckpt).generate(prompt, greedy(5)).output_token_ids == \
        want.output_token_ids


def test_preemption_recomputes_exactly(qwen2_ckpt):
    """A pool too small for two streams' peaks preempts the newer one, which
    recomputes its context and continues with the same greedy tokens as an
    unconstrained run."""
    cfg = TConfig.from_pretrained(qwen2_ckpt)
    cfg.dtype = "float32"
    econf = EngineConfig(
        # 15 usable blocks; each stream peaks at 12: both are admitted, and
        # growing them preempts the newer one
        cache=CacheConfig(block_size=4, num_blocks=16, enable_prefix_cache=False),
        scheduler=SchedulerConfig(max_batch_size=2, max_seq_len=256,
                                  prefill_buckets=(16, 64), watermark_frac=0.0),
        quant=QuantConfig(kv_cache_dtype="float32"))
    eng = LlmEngine(LlamaFamilyModel(cfg, device="cpu"),
                    CheckpointLoader(cfg, device="cpu").load(qwen2_ckpt), econf, device="cpu")
    a = eng.enqueue([3, 1, 4, 1, 5, 9, 2, 6], greedy(40))
    b = eng.enqueue([2, 7, 1, 8, 2, 8], greedy(40))
    preempted = False
    for _ in range(300):
        if a.is_finished() and b.is_finished():
            break
        eng.step()
        preempted |= any(s.state.value == "waiting" and s.output_token_ids for s in (a, b))
    assert preempted, "test setup must actually trigger preemption"
    assert len(a.output_token_ids) == 40 and len(b.output_token_ids) == 40
    solo = [port_engine(qwen2_ckpt).generate(p, greedy(40)).output_token_ids
            for p in ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8])]
    assert [a.output_token_ids, b.output_token_ids] == solo


def test_engine_config_subset_matches_jax_defaults():
    """The port's config groups keep the JAX defaults they copy."""
    for tcls, jcls in ((CacheConfig, JCache), (SchedulerConfig, JSched)):
        jdef = jcls()
        for f in dataclasses.fields(tcls):
            assert getattr(tcls(), f.name) == getattr(jdef, f.name), f.name
