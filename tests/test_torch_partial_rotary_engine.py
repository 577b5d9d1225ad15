"""Served greedy tokens of the partial-rotary families: the port's engine
beside the JAX engine on the CPU (f32, the tiny checkpoints of
``tests/test_torch_partial_rotary.py``, the same parameters on both sides).

Four streams served together, then the longest prompt again behind its
cached prefix: phi (RoPE in neox halves over 0.4 of a 20-dim head) with the
prefix cache on and off, on int8 and fp8 pools and at ``decode_steps`` 4
with async decode; glm4 (GPT-J pairs over half the head, G 2, sandwich
norms); chatglm (pairs, G 2); gpt_neox in its parallel and sequential forms
(halves over a quarter); qwen v1 (full-head RoPE). Prompt lookup on phi.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.engine_config import SpeculativeConfig as JSpec
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig, SpeculativeConfig,
)
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.models import LlamaFamilyModel
from tests.test_torch_mqa_families import _greedy, _serve
from tests.test_torch_partial_rotary import (  # noqa: F401 (the module's fixtures)
    BS, PROMPT, ckpts, jax_config, loaded, port_config,
)

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

LONG = [(7 * i + 3) % 90 + 1 for i in range(30)]
NB, BATCH, MSL = 64, 4, 64


def _port_engine(path, weights, prefix=True, kv="float32", steps=1, asy=False, spec="none"):
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64),
                                  decode_steps=steps, async_decode=asy),
        quant=QuantConfig(kv_cache_dtype=kv),
        speculative=SpeculativeConfig(method=spec, draft_tokens=3))
    return LlmEngine(LlamaFamilyModel(port_config(path), device="cpu"), dict(weights), econf,
                     device="cpu")


def _jax_engine(path, jw, prefix=True, kv="float32", steps=1, asy=False, spec="none"):
    jconf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64),
                         decode_steps=steps, async_decode=asy),
        speculative=JSpec(method=spec, draft_tokens=3))
    jconf.quant.kv_cache_dtype = kv
    return JEngine(create_model(jax_config(path)), jw, jconf)


REQS = [(LONG, _greedy(8)), (PROMPT[:5], _greedy(8)), (PROMPT, _greedy(6)),
        (LONG[3:20], _greedy(7))]
# (form, engine kwargs) of each served case
SERVED = {"phi_prefix_on": ("phi", {}), "phi_prefix_off": ("phi", dict(prefix=False)),
          "phi_int8_pool": ("phi", dict(kv="int8")), "phi_fp8_pool": ("phi", dict(kv="fp8")),
          "phi_steps4_async": ("phi", dict(steps=4, asy=True)),
          "glm4_prefix_on": ("glm4", {}), "chatglm_prefix_on": ("chatglm", {}),
          "neox_parallel_prefix_on": ("neox_parallel", {}),
          "neox_sequential_prefix_off": ("neox_sequential", dict(prefix=False)),
          "qwen_prefix_on": ("qwen", {})}


@pytest.mark.parametrize("case", sorted(SERVED))
def test_served_tokens_match_jax_engine(case, ckpts, loaded):
    """Greedy tokens of four streams served together, then the long prompt
    alone (behind its cached prefix where the cache is on), equal the JAX
    engine's on the JAX parameters carried over."""
    form, kw = SERVED[case]
    path = ckpts[form]
    _, jw = loaded[form]
    tw = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    te, je = _port_engine(path, tw, **kw), _jax_engine(path, jw, **kw)
    for r in (REQS, REQS[:1]):
        assert _serve(te, r, GenerateConfig) == _serve(je, r, JGen)
    if kw.get("prefix", True):
        again = te.enqueue(LONG, GenerateConfig(**_greedy(2)))
        while not again.is_finished():
            te.step()
        assert again.reuse_len > 0


def test_prompt_lookup_on_phi_matches_jax(ckpts, loaded):
    """Prompt-lookup speculation (K 3) on phi: the verify window runs the
    partial rotation at each drafted position; tokens equal the JAX
    engine's and verify steps ran."""
    path = ckpts["phi"]
    _, jw = loaded["phi"]
    tw = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    te = _port_engine(path, tw, spec="prompt_lookup")
    je = _jax_engine(path, jw, spec="prompt_lookup")
    rep = (PROMPT[:6] * 4)[:20]
    reqs = [(rep, _greedy(10)), (LONG[:12] * 2, _greedy(10))]
    assert _serve(te, reqs, GenerateConfig) == _serve(je, reqs, JGen)
    assert te.spec_stats["steps"] > 0


def test_rope_table_caps_max_seq_len(ckpts, loaded):
    """A RoPE model's cos / sin tables hold ``max_position_embeddings``
    rows (Phi-2 and GPT-NeoX-20B: 2048, below the scheduler's default
    8192): an engine caps ``max_seq_len`` there, as for learned positions,
    so a longer prompt is refused with the scheduler's error and a stream
    stops at the table's end, where the gather would fault the card (the
    JAX package clamps the position to the table's last row: an expected
    divergence, ROADMAP C). An ALiBi model has no table and keeps its
    ``max_seq_len``."""
    path = ckpts["phi"]
    _, jw = loaded["phi"]
    tw = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    econf = EngineConfig(cache=CacheConfig(block_size=BS, num_blocks=80),
                         scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=512,
                                                   prefill_buckets=(16, 64)),
                         quant=QuantConfig(kv_cache_dtype="float32"))
    cfg = port_config(path)
    assert cfg.max_position_embeddings == 256
    engine = LlmEngine(LlamaFamilyModel(cfg, device="cpu"), dict(tw), econf, device="cpu")
    assert engine.config.scheduler.max_seq_len == 256
    long = engine.enqueue([i % 100 + 1 for i in range(257)], GenerateConfig(max_new_tokens=2))
    engine.step()
    assert long.is_finished() and "max_seq_len" in long.error
    got = _serve(engine, [(LONG, _greedy(300))], GenerateConfig)[0]
    assert len(LONG) + len(got) == 256
    alibi = dataclasses.replace(cfg, use_alibi=True)
    assert LlmEngine(LlamaFamilyModel(alibi, device="cpu"), dict(tw), econf,
                     device="cpu").config.scheduler.max_seq_len == 512
