"""Served greedy tokens of the mixture-of-experts trunks: the port's engine
beside the JAX engine on the CPU (f32, the checkpoints of
``tests/test_torch_moe.py``: JAX fake qwen2_moe with a shared expert and
qwen3_moe, HF-written mixtral; the same files on both sides).

Four streams served together, then the longest prompt again behind its
cached prefix, at ``decode_steps`` 1 and at 4 with async decode (the window
body the card's decode graphs capture); prompt lookup (verify windows over
the experts); beam search (served as on a dense trunk); LoRA refused.
"""

import os

import numpy as np
import pytest
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.engine_config import SpeculativeConfig as JSpec
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig, SpeculativeConfig,
)
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.lora import LoraManager
from rtp_llm_tpu_torch.models import LlamaFamilyModel
from rtp_llm_tpu_torch.ops import moe as tmoe
from tests.test_torch_lora import write_fake_adapter
from tests.test_torch_moe import jax_config, port_config, write_hf_moe, write_jax_moe

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

BS = 4
NB, BATCH, MSL = 96, 4, 128
_rng = np.random.default_rng(9)
LONG = [int(t) for t in _rng.integers(3, 120, 40)]
PROMPT = [int(t) for t in _rng.integers(3, 120, 12)]
REQS = [(LONG, 8), (PROMPT[:5], 8), (PROMPT, 6), (LONG[3:20], 7)]
CKPTS = ("jax_qwen2_moe", "jax_qwen3_moe", "hf_mixtral")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moe_engine"))
    return {"jax_qwen2_moe": write_jax_moe(os.path.join(root, "q2"), "qwen2_moe"),
            "jax_qwen3_moe": write_jax_moe(os.path.join(root, "q3"), "qwen3_moe"),
            "hf_mixtral": write_hf_moe(os.path.join(root, "mx"), "mixtral")}


def _port(path, prefix=True, steps=1, asy=False, spec="none"):
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64),
                                  decode_steps=steps, async_decode=asy),
        quant=QuantConfig(kv_cache_dtype="float32"),
        speculative=SpeculativeConfig(method=spec, draft_tokens=3))
    cfg = port_config(path)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"),
                     TLoader(cfg, device="cpu").load(path), econf, device="cpu")


def _jax(path, prefix=True, steps=1, asy=False, spec="none"):
    jconf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64),
                         decode_steps=steps, async_decode=asy),
        speculative=JSpec(method=spec, draft_tokens=3))
    jconf.quant.kv_cache_dtype = "float32"
    cfg = jax_config(path)
    return JEngine(create_model(cfg), JLoader(cfg).load(path), jconf)


def _serve(engine, reqs, gen_cls, **kw):
    streams = [engine.enqueue(p, gen_cls(max_new_tokens=n, do_sample=False, ignore_eos=True,
                                         **kw)) for p, n in reqs]
    for _ in range(400):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
    assert all(s.is_finished() for s in streams)
    return streams


@pytest.mark.parametrize("steps,asy", [(1, False), (4, True)], ids=["steps1", "steps4_async"])
@pytest.mark.parametrize("ckpt", CKPTS)
def test_served_tokens_match_jax_engine(ckpts, ckpt, steps, asy):
    """Greedy tokens of four streams served together, then the long prompt
    alone behind its cached prefix, equal the JAX engine's; the experts ran
    on every forward (the CPU's plain products)."""
    path = ckpts[ckpt]
    te, je = _port(path, steps=steps, asy=asy), _jax(path, steps=steps, asy=asy)
    n0 = tmoe.PLAIN_CALLS.n
    for reqs in (REQS, [(LONG, 5)]):
        got = [s.output_token_ids for s in _serve(te, reqs, GenerateConfig)]
        want = [list(s.output_token_ids) for s in _serve(je, reqs, JGen)]
        assert got == want
    again = _serve(te, [(LONG + [7, 8], 2)], GenerateConfig)[0]
    assert again.reuse_len > 0
    assert tmoe.PLAIN_CALLS.n > n0


@pytest.mark.parametrize("ckpt", ["jax_qwen2_moe", "hf_mixtral"])
def test_prompt_lookup_matches_jax(ckpts, ckpt):
    """Prompt lookup (K 3): the verify windows run the experts at every
    drafted position; tokens equal the JAX engine's and verify steps ran."""
    path = ckpts[ckpt]
    te, je = _port(path, spec="prompt_lookup"), _jax(path, spec="prompt_lookup")
    reqs = [((PROMPT[:6] * 4)[:20], 10), (LONG[:12] * 2, 10)]
    got = [s.output_token_ids for s in _serve(te, reqs, GenerateConfig)]
    want = [list(s.output_token_ids) for s in _serve(je, reqs, JGen)]
    assert got == want
    assert te.spec_stats["steps"] > 0


@pytest.mark.parametrize("beams", [2, 3])
def test_beams_match_jax(ckpts, beams):
    """Beam search on qwen3_moe: the best hypothesis equals the JAX
    engine's."""
    path = ckpts["jax_qwen3_moe"]
    te, je = _port(path), _jax(path)
    got = _serve(te, [(PROMPT, 6)], GenerateConfig, num_beams=beams)[0]
    want = _serve(je, [(PROMPT, 6)], JGen, num_beams=beams)[0]
    assert got.output_token_ids == list(want.output_token_ids)


@pytest.mark.parametrize("route", ["dynamic", "static"])
def test_lora_is_refused(ckpts, tmp_path, route):
    """A dynamic adapter is refused before the weights change, a static one
    (``--server-lora-adapters``) before the checkpoint is read."""
    path = ckpts["jax_qwen3_moe"]
    adapter = write_fake_adapter(str(tmp_path / "a"), targets=("q_proj",))
    if route == "static":
        from rtp_llm_tpu_torch.server.server import build_engine

        econf = EngineConfig()
        econf.server.lora_adapters = f"a={adapter}"
        with pytest.raises(ValueError, match="ROADMAP A11"):
            build_engine(path, econf, device="cpu", dtype="float32")
        return
    te = _port(path)
    mgr = LoraManager(port_config(path).num_layers)
    mgr.add_adapter(adapter, "a")
    with pytest.raises(ValueError, match="ROADMAP A11"):
        te.set_lora_manager(mgr)
    assert not any(".lora_" in n for n in te.weights)
