"""Port engine on a quantized KV pool vs the JAX ``LlmEngine``, on the CPU.

Mirrors tests/test_e2e_generate.py (fp8 / int8 / int8 + deferred writes) and
tests/test_engine.py (deferred writes match in-layer writes): both engines
load the same fake checkpoint with their own loaders, f32 weights, and
generate greedily. Token sequences must be equal: both sides quantize the
same values the same way, and a 1e-6 difference in an f32 activation moves a
greedy token only through a near-tie of the top two logits. Also: prefix
reuse, chunked prefill, batching and preemption-recompute on an int8 pool, the
batched deferred scatter against the reference's, KV auto-sizing, CLI flags.
"""

import dataclasses
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import QuantConfig as JQuant
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu_torch import cli
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.config.model_config import llama3_8b_config
from rtp_llm_tpu_torch.convert import cache_from_jax
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel
from rtp_llm_tpu_torch.ops.kv_cache import storage_view
from rtp_llm_tpu_torch.server.server import build_engine

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

PROMPT = [1, 5, 9, 42, 7]


def jax_engine(ckpt, kv_dtype, defer=False, mt="qwen2"):
    cfg = tiny_config(mt, dtype="float32")
    econf = JEngineConfig(
        cache=JCache(block_size=4, test_num_blocks=64),
        scheduler=JSched(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 64),
                         defer_kv_writes=defer))
    econf.quant.kv_cache_dtype = kv_dtype
    return JEngine(create_model(cfg), JLoader(cfg).load(ckpt), econf)


def port_engine(ckpt, kv_dtype, defer=False, num_blocks=64, **sched):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    sched = {**dict(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 64),
                    defer_kv_writes=defer), **sched}
    econf = EngineConfig(
        quant=QuantConfig(kv_cache_dtype=kv_dtype),
        cache=CacheConfig(block_size=4, num_blocks=num_blocks,
                          enable_prefix_cache=sched.pop("prefix_cache", True)),
        scheduler=SchedulerConfig(**sched))
    weights = CheckpointLoader(cfg, device="cpu").load(ckpt)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), weights, econf, device="cpu")


def greedy(n, cls=GenerateConfig):
    return cls(max_new_tokens=n, do_sample=False, ignore_eos=True)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("kvq")), tiny_config("qwen2"))


# ---- greedy generation against the JAX engine ----


@pytest.mark.parametrize("kv_dtype,defer", [
    ("int8", False), ("fp8", False), ("int8", True), ("fp8", True), ("float32", True),
    ("float8_e4m3", False)])
def test_greedy_matches_jax(ckpt, kv_dtype, defer):
    je, te = jax_engine(ckpt, kv_dtype, defer), port_engine(ckpt, kv_dtype, defer)
    assert te._defer_decode == je._defer_decode == defer
    want = je.generate(PROMPT, greedy(12, JGen)).output_token_ids
    got = te.generate(PROMPT, greedy(12))
    assert got.output_token_ids == want
    assert got.finish_reason.value == "length"


@pytest.mark.parametrize("kv_dtype,defer", [("int8", False), ("int8", True), ("fp8", False)])
def test_quantized_kv_stays_close_to_f32_kv(ckpt, kv_dtype, defer):
    """As the JAX package's quality tests: at most two of eight greedy
    tokens differ from the f32-pool run."""
    ref = port_engine(ckpt, "float32").generate(PROMPT, greedy(8)).output_token_ids
    got = port_engine(ckpt, kv_dtype, defer).generate(PROMPT, greedy(8)).output_token_ids
    assert sum(a == b for a, b in zip(ref, got)) >= len(ref) - 2, (ref, got)


def test_deferred_writes_match_in_layer_writes_exactly(ckpt):
    """With an unquantized pool the deferred step computes what the in-layer
    step computes (tests/test_engine.py::test_deferred_kv_writes_match)."""
    ref = port_engine(ckpt, "float32").generate(PROMPT, greedy(10)).output_token_ids
    eng = port_engine(ckpt, "float32", defer=True)
    assert eng._defer_decode
    assert eng.generate(PROMPT, greedy(10)).output_token_ids == ref


@pytest.mark.parametrize("kv_dtype,defer", [("int8", False), ("int8", True), ("fp8", False)])
def test_prefix_reuse_on_quantized_pool(ckpt, kv_dtype, defer):
    """Block ids are blind to the pool's type: a longer prompt reuses the
    first stream's blocks and reads them back quantized."""
    je, te = jax_engine(ckpt, kv_dtype, defer), port_engine(ckpt, kv_dtype, defer)
    for eng, cls in ((je, JGen), (te, GenerateConfig)):
        eng.generate(PROMPT, greedy(12, cls))
    want = je.generate(PROMPT + [100, 3], greedy(6, JGen))
    got = te.generate(PROMPT + [100, 3], greedy(6))
    assert got.reuse_len > 0 and got.reuse_len == want.reuse_len
    assert got.output_token_ids == want.output_token_ids


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_chunked_prefill_reads_earlier_chunk_quantized(ckpt, kv_dtype):
    prompt = list(range(1, 90))  # > the 64-token bucket: two chunks
    want = jax_engine(ckpt, kv_dtype).generate(prompt, greedy(5, JGen)).output_token_ids
    assert port_engine(ckpt, kv_dtype).generate(prompt, greedy(5)).output_token_ids == want


@pytest.mark.parametrize("defer", [False, True], ids=["in_layer", "deferred"])
def test_batched_matches_sequential_on_int8_pool(ckpt, defer):
    """Several rows of different depths in one decode batch (the block-table
    bucket follows the deepest), inactive slots beside them."""
    prompts = [[1, 5, 9], [42, 7], list(range(3, 40))]
    seq = [port_engine(ckpt, "int8", defer).generate(p, greedy(6)).output_token_ids
           for p in prompts]
    eng = port_engine(ckpt, "int8", defer)
    streams = [eng.enqueue(p, greedy(6)) for p in prompts]
    for _ in range(100):
        if all(s.is_finished() for s in streams):
            break
        eng.step()
    assert [s.output_token_ids for s in streams] == seq
    assert eng.cache_mgr.pool.used_blocks == len(eng.cache_mgr.prefix_cache)  # no leak


@pytest.mark.parametrize("defer", [False, True], ids=["in_layer", "deferred"])
def test_preemption_recomputes_on_int8_pool(ckpt, defer):
    """A pool too small for two streams preempts the newer one; its context
    is prefilled again (quantized again) and it ends with the tokens of an
    unconstrained run."""
    prompts = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8])
    eng = port_engine(ckpt, "int8", defer, num_blocks=16, max_batch_size=2,
                      watermark_frac=0.0, prefix_cache=False)
    a, b = (eng.enqueue(p, greedy(40)) for p in prompts)
    preempted = False
    for _ in range(300):
        if a.is_finished() and b.is_finished():
            break
        eng.step()
        preempted |= any(s.state.value == "waiting" and s.output_token_ids for s in (a, b))
    assert preempted, "test setup must actually trigger preemption"
    solo = [port_engine(ckpt, "int8", defer).generate(p, greedy(40)).output_token_ids
            for p in prompts]
    assert [a.output_token_ids, b.output_token_ids] == solo


# ---- the batched deferred scatter ----


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "fp8"])
def test_apply_kv_writes_matches_reference(ckpt, kv_dtype):
    """One step's rows of every layer into the pool: the port's in-place
    scatter against the reference's, from the same pool, with an inactive
    row (dropped) between two active ones. Pools equal bit for bit."""
    je, te = jax_engine(ckpt, kv_dtype, True), port_engine(ckpt, kv_dtype, True)
    rng = np.random.default_rng(41)
    l, b, hd = 2, 4, 32
    fill = lambda a: rng.standard_normal(a.shape).astype(np.float32)
    if kv_dtype == "int8":
        je.kv = {"data": jnp.asarray(rng.integers(-127, 128, je.kv["data"].shape), jnp.int8),
                 "scale": jnp.asarray(np.abs(fill(je.kv["scale"])), jnp.bfloat16)}
        pool = {k: np.asarray(v) for k, v in je.kv.items()}
    else:
        je.kv = jnp.asarray(fill(je.kv)).astype(je.kv.dtype)
        pool = np.asarray(je.kv)
    te.kv = cache_from_jax(pool, device="cpu")
    kw, vw = (rng.standard_normal((l, b, hd)).astype(np.float32) * 2 for _ in range(2))
    kv_lens = np.asarray([5, 0, 11, 4], np.int32)  # before the step; row 1 inactive
    bt = np.zeros((b, 8), np.int32)
    bt[0, :2], bt[2, :3], bt[3, :2] = [3, 9], [5, 6, 7], [12, 2]
    state = types.SimpleNamespace(kv_lens=jnp.asarray(kv_lens), block_tables=jnp.asarray(bt))
    want = je._apply_kv_writes(je.kv, (jnp.asarray(kw), jnp.asarray(vw)), state,
                               jnp.asarray(kv_lens > 0))
    te._apply_kv_writes((torch.from_numpy(kw), torch.from_numpy(vw)),
                        torch.from_numpy(kv_lens), torch.from_numpy(bt),
                        torch.from_numpy(kv_lens > 0))
    want = cache_from_jax({k: np.asarray(v) for k, v in want.items()}
                          if isinstance(want, dict) else np.asarray(want), device="cpu")
    pairs = ([(te.kv[k], want[k]) for k in ("data", "scale")] if kv_dtype == "int8"
             else [(te.kv, want)])
    before = cache_from_jax(pool, device="cpu")
    for got, exp in pairs:
        assert torch.equal(storage_view(got), storage_view(exp))
    data, old = (te.kv["data"], before["data"]) if kv_dtype == "int8" else (te.kv, before)
    changed = (storage_view(data) != storage_view(old)).any(dim=-1)  # [L, 2, NS]
    assert int(changed.sum()) <= l * 2 * 3 and bool(changed.any())
    assert not bool(changed[:, :, :4].any())  # the null block, where invalid rows go


def test_apply_kv_writes_all_inactive_leaves_pool_untouched(ckpt):
    te = port_engine(ckpt, "int8", True)
    te.kv["data"].random_(-127, 128)
    te.kv["scale"].uniform_(0, 1)
    before = {k: v.clone() for k, v in te.kv.items()}
    rows = torch.randn(2, 4, 32)
    te._apply_kv_writes((rows, rows), torch.zeros(4, dtype=torch.int32),
                        torch.zeros((4, 8), dtype=torch.int32), torch.zeros(4, dtype=torch.bool))
    assert all(torch.equal(te.kv[k], before[k]) for k in before)


# ---- sizing, config, CLI ----


@pytest.mark.parametrize("kv_dtype,per_head", [("bfloat16", 16 * 2), ("float32", 16 * 4),
                                               ("fp8", 16), ("int8", 16 + 2)])
def test_kv_block_bytes_count_the_scales(ckpt, kv_dtype, per_head):
    """An int8 block is its data plus one bf16 scale per (slot, kv head),
    for K and for V; the pool a block count allocates weighs exactly that."""
    eng = port_engine(ckpt, kv_dtype)
    mc = eng.model.cfg
    assert eng.kv_block_bytes() == 2 * mc.num_layers * 4 * mc.num_kv_heads * per_head
    tensors = eng.kv.values() if isinstance(eng.kv, dict) else [eng.kv]
    assert sum(t.numel() * t.element_size() for t in tensors) == 64 * eng.kv_block_bytes()


def test_auto_sized_int8_pool_stays_inside_its_budget(ckpt):
    bf16 = port_engine(ckpt, "bfloat16", num_blocks=0)
    i8 = port_engine(ckpt, "int8", num_blocks=0)
    budget = 256 << 20  # the CPU engine's fixed budget
    assert i8.num_blocks * i8.kv_block_bytes() <= budget
    assert (i8.num_blocks + 1) * i8.kv_block_bytes() > budget
    # 16 data bytes + 2 scale bytes against 32: 16/9 of the bf16 pool's tokens
    assert i8.num_blocks == budget // i8.kv_block_bytes()
    assert abs(i8.num_blocks / bf16.num_blocks - 32 / 18) < 1e-3


def test_kv_cache_dtype_lives_on_quant_config():
    names = lambda cls: {f.name for f in dataclasses.fields(cls)}
    assert "kv_cache_dtype" in names(QuantConfig)
    assert "kv_cache_dtype" not in names(EngineConfig)
    assert QuantConfig().kv_cache_dtype == JQuant().kv_cache_dtype == "bfloat16"
    assert SchedulerConfig().defer_kv_writes is JSched().defer_kv_writes is False


@pytest.mark.parametrize("argv,kv_dtype,defer", [
    ([], "bfloat16", False),
    (["--kv-cache-dtype", "int8", "--defer-kv-writes"], "int8", True),
    (["--kv-cache-dtype", "fp8"], "fp8", False)])
def test_cli_flags_reach_the_config(argv, kv_dtype, defer):
    conf = cli.config_from_args(cli.parse_args(["serve", "/nowhere", *argv]))
    assert conf.quant.kv_cache_dtype == kv_dtype
    assert conf.scheduler.defer_kv_writes is defer


def test_build_engine_takes_the_quantized_config(ckpt):
    conf = EngineConfig(
        quant=QuantConfig(kv_cache_dtype="int8"),
        cache=CacheConfig(block_size=4, num_blocks=32),
        scheduler=SchedulerConfig(max_batch_size=2, max_seq_len=64, prefill_buckets=(16,),
                                  defer_kv_writes=True))
    eng = build_engine(ckpt, conf, device="cpu", dtype="float32")
    assert isinstance(eng.kv, dict) and eng.kv["data"].dtype == torch.int8 and eng._defer_decode
    assert len(eng.generate(PROMPT, greedy(4)).output_token_ids) == 4


def test_llama3_8b_config_is_the_published_one():
    c = llama3_8b_config()
    assert (c.model_type, c.hidden_size, c.num_layers, c.num_attention_heads, c.num_kv_heads,
            c.head_dim, c.intermediate_size, c.vocab_size) == (
        "llama", 4096, 32, 32, 8, 128, 14336, 128256)
    assert c.rope_theta == 500000.0 and c.rms_norm_eps == 1e-5
    assert not c.attention_bias and not c.tie_word_embeddings
