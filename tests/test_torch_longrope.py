"""Phi-3's ``longrope`` tables in the port against HF's ``Phi3ForCausalLM``
(the oracle; the JAX package computes unscaled tables for the type, C7), on
the CPU in f32.

Setup: a tiny Phi-3 (H 64, 2 layers, 4 / 2 heads of 16, ``max_position_
embeddings`` 256, ``original_max_position_embeddings`` 64, short / long
factor lists drawn from a seeded generator) written by HF with every
parameter redrawn at std 0.15, read by the port's loader.

* The config: the top-level original length lands in the longrope block;
  the model keeps both tables; the switch is at 64.
* Logits of one forward against HF's on both sides of the switch (prompts
  of 50 and 100 tokens) within 1e-5; the JAX package's unscaled tables miss
  HF's on the long side (pinned).
* The switch is per stream: a packed prefill of both prompts gives each
  row HF's logits of its prompt alone; a chunked prefill rotates every
  chunk by the whole prompt's table.
* Served greedy tokens (the engine, eager windows on the CPU: the body the
  card's decode graphs capture) equal those of HF's model stepped over one
  KV cache for each prompt alone (``hf_greedy``: cached keys keep the table
  they were written with): a stream that prefills short and decodes past
  the switch, one that prefills long, one that stays short, served together
  at ``decode_steps`` 1 and 4 with async decode; a verify window (prompt
  lookup) that crosses the switch.
* Prefix reuse: blocks of a short stream are never offered to a long
  prompt, and the reverse; a short stream offers only its blocks below the
  switch (or below a verify window that took the long table).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtp_llm_tpu.config.model_config import ModelConfig as JConfig
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu_torch.cache.kv_cache_manager import KVCacheManager, long_rope_salt
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, SchedulerConfig, SpeculativeConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

BS = 4
V = 128
ORIG = 64
TOL = 1e-5
_rng = np.random.default_rng(11)
SHORT_FACTOR = [float(x) for x in 1.0 + 0.5 * _rng.random(8)]
LONG_FACTOR = [float(x) for x in np.sort(1.0 + 7.0 * _rng.random(8))]
P_SHORT = [int(t) for t in _rng.integers(3, V, 50)]
P_LONG = P_SHORT + [int(t) for t in _rng.integers(3, V, 50)]  # 100 tokens
P_CROSS = [int(t) for t in _rng.integers(3, V, 60)]  # prefills short, decodes past 64


def _redraw(model, seed, std=0.15):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            norm = "norm" in name
            p.copy_(1.0 + 0.1 * draw if norm and name.endswith("weight") else std * draw)
    return model


def hf_config():
    import transformers

    return transformers.Phi3Config(
        vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        original_max_position_embeddings=ORIG, sliding_window=None,
        rope_scaling={"type": "longrope", "short_factor": SHORT_FACTOR,
                      "long_factor": LONG_FACTOR},
        tie_word_embeddings=False, eos_token_id=2, bos_token_id=1, pad_token_id=0)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import transformers

    path = str(tmp_path_factory.mktemp("longrope"))
    torch.manual_seed(0)
    _redraw(transformers.Phi3ForCausalLM(hf_config()), 0).save_pretrained(
        path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def hf_model(ckpt):
    import transformers

    model = transformers.Phi3ForCausalLM.from_pretrained(ckpt, dtype=torch.float32)
    return model.eval()


@pytest.fixture(scope="module")
def port(ckpt):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    return cfg, TLoader(cfg, device="cpu").load(ckpt)


def hf_logits(hf_model, prompt):
    with torch.no_grad():
        return hf_model(torch.tensor([prompt])).logits[0].numpy()


def hf_greedy(hf_model, prompt, n, k=0):
    """Greedy tokens (EOS banned, as ``ignore_eos``) of HF forwards over one
    KV cache, each forward's table picked by its own last position: one
    token a forward, or with ``k`` a verify window of the pending token and
    k prompt-lookup drafts, the cache cut back to the accepted ones. Calling
    the model directly keeps the cached keys as written: HF ``generate``
    recomputes Phi-3's whole cache at the switch (its
    ``prepare_inputs_for_generation``), which a paged pool does not."""
    from transformers import DynamicCache

    from rtp_llm_tpu_torch.engine.speculative import propose_prompt_lookup

    def argmax(logits):
        return logits.masked_fill(torch.arange(V) == 2, float("-inf")).argmax(-1).tolist()

    cache = DynamicCache()
    with torch.no_grad():
        logits = hf_model(torch.tensor([prompt]), past_key_values=cache).logits[0]
        toks = list(prompt) + [argmax(logits[-1])]
        out = toks[len(prompt):]
        while len(out) < n:
            drafts = propose_prompt_lookup(toks, k) if k else []
            g = argmax(hf_model(torch.tensor([toks[-1:] + drafts]),
                                past_key_values=cache).logits[0])
            acc = 0
            while acc < len(drafts) and drafts[acc] == g[acc]:
                acc += 1
            cache.crop(len(toks) + acc)  # the pending token's and the accepted drafts' keys
            toks += g[: acc + 1]
            out += g[: acc + 1]
    return out[:n]


def _packed(prompts, offsets=None):
    offsets = offsets or [0] * len(prompts)
    mb = max(-(-(o + len(p)) // BS) for p, o in zip(prompts, offsets))
    tables, nxt = [], 1
    for p, o in zip(prompts, offsets):
        n = -(-(o + len(p)) // BS)
        tables.append(list(range(nxt, nxt + n)) + [0] * (mb - n))
        nxt += n
    return ModelInputs(
        tokens=torch.tensor([t for p in prompts for t in p]),
        positions=torch.cat([torch.arange(o, o + len(p)) for p, o in zip(prompts, offsets)]),
        block_tables=torch.tensor(tables, dtype=torch.int32),
        kv_lens=torch.tensor([o + len(p) for p, o in zip(prompts, offsets)]),
        q_offsets=torch.tensor(offsets), row_lens=tuple(len(p) for p in prompts)), nxt + 1


def port_all_logits(port, prompts):
    cfg, weights = port
    model = LlamaFamilyModel(cfg, device="cpu")
    w = model.fuse_weights(dict(weights))
    inputs, blocks = _packed(prompts)
    out, _ = model.forward(w, model.init_cache(blocks, BS, torch.float32), inputs,
                           need_all_logits=True)
    return out.all_logits.numpy()


def test_config_reads_the_longrope_block(ckpt):
    cfg = TConfig.from_pretrained(ckpt)
    assert cfg.model_type == "phi3"
    assert cfg.rope_scaling["original_max_position_embeddings"] == ORIG
    assert cfg.max_position_embeddings == 256
    model = LlamaFamilyModel(cfg, device="cpu")
    assert model.rope_switch == ORIG
    assert tuple(model.cos.shape) == (2 * 256, 8)  # the short table's rows, then the long one's


@pytest.mark.parametrize("prompt", [P_SHORT, P_LONG], ids=["short_50", "long_100"])
def test_logits_meet_hf_on_both_sides_of_the_switch(hf_model, port, prompt):
    want = hf_logits(hf_model, prompt)
    assert np.abs(port_all_logits(port, [prompt]) - want).max() < TOL


def test_jax_tables_miss_hf_past_the_switch(ckpt, hf_model):
    """C7: the JAX package computes the unscaled tables for longrope; on the
    long side its logits sit far from HF's."""
    cfg = JConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    model = create_model(cfg)
    t = len(P_LONG)
    inputs = JInputs(tokens=jnp.asarray([P_LONG], jnp.int32),
                     positions=jnp.arange(t, dtype=jnp.int32)[None],
                     block_tables=jnp.arange(1, 1 + t // BS, dtype=jnp.int32)[None],
                     kv_lens=jnp.asarray([t], jnp.int32), q_offsets=jnp.asarray([0], jnp.int32))
    out, _ = model.forward(JLoader(cfg).load(ckpt), model.init_cache(t // BS + 2, BS, jnp.float32),
                           inputs, need_all_logits=True)
    got = np.asarray(out.all_logits).reshape(t, -1)
    assert np.abs(got - hf_logits(hf_model, P_LONG)).max() > 0.1


def test_packed_rows_take_their_own_table(hf_model, port):
    """One packed forward of the short and the long prompt: each row's
    logits are HF's of its prompt alone."""
    got = port_all_logits(port, [P_SHORT, P_LONG])
    n = len(P_SHORT)
    assert np.abs(got[:n] - hf_logits(hf_model, P_SHORT)).max() < TOL
    assert np.abs(got[n:] - hf_logits(hf_model, P_LONG)).max() < TOL


def test_a_chunk_rotates_by_the_whole_contexts_table(hf_model, port):
    """The first 40 tokens of the long prompt as a chunk of its prefill
    (``rope_lens`` the whole length): HF's logits of the long prompt at
    those rows; without ``rope_lens`` the chunk takes the short table."""
    cfg, weights = port
    model = LlamaFamilyModel(cfg, device="cpu")
    w = model.fuse_weights(dict(weights))
    inputs, blocks = _packed([P_LONG[:40]])
    cache = model.init_cache(blocks + 30, BS, torch.float32)
    want = hf_logits(hf_model, P_LONG)[:40]
    whole = inputs._replace(rope_lens=torch.tensor([len(P_LONG)]))
    out, _ = model.forward(w, cache, whole, need_all_logits=True)
    assert np.abs(out.all_logits.numpy() - want).max() < TOL
    out, _ = model.forward(w, cache, inputs, need_all_logits=True)
    assert np.abs(out.all_logits.numpy() - hf_logits(hf_model, P_LONG[:40])).max() < TOL


def _engine(port, steps=1, asy=False, prefix=True, spec="none"):
    cfg, weights = port
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=160, enable_prefix_cache=prefix),
        scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 128),
                                  decode_steps=steps, async_decode=asy),
        speculative=SpeculativeConfig(method=spec, draft_tokens=3))
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), dict(weights), econf, device="cpu")


def _serve(engine, reqs):
    streams = [engine.enqueue(p, GenerateConfig(max_new_tokens=n, do_sample=False,
                                                ignore_eos=True)) for p, n in reqs]
    for _ in range(400):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
    assert all(s.is_finished() for s in streams)
    return streams


SERVE_REQS = [(P_CROSS, 12), (P_LONG, 6), (P_SHORT[:30], 6)]


@pytest.fixture(scope="module")
def hf_served(hf_model):
    return [hf_greedy(hf_model, p, n) for p, n in SERVE_REQS]


@pytest.mark.parametrize("steps,asy", [(1, False), (4, True)], ids=["steps1", "steps4_async"])
def test_served_tokens_equal_hf_generate(port, hf_served, steps, asy):
    """Three streams served together, each HF's stepped greedy tokens alone: the
    60-token prompt's decode crosses the switch at its fifth token."""
    engine = _engine(port, steps, asy)
    streams = _serve(engine, SERVE_REQS)
    assert [s.output_token_ids for s in streams] == hf_served
    # the short prompts keep their blocks below the switch, the long one all
    assert [s.rope_keep for s in streams] == [ORIG, None, ORIG]


def test_a_verify_window_past_the_switch(port, hf_model):
    """Prompt lookup (K 3) on a prompt of a repeated segment that prefills
    short: its verify windows cross the switch, each taking the long table
    when its last draft passes it; tokens equal HF's greedy ones, and the
    stream offers only the blocks before the first long window."""
    seg = P_SHORT[:7]
    prompt = (seg * 9)[:58]
    engine = _engine(port, spec="prompt_lookup")
    (s,) = _serve(engine, [(prompt, 14)])
    assert s.output_token_ids == hf_greedy(hf_model, prompt, 14, k=3)
    assert engine.spec_stats["steps"] > 0
    assert s.rope_keep is not None and s.rope_keep < ORIG


def test_prefix_blocks_never_cross_tables(port, hf_model):
    engine = _engine(port)
    (a,) = _serve(engine, [(P_SHORT, 4)])  # short: its blocks under the plain salt
    (b,) = _serve(engine, [(P_LONG, 4)])  # long: P_SHORT's blocks are not offered
    assert b.reuse_len == 0
    assert b.output_token_ids == hf_greedy(hf_model, P_LONG, 4)
    (c,) = _serve(engine, [(P_SHORT[:44] + [5, 6, 7, 8], 4)])  # short: reuses a's blocks
    assert c.reuse_len > 0
    d_prompt = P_LONG[:90] + [9, 10, 11, 12]
    (d,) = _serve(engine, [(d_prompt, 4)])  # long: reuses b's blocks
    assert d.reuse_len >= 88
    assert d.output_token_ids == hf_greedy(hf_model, d_prompt, 4)
    # a short stream that decoded past the switch offered its blocks below it only
    (e,) = _serve(engine, [(P_CROSS, 12)])
    ctx = P_CROSS + e.output_token_ids[:-1]
    (f,) = _serve(engine, [(ctx[:ORIG], 2)])
    assert 0 < f.reuse_len < ORIG


def test_manager_keeps_the_two_tables_apart():
    mgr = KVCacheManager(num_blocks=32, block_size=BS)
    toks = list(range(3, 3 + 24))
    a = mgr.allocate(toks)
    mgr.free(a, token_ids=toks)
    assert mgr.allocate(toks + [1], salt=long_rope_salt(0)).reuse_len == 0
    assert mgr.allocate(toks + [1]).reuse_len == 24
    assert long_rope_salt(long_rope_salt(5)) == 5 and long_rope_salt(5) != 5
