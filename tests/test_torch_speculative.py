"""Speculative decoding of the port against the JAX package, on the CPU.

The same fake checkpoints (target, one-layer draft, EAGLE and EAGLE3 heads)
go through the JAX ``LlmEngine`` and the port's, f32 weights and KV:

* ``propose_prompt_lookup`` and ``greedy_verify`` equal to the JAX ones;
* the verify window's logits ``[B, K+1, V]`` against JAX ``_verify_impl``'s
  on one state and pool (f32 and int8), within 1e-4;
* greedy tokens and the engine's step count equal to the JAX spec engine's
  for prompt lookup, a draft model, EAGLE and EAGLE3, the drafts of every
  step equal to the JAX proposer's, the tokens equal to the port's normal
  decode; stops inside a window (stop id, EOS, ``max_new_tokens``), the
  ``max_seq_len`` edge, sampling streams and ``decode_steps`` 4 / async;
* C3: the JAX spec engine answers a penalised, biased or logprob request
  otherwise than its normal decode; the port falls back and does not;
* EAGLE3's capture and the final-normed ``all_hidden`` of the JAX code;
* the deferred int8 engine's verify writes what the in-layer one writes, at
  the scales of the deferred writer; the head loader; CLI flags; HTTP;
* the graph windows' keys, readied by ``warmup()`` through a recorder.
"""

from __future__ import annotations

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.engine_config import SpeculativeConfig as JSpec
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.engine import engine as jengine_mod
from rtp_llm_tpu.engine.speculative import greedy_verify as j_greedy_verify
from rtp_llm_tpu.engine.speculative import propose_prompt_lookup as j_propose
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader import load_eagle_weights as j_load_eagle
from rtp_llm_tpu.loader.fake_checkpoint import (
    tiny_config, write_fake_checkpoint, write_fake_eagle3_checkpoint,
    write_fake_eagle_checkpoint, write_fake_tokenizer,
)
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu_torch.cli import config_from_args, parse_args
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
    SpeculativeConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.convert import cache_from_jax, eagle_from_jax
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.engine.decode_graphs import WindowKey
from rtp_llm_tpu_torch.engine.eagle import capture_layers
from rtp_llm_tpu_torch.engine.speculative import greedy_verify, propose_prompt_lookup
from rtp_llm_tpu_torch.loader import CheckpointLoader, load_eagle_weights
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs

BS, NB, BATCH, MSL, K = 4, 256, 4, 128, 3
LOGITS_ATOL = 1e-4  # f32 on both sides: the verify's logits, JAX's and the port's


# ---- builders ----

@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Paths of the target, a one-layer draft, an EAGLE head and an EAGLE3
    head (3 captured layers, a draft vocabulary of 64 with ``d2t``)."""
    root = tmp_path_factory.mktemp("spec")
    cfg = tiny_config("qwen2")
    return dict(
        target=write_fake_checkpoint(str(root / "t"), cfg),
        draft=write_fake_checkpoint(str(root / "d"), tiny_config("qwen2", num_layers=1)),
        eagle=write_fake_eagle_checkpoint(str(root / "e"), cfg),
        eagle3=write_fake_eagle3_checkpoint(str(root / "e3"), cfg, n_capture=3,
                                            draft_vocab=cfg.vocab_size // 2))


def _jax(ckpts, method="none", kv="float32", steps=1, asy=True, head="eagle", eos=None,
         draft_ckpt="draft"):
    cfg = tiny_config("qwen2", dtype="float32")
    if eos is not None:
        cfg.eos_token_id = [eos]
    econf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=NB),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64),
                         decode_steps=steps, async_decode=asy),
        speculative=JSpec(method=method, draft_tokens=K))
    econf.quant.kv_cache_dtype = kv
    draft = eagle = None
    if method == "vanilla":
        dcfg = tiny_config("qwen2", num_layers=1 if draft_ckpt == "draft" else 2,
                           dtype="float32")
        draft = (create_model(dcfg), JLoader(dcfg).load(ckpts[draft_ckpt]))
    if method == "eagle":
        eagle = j_load_eagle(ckpts[head], dtype=jnp.float32)
    return JEngine(create_model(cfg), JLoader(cfg).load(ckpts["target"]), econf,
                   draft=draft, eagle=eagle)


def _port_cfg(path, eos=None):
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    if eos is not None:
        cfg.eos_token_id = [eos]
    return cfg


def _port(ckpts, method="none", kv="float32", steps=1, asy=True, head="eagle", defer=False,
          eos=None, draft_ckpt="draft"):
    cfg = _port_cfg(ckpts["target"], eos)
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL,
                                  prefill_buckets=(16, 64), decode_steps=steps,
                                  async_decode=asy, defer_kv_writes=defer),
        quant=QuantConfig(kv_cache_dtype=kv),
        speculative=SpeculativeConfig(method=method, draft_tokens=K))
    draft = eagle = None
    if method == "vanilla":
        dcfg = _port_cfg(ckpts[draft_ckpt])
        draft = (LlamaFamilyModel(dcfg, device="cpu"),
                 CheckpointLoader(dcfg, device="cpu").load(ckpts[draft_ckpt]))
    if method == "eagle":
        eagle = load_eagle_weights(ckpts[head], dtype=torch.float32, device="cpu")
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"),
                     CheckpointLoader(cfg, device="cpu").load(ckpts["target"]), econf,
                     device="cpu", draft=draft, eagle=eagle)


def _greedy(n, **kw):
    return dict(max_new_tokens=n, do_sample=False, ignore_eos=True, **kw)


def _serve(engine, reqs, gen_cls, max_steps=400):
    """Outputs (tokens, logprobs) of ``reqs`` served together, and the
    engine's step count."""
    streams = [engine.enqueue(p, gen_cls(**kw)) for p, kw in reqs]
    for _ in range(max_steps):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
    assert all(s.is_finished() for s in streams)
    return [s.output_token_ids for s in streams], engine.step_count, streams


def _record_jax_drafts(je):
    """Each verify's drafts at the active rows, as the JAX engine verifies."""
    rec, verify = [], je._verify_jit

    def spy(weights, kv, state, drafts, *rest):
        active = np.asarray(state.kv_lens) > 0
        rec.append({int(r): np.asarray(drafts)[r].tolist() for r in np.flatnonzero(active)})
        return verify(weights, kv, state, drafts, *rest)
    je._verify_jit = spy
    return rec


def _record_port_drafts(te):
    rec, window = [], te._window

    def spy(key):
        if key.kind == "verify":
            active = (te.state.kv_lens > 0).nonzero().flatten().tolist()
            rec.append({r: te._draft_buf[r].tolist() for r in active})
        return window(key)
    te._window = spy
    return rec


REPEATS = [[7, 8, 9, 7, 8, 9, 7, 8], [1, 2, 3, 1, 2, 3], [9, 9, 9, 9], [4, 5, 4, 5, 4]]


# ---- the proposer and the acceptance ----

@settings(max_examples=60, deadline=None, database=None)
@given(tokens=st.lists(st.integers(0, 6), max_size=40), k=st.integers(1, 6),
       lo=st.integers(1, 4), span=st.integers(0, 3))
def test_prompt_lookup_matches_jax(tokens, k, lo, span):
    assert propose_prompt_lookup(tokens, k, lo, lo + span) == j_propose(tokens, k, lo, lo + span)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_verify_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, v = 6, 11
    logits = rng.standard_normal((b, K + 1, v)).astype(np.float32)
    g_np = logits.argmax(-1)
    drafts = g_np[:, :K].copy()
    # rows that reject at each position, and one that rejects nothing
    for r in range(b - 1):
        drafts[r, min(r, K - 1):] = (drafts[r, min(r, K - 1):] + 1 + r) % v
    jg, jn = j_greedy_verify(jnp.asarray(logits), jnp.asarray(drafts))
    tg, tn = greedy_verify(torch.from_numpy(logits), torch.from_numpy(drafts))
    assert tg.tolist() == np.asarray(jg).tolist()
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tn.tolist()[-1] == K + 1 and min(tn.tolist()) == 1


# ---- the verify window against the JAX _verify_impl ----

@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_verify_logits_match_jax(ckpts, kv):
    """Both engines verify the same drafts from one decode state and pool
    (the JAX engine's, carried over): logits within LOGITS_ATOL, the same
    greedy tokens, emitted counts, next state and written pool."""
    je = _jax(ckpts, kv=kv)
    prompts = [[1, 5, 9, 42, 7], [3, 3, 8], [100, 3, 55, 8, 9, 2, 4]]
    streams = [je.enqueue(p, JGen(**_greedy(40))) for p in prompts]
    for _ in range(4):
        je.step()
    je._resolve_pending()
    assert all(s.slot >= 0 and not s.is_finished() for s in streams)
    # grow every allocation for the window's K+1 writes, as a step does
    rows = np.zeros((BATCH, je.max_blocks_per_seq), np.int32)
    for s in streams:
        assert je.cache_mgr.extend(s.alloc, s.total_len + K)
        rows[s.slot, : len(s.alloc.blocks)] = s.alloc.blocks
    js = je.state = je.state._replace(block_tables=jnp.asarray(rows))
    te = _port(ckpts, "prompt_lookup", kv=kv)
    te.kv = cache_from_jax(je.kv if kv != "int8" else
                           {n: np.asarray(a) for n, a in je.kv.items()}, "cpu")
    for name in ("last_tokens", "kv_lens", "block_tables"):
        getattr(te.state, name).copy_(torch.from_numpy(np.asarray(getattr(js, name)).copy()))
    te.state.params.ban_eos.copy_(torch.from_numpy(np.asarray(js.params.ban_eos).copy()))
    drafts = np.random.default_rng(1).integers(0, 128, (BATCH, K)).astype(np.int32)
    jlog = {}

    def spy(logits, d):
        jlog["logits"] = np.asarray(logits)
        return j_greedy_verify(logits, d)
    jengine_mod.greedy_verify, orig = spy, jengine_mod.greedy_verify
    try:
        jkv, jstate, jg, jn = je._verify_impl(je.weights, je.kv, js, jnp.asarray(drafts))
    finally:
        jengine_mod.greedy_verify = orig
    te._draft_buf.copy_(torch.from_numpy(drafts).long())
    kvb = te.max_blocks_per_seq
    with torch.no_grad():
        logits, _ = te._verify_logits(kvb, K)
    live = np.asarray(js.kv_lens) > 0
    np.testing.assert_allclose(logits.numpy()[live], jlog["logits"][live],
                               atol=LOGITS_ATOL, rtol=0)
    # the whole window from the carried-over state: tokens, counts, state, pool
    te.kv = cache_from_jax(je.kv if kv != "int8" else
                           {n: np.asarray(a) for n, a in je.kv.items()}, "cpu")
    for name in ("last_tokens", "kv_lens"):
        getattr(te.state, name).copy_(torch.from_numpy(np.asarray(getattr(js, name)).copy()))
    with torch.no_grad():
        (out,) = te._verify_window(kvb, K)
    assert out[: K + 1].T[live].tolist() == np.asarray(jg)[live].tolist()
    assert out[K + 1].tolist() == np.asarray(jn).tolist()
    assert te.state.kv_lens.tolist() == np.asarray(jstate.kv_lens).tolist()
    assert te.state.last_tokens[live].tolist() == np.asarray(jstate.last_tokens)[live].tolist()
    if kv == "int8":
        np.testing.assert_array_equal(te.kv["data"].numpy(), np.asarray(jkv["data"]))
    else:
        np.testing.assert_allclose(te.kv.numpy(), np.asarray(jkv), atol=1e-5, rtol=0)


# ---- engines, token for token and step for step ----

METHODS = [("prompt_lookup", "eagle"), ("vanilla", "eagle"), ("eagle", "eagle"),
           ("eagle", "eagle3")]


@pytest.mark.parametrize("method,head,draft", [
    ("prompt_lookup", "eagle", "draft"), ("vanilla", "eagle", "draft"),
    ("vanilla", "eagle", "target"), ("eagle", "eagle", "draft"), ("eagle", "eagle3", "draft"),
], ids=["prompt_lookup", "vanilla", "vanilla_self", "eagle", "eagle3"])
def test_spec_tokens_steps_and_drafts_match_jax(ckpts, method, head, draft):
    """A batch of three greedy streams: the port's spec engine emits the
    JAX spec engine's tokens in as many steps, verifying the same drafts
    each step, and the port's normal decode's tokens. Prompt lookup on
    repeating prompts, and the target as its own draft, accept drafts and
    save steps; the random one-layer draft and heads accept next to none."""
    reqs = [(p, _greedy(12)) for p in REPEATS[:3]]
    je = _jax(ckpts, method, head=head, draft_ckpt=draft)
    jrec = _record_jax_drafts(je)
    want, jsteps, _ = _serve(je, reqs, JGen)
    te = _port(ckpts, method, head=head, draft_ckpt=draft)
    trec = _record_port_drafts(te)
    got, tsteps, _ = _serve(te, reqs, GenerateConfig)
    assert got == want and tsteps == jsteps
    assert trec == jrec and len(trec) > 0
    normal, nsteps, _ = _serve(_port(ckpts), reqs, GenerateConfig)
    assert got == normal
    accepting = method == "prompt_lookup" or draft == "target"
    assert (te.spec_stats["tokens"] > 1.5 * te.spec_stats["rows"]) == accepting
    assert tsteps < nsteps - (3 if accepting else 0)


def test_eagle3_capture_and_draft_vocabulary(ckpts):
    """The EAGLE3 engine captures the JAX layers, its drafts are target ids
    (``d2t``), and its model's ``all_hidden`` is their pre-norm concat."""
    je, te = _jax(ckpts, "eagle", head="eagle3"), _port(ckpts, "eagle", head="eagle3")
    assert te.eagle.is_eagle3 and te.eagle.capture_layers == je.mtp.capture_layers
    assert capture_layers(2, 3) == (0, 0, 1) and capture_layers(32, 3) == (2, 16, 29)
    _serve(te, [(REPEATS[0], _greedy(6))], GenerateConfig)
    d = te._draft_buf
    assert (d >= 0).all() and (d < te.model.cfg.vocab_size).all()


@pytest.mark.parametrize("capture", [None, (0, 1, 1)])
def test_all_hidden_matches_jax(ckpts, capture):
    """Without capture ``all_hidden`` is the final-normed rows (the JAX
    code, against the "pre-norm" of its EAGLE docstrings); with it the
    captured layers' outputs before the final norm, concatenated."""
    cfg = tiny_config("qwen2", dtype="float32")
    jm = create_model(cfg)
    jw = JLoader(cfg).load(ckpts["target"])
    jm.spec_capture_layers = capture
    tcfg = _port_cfg(ckpts["target"])
    tm = LlamaFamilyModel(tcfg, device="cpu")
    tw = tm.fuse_weights(CheckpointLoader(tcfg, device="cpu").load(ckpts["target"]))
    toks = [1, 5, 9, 42, 7, 3]
    t = len(toks)
    jin = JInputs(tokens=jnp.asarray([toks], jnp.int32),
                  positions=jnp.arange(t, dtype=jnp.int32)[None],
                  block_tables=jnp.arange(1, 3, dtype=jnp.int32)[None],
                  kv_lens=jnp.asarray([t], jnp.int32), q_offsets=jnp.zeros((1,), jnp.int32))
    jout, _ = jm.forward(jw, jm.init_cache(8, BS, jnp.float32), jin, need_all_hidden=True)
    tin = ModelInputs(torch.tensor([toks]), torch.arange(t)[None], torch.tensor([[1, 2]]),
                      torch.tensor([t]), torch.tensor([0]))
    tout, _ = tm.forward(tw, tm.init_cache(8, BS, torch.float32), tin, need_all_hidden=True,
                         capture_layers=capture or ())
    want = np.asarray(jout.all_hidden).reshape(t, -1)
    assert tout.all_hidden.shape == ((t, 64) if capture is None else (t, 3 * 64))
    np.testing.assert_allclose(tout.all_hidden.numpy(), want, atol=1e-4, rtol=0)
    if capture is None:  # final-normed: the rms of every row is the norm weight's (ones)
        rms = tout.all_hidden.pow(2).mean(-1).sqrt()
        np.testing.assert_allclose(rms.numpy(), np.ones(t), atol=1e-3)


def test_hidden_states_of_an_eagle3_engine_are_the_final_normed_rows(ckpts):
    """``generate_with_hidden`` on an EAGLE3 engine, after it has served
    speculatively, returns what a normal engine on the same model object
    returns, and what the JAX normal engine returns: the final-normed rows
    ``[n_out, H]``. The capture layers reach only the verify's and the
    prefill's forwards. The JAX EAGLE3 engine sets them on its model, so
    its hidden states come back as the captured layers' concatenation,
    ``[n_out, 3H]`` (ROADMAP C)."""
    import dataclasses

    te = _port(ckpts, "eagle", head="eagle3")
    _serve(te, [(REPEATS[0], _greedy(6))], GenerateConfig)
    assert te.spec_stats["steps"] > 0
    normal = LlmEngine(te.model, te.weights,
                       dataclasses.replace(te.config, speculative=SpeculativeConfig()),
                       device="cpu")
    prompt, h = [1, 5, 9, 42, 7, 3], te.model.cfg.hidden_size
    got = [e.generate_with_hidden(prompt, GenerateConfig(**_greedy(5))) for e in (te, normal)]
    assert got[0][0].output_token_ids == got[1][0].output_token_ids
    assert got[0][1].shape == got[1][1].shape == (5, h)
    np.testing.assert_allclose(got[0][1].numpy(), got[1][1].numpy(), atol=1e-6, rtol=0)
    jn = _jax(ckpts).generate_with_hidden(prompt, JGen(**_greedy(5)))
    assert jn[0].output_token_ids == got[0][0].output_token_ids
    np.testing.assert_allclose(got[0][1].numpy(), np.asarray(jn[1]), atol=1e-4, rtol=0)
    j3 = _jax(ckpts, "eagle", head="eagle3").generate_with_hidden(prompt, JGen(**_greedy(5)))
    assert np.asarray(j3[1]).shape == (5, 3 * h)


def _normal_full(ckpts, prompt, n=12):
    return _serve(_port(ckpts), [(prompt, _greedy(n))], GenerateConfig)[0][0]


STOPS = ["stop_id", "eos", "max_new_tokens", "max_seq_len"]


@pytest.mark.parametrize("method,head", METHODS[:2] + METHODS[3:],
                         ids=["prompt_lookup", "vanilla", "eagle3"])
@pytest.mark.parametrize("stop", STOPS)
def test_stops_inside_a_window_match_jax(ckpts, method, head, stop):
    """A stream stops where the normal decode stops, also in the middle of
    a verify window: a stop id, an EOS id, ``max_new_tokens``, and the
    ``max_seq_len`` edge (the last K+1 tokens take the normal window)."""
    prompt, eos, n = REPEATS[0], None, 12
    full = _normal_full(ckpts, prompt)
    kw = _greedy(n)
    if stop == "stop_id":
        kw["stop_token_ids"] = [full[4]]
    elif stop == "eos":
        eos, kw["ignore_eos"] = full[5], False
    elif stop == "max_new_tokens":
        kw["max_new_tokens"] = 6
    else:
        prompt = (REPEATS[0] * 15)[: MSL - 9]
        kw["max_new_tokens"] = 40
    reqs = [(prompt, kw), (REPEATS[1], _greedy(10))]
    want, jsteps, _ = _serve(_jax(ckpts, method, head=head, eos=eos), reqs, JGen)
    got, tsteps, streams = _serve(_port(ckpts, method, head=head, eos=eos), reqs,
                                  GenerateConfig)
    normal = _serve(_port(ckpts, eos=eos), reqs, GenerateConfig)[0]
    assert got == want == normal and tsteps == jsteps
    if stop == "max_seq_len":
        assert len(prompt) + len(got[0]) == MSL and streams[0].finish_reason.value == "length"
    elif stop == "max_new_tokens":
        assert len(got[0]) == 6
    else:
        assert got[0][-1] == (full[4] if stop == "stop_id" else eos)


@pytest.mark.parametrize("steps,asy", [(1, False), (4, False), (4, True)])
def test_sampling_streams_and_multi_step_windows_fall_back_as_jax(ckpts, steps, asy):
    """A sampling stream (top_k 1) beside greedy ones: the batch takes the
    normal window (multi-step and async as configured) while it runs, and
    speculates after it finishes, as the JAX engine does: the same tokens in
    as many steps."""
    reqs = [(REPEATS[0], _greedy(14)),
            (REPEATS[1], dict(max_new_tokens=5, do_sample=True, top_k=1, ignore_eos=True)),
            (REPEATS[2], _greedy(9))]
    want, jsteps, _ = _serve(_jax(ckpts, "prompt_lookup", steps=steps, asy=asy), reqs, JGen)
    te = _port(ckpts, "prompt_lookup", steps=steps, asy=asy)
    got, tsteps, _ = _serve(te, reqs, GenerateConfig)
    assert got == want and tsteps == jsteps
    assert te.spec_stats["steps"] > 0
    assert any(k.kind == "decode" and k.n_steps == steps for k in te.decode_keys)


def test_eos_ban_ending_inside_a_window_falls_back(ckpts):
    """``min_new_tokens`` whose EOS ban lifts inside the next window: the
    step takes the normal window (the JAX verify bans at every position),
    so the tokens are the normal decode's."""
    full = _normal_full(ckpts, REPEATS[0])
    kw = dict(max_new_tokens=12, do_sample=False, min_new_tokens=4)
    reqs = [(REPEATS[0], kw)]
    normal = _serve(_port(ckpts, eos=full[4]), reqs, GenerateConfig)[0]
    te = _port(ckpts, "prompt_lookup", eos=full[4])
    assert _serve(te, reqs, GenerateConfig)[0] == normal


# ---- C3: the JAX spec engine's divergence, pinned and not copied ----

C3_CASES = {
    "repetition_penalty": dict(repetition_penalty=1.3),
    "logit_bias": dict(logit_bias={100: 100.0}),
    "return_logprobs": dict(return_logprobs=True),
}


@pytest.mark.parametrize("case", sorted(C3_CASES))
def test_c3_jax_spec_differs_the_port_falls_back(ckpts, case):
    """The JAX gate lets penalised, biased and logprob streams speculate:
    its verify applies the pre-step counts at every position, no bias, and
    returns no logprobs, so its spec engine answers otherwise than its
    normal decode. The port's spec engine answers as its normal decode.
    The target is its own draft, so that drafts are accepted (prompt lookup
    proposes only tokens already counted: the penalty cannot go stale)."""
    reqs = [(p, _greedy(14, **C3_CASES[case])) for p in REPEATS]
    jspec = _serve(_jax(ckpts, "vanilla", draft_ckpt="target"), reqs, JGen)
    jnorm = _serve(_jax(ckpts), reqs, JGen)
    tspec = _serve(_port(ckpts, "vanilla", draft_ckpt="target"), reqs, GenerateConfig)
    tnorm = _serve(_port(ckpts), reqs, GenerateConfig)
    if case == "return_logprobs":
        # only the first token, sampled at the prefill, carries one
        assert [len(s.output_logprobs) for s in jspec[2]] == [1] * len(reqs)
        assert [len(s.output_logprobs) for s in jnorm[2]] == [14] * len(reqs)
    elif case == "logit_bias":
        # the +100 pins every token of the normal decode; the JAX verify
        # drops the bias from the second token on
        assert all(set(b) == {100} for b in jnorm[0])
        assert all(a[0] == 100 and a[1] != 100 for a in jspec[0])
    else:
        assert jspec[0] != jnorm[0]
    assert tspec[0] == tnorm[0] == jnorm[0]
    for a, b in zip(tspec[2], tnorm[2]):
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs, atol=1e-5)


# ---- the deferred int8 engine ----

def test_deferred_int8_verify_writes_the_deferred_writers_rows(ckpts):
    """On an int8 pool with deferred decode writes the verify writes K/V
    in-layer. From one state and pool it leaves the pool bit for bit as the
    in-layer engine's verify does, and the rows it writes at the pending
    position of layer 0 (whose input is the token alone) are the deferred
    decode step's: the same codes and the same scales."""
    reqs = [(p, _greedy(40)) for p in REPEATS[:3]]
    deferred = _port(ckpts, "prompt_lookup", kv="int8", defer=True)
    inlayer = _port(ckpts, "prompt_lookup", kv="int8")
    for e in (deferred, inlayer):
        streams = [e.enqueue(p, GenerateConfig(**kw)) for p, kw in reqs]
        for _ in range(3):
            e.step()
        e._resolve_pending()
    # one state and pool on both
    for name in ("last_tokens", "kv_lens", "block_tables"):
        getattr(inlayer.state, name).copy_(getattr(deferred.state, name))
    inlayer.kv = {n: t.clone() for n, t in deferred.kv.items()}
    pool0 = {n: t.clone() for n, t in deferred.kv.items()}
    state0 = (deferred.state.last_tokens.clone(), deferred.state.kv_lens.clone())
    drafts = torch.tensor(np.random.default_rng(3).integers(0, 128, (BATCH, K)))
    kvb = deferred.max_blocks_per_seq
    with torch.no_grad():
        for e in (deferred, inlayer):
            e._draft_buf.copy_(drafts)
            e._verify_window(kvb, K)
    for n in ("data", "scale"):
        assert torch.equal(deferred.kv[n], inlayer.kv[n])
    verified = {n: t.clone() for n, t in deferred.kv.items()}
    # the deferred decode step from the same state and pool
    deferred.kv = pool0
    deferred.state.last_tokens.copy_(state0[0])
    deferred.state.kv_lens.copy_(state0[1])
    with torch.no_grad():
        deferred._decode_step(kvb, False, False)
    live = (state0[1] > 0).nonzero().flatten()
    pos = state0[1][live].long()
    bt = deferred.state.block_tables[live].long()
    slots = bt.gather(1, (pos // BS)[:, None])[:, 0] * BS + pos % BS
    for n in ("data", "scale"):
        assert torch.equal(verified[n][0, :, slots], deferred.kv[n][0, :, slots])
    assert len(streams) == 3


# ---- the head loader, the config, the CLI ----

@pytest.mark.parametrize("head", ["eagle", "eagle3"])
def test_load_eagle_weights_matches_jax(ckpts, head):
    jw = j_load_eagle(ckpts[head], dtype=jnp.float32)
    tw = load_eagle_weights(ckpts[head], dtype=torch.float32, device="cpu")
    conv = eagle_from_jax({k: np.asarray(v) for k, v in jw.items()}, "cpu")
    assert set(tw) == set(jw) == set(conv)
    for k in tw:
        assert tw[k].dtype == conv[k].dtype
        assert torch.equal(tw[k], conv[k]), k
    assert ("d2t" in tw) == (head == "eagle3")
    bf = load_eagle_weights(ckpts[head], device="cpu")
    assert bf["fc"].dtype == torch.bfloat16


def test_mtp_raises_with_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        SpeculativeConfig(method="mtp")
    with pytest.raises(ValueError):
        SpeculativeConfig(method="medusa")
    assert not SpeculativeConfig().enabled
    assert not SpeculativeConfig(method="prompt_lookup", draft_tokens=0).enabled


def test_missing_proposer_raises(ckpts):
    for method in ("vanilla", "eagle"):
        with pytest.raises(ValueError, match=method):
            cfg = _port_cfg(ckpts["target"])
            LlmEngine(LlamaFamilyModel(cfg, device="cpu"),
                      CheckpointLoader(cfg, device="cpu").load(ckpts["target"]),
                      EngineConfig(cache=CacheConfig(block_size=BS, num_blocks=NB),
                                   speculative=SpeculativeConfig(method=method)),
                      device="cpu")


@pytest.mark.parametrize("argv,want", [
    ([], ("none", 4, 2, 4, "")),
    (["--speculative-method", "prompt_lookup", "--speculative-draft-tokens", "5",
      "--speculative-ngram-min", "3", "--speculative-ngram-max", "6"],
     ("prompt_lookup", 5, 3, 6, "")),
    (["--speculative-method", "eagle", "--speculative-sp-model-path", "/heads/e3"],
     ("eagle", 4, 2, 4, "/heads/e3")),
])
def test_speculative_flags_reach_the_engine_config(argv, want):
    sp = config_from_args(parse_args(["serve", "/ckpt", *argv])).speculative
    assert (sp.method, sp.draft_tokens, sp.ngram_min, sp.ngram_max, sp.sp_model_path) == want


def test_cli_mtp_is_refused():
    with pytest.raises(NotImplementedError, match="DeepSeek"):
        config_from_args(parse_args(["serve", "/ckpt", "--speculative-method", "mtp"]))


@pytest.mark.parametrize("method", ["vanilla", "eagle"])
def test_build_engine_loads_the_proposer(ckpts, method):
    from rtp_llm_tpu_torch.server.server import build_engine

    sp_path = ckpts["draft" if method == "vanilla" else "eagle3"]
    config = EngineConfig(cache=CacheConfig(block_size=BS, num_blocks=NB),
                          scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL,
                                                    prefill_buckets=(16, 64)),
                          speculative=SpeculativeConfig(method=method, draft_tokens=K,
                                                        sp_model_path=sp_path))
    te = build_engine(ckpts["target"], config, device="cpu", dtype="float32")
    assert (te.draft is not None) == (method == "vanilla")
    assert (te.eagle is not None) == (method == "eagle")
    s = te.generate(REPEATS[0], GenerateConfig(**_greedy(8)))
    assert s.output_token_ids == _normal_full(ckpts, REPEATS[0], 8)


# ---- warmup and the graph keys ----

class _GraphRecorder:
    def __init__(self):
        self.keys = []

    def __contains__(self, key):
        return key in self.keys

    def ready_thread(self):
        pass

    def capture(self, key):
        self.keys.append(key)


@pytest.mark.parametrize("method,head", METHODS, ids=["prompt_lookup", "vanilla", "eagle",
                                                      "eagle3"])
def test_warmup_readies_the_speculative_windows(ckpts, method, head):
    """``warmup()`` captures each kv bucket's rollout (draft or EAGLE) and
    verify before the decode windows, largest bucket first; serving then
    dispatches no window warmup did not ready. A verify returns its greedy
    tokens and emitted counts as one ``[K+2, B]`` tensor, a rollout
    nothing (its drafts land in the verify's buffer)."""
    te = _port(ckpts, method, head=head)
    te._graphs = rec = _GraphRecorder()
    te.warmup(tail=False)
    buckets = list(reversed(te._kv_buckets))
    spec = [key for key in rec.keys if key.kind != "decode"]
    roll = [] if method == "prompt_lookup" else [method]
    assert spec == [WindowKey(kvb, kind=kind, k=K) for kvb in buckets for kind in roll + ["verify"]]
    assert rec.keys[: len(spec)] == spec
    assert all(key == WindowKey(*key[:5]) for key in rec.keys[len(spec):])
    _serve(te, [(p, _greedy(10)) for p in REPEATS[:3]], GenerateConfig)
    assert te.decode_keys <= te.warm_keys
    assert any(k.kind == "verify" for k in te.decode_keys)
    with torch.no_grad():
        out = te._window(WindowKey(buckets[-1], kind="verify", k=K))
    assert len(out) == 1 and out[0].shape == (K + 2, BATCH) and out[0].dtype == torch.int64
    if roll:
        assert te._window(WindowKey(buckets[-1], kind=roll[0], k=K)) == ()


# ---- HTTP ----

def test_http_greedy_chat_answers_the_same_with_prompt_lookup(tmp_path):
    """``--speculative-method prompt_lookup`` leaves a greedy chat's answer
    as it is."""
    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.frontend.tokenizer_factory import TokenizerFactory
    from rtp_llm_tpu_torch.server.server import build_engine

    path = str(tmp_path)
    write_fake_checkpoint(path, tiny_config("qwen2"))
    write_fake_tokenizer(path, 128)
    body = {"messages": [{"role": "user", "content": "w1 w2 w3 w1 w2 w3 w1 w2"}],
            "max_tokens": 12, "temperature": 0, "ignore_eos": True}
    answers, steps = [], []
    for argv in ([], ["--speculative-method", "prompt_lookup",
                      "--speculative-draft-tokens", "4"]):
        args = parse_args(["serve", path, "--num-blocks", "64", "--block-size", "4",
                           "--max-seq-len", "256", "--max-batch-size", "4", *argv])
        engine = build_engine(path, config_from_args(args), device="cpu", dtype="float32")
        app = build_app(engine, TokenizerFactory.create(path))
        base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
        try:
            req = urllib.request.Request(base + "/v1/chat/completions",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                answers.append(json.loads(r.read())["choices"][0])
        finally:
            app.stop()
        steps.append(engine.spec_stats["steps"])
    assert answers[0]["message"]["content"] == answers[1]["message"]["content"]
    assert answers[0].get("token_ids") == answers[1].get("token_ids")
    assert steps[0] == 0 and steps[1] > 0


def test_verify_readback_on_the_cpu():
    """A verify's one ``[K+2, B]`` output comes back through the pinned
    readback's CPU form: the greedy tokens by position, then the counts."""
    from rtp_llm_tpu_torch.engine.decode_graphs import Readback

    rb = Readback(batch=BATCH, device=torch.device("cpu"))
    out = torch.arange((K + 2) * BATCH).reshape(K + 2, BATCH)
    rb.start(out, None, need_stats=False)
    assert rb.wait() == (out.tolist(), None)
