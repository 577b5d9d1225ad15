"""Beam search in the port against the JAX package, on the CPU (tiny f32
model, blocks of 4 tokens).

* ``BeamGroup`` steps equal the JAX class's on the same log-probabilities:
  children, finished hypotheses, the stopping rule and the best.
* Engine tokens and the best hypothesis's score equal the JAX engine's for
  ``num_beams`` 2 / 3 / 4 and ``variable_num_beams`` [1] (greedy) and
  [1, 2, 4]; scores to 1e-4.
* EOS-finished hypotheses (an EOS id the model emits), the ``max_seq_len``
  clamp, both fork branches (a prompt that fills its last block, so the
  pending token opens a fresh one, and one whose tail is copied), an OOM
  while forking, no block leaked, a beam group beside greedy streams at
  ``decode_steps`` 1 / 4 x async off / on, the int8 pool (the tail copy
  takes the scales), prefix reuse, and the HTTP routes.
* The reference's fault F1 (the beam step drops the adapter) shown on the
  JAX engine and repaired in the port (ROADMAP.md, section C).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.engine.beam import BeamGroup as JBeamGroup
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.lora import LoraManager as JLoraManager
from rtp_llm_tpu.lora import load_peft_adapter as jload
from rtp_llm_tpu.lora import merge_lora as jmerge
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.engine.beam import Beam, BeamGroup
from rtp_llm_tpu_torch.engine.stream import GenerateStream
from rtp_llm_tpu_torch.frontend.openai_api import build_app
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.lora import LoraManager, load_peft_adapter, merge_lora
from rtp_llm_tpu_torch.models import LlamaFamilyModel

BS, BATCH = 4, 4
EOS = 71  # a token the tiny model's beams reach within a few steps
PROMPT = [1, 5, 9, 42, 7]  # 5 tokens: the first fork copies the tail block
PROMPT4 = [1, 5, 9, 42]  # 4 tokens: the pending token opens a fresh block


def _port(ckpt, nb=128, msl=128, steps=1, asy=True, prefix=False, kv="float32", weights=None):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=nb, enable_prefix_cache=prefix),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=msl,
                                  prefill_buckets=(16, 64), decode_steps=steps,
                                  async_decode=asy),
        quant=QuantConfig(kv_cache_dtype=kv))
    if weights is None:
        weights = CheckpointLoader(cfg, device="cpu").load(ckpt)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), weights, econf, device="cpu")


def _jax(ckpt, nb=128, msl=128, steps=1, asy=True, prefix=False, kv="float32", weights=None,
         eos=(2,)):
    cfg = tiny_config("qwen2", dtype="float32", eos_token_id=list(eos))
    econf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=nb, enable_prefix_cache=prefix),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=msl, prefill_buckets=(16, 64),
                         decode_steps=steps, async_decode=asy))
    econf.quant.kv_cache_dtype = kv
    je = JEngine(create_model(cfg), JLoader(cfg).load(ckpt) if weights is None else weights,
                 econf)
    je.best = []
    finish = je._finish_beam_group

    def record(group):  # the best hypothesis of each group, as it finishes
        je.best.append(group.best())
        finish(group)
    je._finish_beam_group = record
    return je


def _beam(n, jax=False, **kw):
    return (JGen if jax else GenerateConfig)(max_new_tokens=n, do_sample=False, **kw)


def _run(engine, reqs, steps=400):
    streams = [engine.enqueue(p, c) for p, c in reqs]
    for _ in range(steps):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
    assert all(s.is_finished() for s in streams)
    return streams


def _free(engine):
    return engine.cache_mgr.pool.free_blocks


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("beam")), tiny_config("qwen2"))


@pytest.fixture(scope="module")
def eos_ckpt(tmp_path_factory):
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("beam_eos")),
                                 tiny_config("qwen2", eos_token_id=[EOS]))


@pytest.fixture(scope="module")
def pair(ckpt):
    """One (JAX, port) engine pair for the module's plain beam cases."""
    return _jax(ckpt), _port(ckpt)


# ---- the host state ----------------------------------------------------------


@pytest.mark.parametrize("widths", [[], [1, 2, 4], [3, 1]])
def test_beam_group_steps_equal_jax(widths):
    """Random log-probability rows through both classes, EOS among the
    candidates: the same children, finished hypotheses, stops and best."""
    v, k = 12, 3
    out = []
    for cls in (BeamGroup, JBeamGroup):
        cfg = GenerateConfig(max_new_tokens=9, num_beams=k, variable_num_beams=list(widths))
        group = cls(GenerateStream([1, 2, 3], cfg), cfg.max_num_beams, None, BS)
        rng2 = np.random.default_rng(7)
        first = np.log(rng2.dirichlet(np.ones(v)))
        group.init_from_prefill([1], first, (5,), 9)
        trace = [[(b.tokens, b.cum_logprob) for b in group.beams]]
        while not group.done:
            lp = np.log(rng2.dirichlet(np.ones(v) * 0.5, size=len(group.beams)))
            children = group.advance(lp, (5,), 9)
            trace.append((children, [(h.tokens, h.cum_logprob) for h in group.finished],
                          group.done))
            if not children:
                break
            group.beams = [Beam(group.beams[p].tokens + [t], s, []) for p, t, s in children]
        best = group.best()
        trace.append((best.tokens, best.cum_logprob))
        out.append(trace)
    assert out[0] == out[1]


# ---- the engine ----------------------------------------------------------------


BEAM_CASES = {"beams2": dict(num_beams=2), "beams3": dict(num_beams=3),
              "beams4": dict(num_beams=4), "variable1": dict(variable_num_beams=[1]),
              "variable124": dict(variable_num_beams=[1, 2, 4])}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_tokens_and_scores_match_jax(pair, case):
    """Tokens and the best score equal the JAX engine's (ignore_eos), both
    fork branches on the way (prompts of 5 and 4 tokens); every block
    comes back."""
    je, te = pair
    before, jbefore = _free(te), _free(je)
    for prompt in (PROMPT, PROMPT4):
        kw = dict(BEAM_CASES[case], ignore_eos=True)
        got = _run(te, [(prompt, _beam(8, **kw))])[0]
        want = _run(je, [(prompt, _beam(8, jax=True, **kw))])[0]
        assert got.output_token_ids == want.output_token_ids
        if got.config.max_num_beams == 1:  # width 1 throughout: the greedy path
            assert got.beam_hypotheses is None
            continue
        assert got.beam_hypotheses[0][0] == je.best[-1].tokens
        assert abs(got.beam_hypotheses[0][1] - je.best[-1].cum_logprob) <= 1e-4
        assert got.finish_reason.value == want.finish_reason.value == "length"
    assert _free(te) == before and _free(je) == jbefore and not te._beam_groups


def test_variable_width_one_is_greedy(pair):
    _, te = pair
    greedy = _run(te, [(PROMPT, _beam(8, ignore_eos=True))])[0]
    beam = _run(te, [(PROMPT, _beam(8, ignore_eos=True, variable_num_beams=[1]))])[0]
    assert beam.output_token_ids == greedy.output_token_ids


def test_eos_finished_hypotheses_match_jax(eos_ckpt):
    """Without ignore_eos, hypotheses end at the EOS id (not emitted) and the
    group stops by the JAX rule; tokens, score and finish reason equal."""
    je, te = _jax(eos_ckpt, eos=(EOS,)), _port(eos_ckpt)
    assert te.eos_ids == (EOS,)
    for prompt in ([3, 9, 11], PROMPT4):
        got = _run(te, [(prompt, _beam(12, num_beams=3))])[0]
        want = _run(je, [(prompt, _beam(12, jax=True, num_beams=3))])[0]
        assert got.output_token_ids == want.output_token_ids
        assert abs(got.beam_hypotheses[0][1] - je.best[-1].cum_logprob) <= 1e-4
        assert got.finish_reason.value == want.finish_reason.value
    # a hypothesis ends before its EOS, but the first token is taken from the
    # prefill's top k as it is (the JAX rule): here it is the EOS id itself
    assert got.finish_reason.value == "stop" and EOS not in got.output_token_ids[1:]


def test_max_seq_len_clamp_matches_jax(ckpt):
    """max_new_tokens past max_seq_len: the group stops at max_seq_len."""
    je, te = _jax(ckpt, msl=16), _port(ckpt, msl=16)
    prompt = list(range(3, 14))  # 11 tokens: room for 5
    got = _run(te, [(prompt, _beam(40, num_beams=3, ignore_eos=True))])[0]
    want = _run(je, [(prompt, _beam(40, jax=True, num_beams=3, ignore_eos=True))])[0]
    assert got.output_token_ids == want.output_token_ids and len(got.output_token_ids) == 5


@pytest.mark.parametrize("nb,max_new,greedy_new", [(13, 2, 2), (20, 10, 12)],
                         ids=["at-prefill", "later"])
def test_oom_while_forking_matches_jax(ckpt, nb, max_new, greedy_new):
    """A beam request admitted beside a greedy one that takes the blocks its
    forks need (admission checks each request against the free blocks
    alone): the fork after the prefill, or a later one, finds the pool
    empty, and the group ends early with its best hypothesis, as the JAX
    engine's does; every block comes back."""
    je, te = _jax(ckpt, nb=nb), _port(ckpt, nb=nb)
    before = _free(te)
    reqs = lambda jax: [(PROMPT, _beam(max_new, jax=jax, num_beams=4, ignore_eos=True)),
                        (list(range(3, 33)), _beam(greedy_new, jax=jax, ignore_eos=True))]
    got, want = _run(te, reqs(False)), _run(je, reqs(True))
    assert [s.output_token_ids for s in got] == [s.output_token_ids for s in want]
    assert len(got[0].output_token_ids) < max_new
    for _ in range(3):
        te.step()
    assert _free(te) == before


@pytest.mark.parametrize("steps,asy", [(1, True), (1, False), (4, True), (4, False)],
                         ids=["n1-async", "n1-sync", "n4-async", "n4-sync"])
def test_beam_beside_greedy_streams_matches_jax(ckpt, steps, asy):
    """A beam group and three greedy streams at once: every stream's tokens
    equal the JAX engine's; the beam holds no decode slot."""
    je, te = _jax(ckpt, steps=steps, asy=asy), _port(ckpt, steps=steps, asy=asy)
    reqs = [([3, 9, 11, 40], dict(max_new_tokens=9, ignore_eos=True)),
            (PROMPT, dict(max_new_tokens=10, num_beams=3, ignore_eos=True)),
            ([60, 61, 62, 63, 64, 65], dict(max_new_tokens=7, ignore_eos=True)),
            ([7, 7], dict(max_new_tokens=11, ignore_eos=True))]
    before = _free(te)
    got = _run(te, [(p, GenerateConfig(do_sample=False, **kw)) for p, kw in reqs])
    want = _run(je, [(p, JGen(do_sample=False, **kw)) for p, kw in reqs])
    assert [s.output_token_ids for s in got] == [s.output_token_ids for s in want]
    assert got[1].slot == -1 and sorted(te._free_slots) == list(range(BATCH))
    for _ in range(3):
        te.step()
    assert _free(te) == before


def test_int8_pool_copies_the_scales(ckpt):
    """On an int8 pool the forked tail's scales are copied with its data:
    tokens equal the JAX engine's on its int8 pool; ``copy_blocks`` moves
    both tensors."""
    je, te = _jax(ckpt, kv="int8"), _port(ckpt, kv="int8")
    for prompt in (PROMPT, PROMPT4):
        got = _run(te, [(prompt, _beam(8, num_beams=3, ignore_eos=True))])[0]
        want = _run(je, [(prompt, _beam(8, jax=True, num_beams=3, ignore_eos=True))])[0]
        assert got.output_token_ids == want.output_token_ids
    kv = te.kv
    rows = slice(5 * BS, 6 * BS)
    kv["data"][:, :, rows] = 7
    kv["scale"][:, :, rows] = 0.5
    te.copy_blocks([5], [9])
    assert torch.equal(kv["data"][:, :, 9 * BS: 10 * BS], kv["data"][:, :, rows])
    assert torch.equal(kv["scale"][:, :, 9 * BS: 10 * BS], kv["scale"][:, :, rows])


def test_prefix_reuse_matches_jax(ckpt):
    """A beam prompt whose first blocks are cached reuses them, as in JAX,
    with the same tokens."""
    je, te = _jax(ckpt, prefix=True), _port(ckpt, prefix=True)
    shared = list(range(20, 33))
    for engine, jax in ((je, True), (te, False)):
        _run(engine, [(shared + [1, 2], _beam(4, jax=jax, ignore_eos=True))])
    got = _run(te, [(shared + [5, 6, 7], _beam(6, num_beams=3, ignore_eos=True))])[0]
    want = _run(je, [(shared + [5, 6, 7], _beam(6, jax=True, num_beams=3, ignore_eos=True))])[0]
    assert got.reuse_len == want.reuse_len == 12
    assert got.output_token_ids == want.output_token_ids


def test_f1_the_beam_step_keeps_the_adapter(ckpt, tmp_path):
    """F1: a beam request naming an adapter. The JAX beam step runs the base
    model after the first token, so its answer differs from a JAX engine
    with the adapter merged; the port's equals a merged engine's."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_lora import write_fake_adapter

    path = write_fake_adapter(str(tmp_path / "x"), seed=1)
    req = lambda jax, **kw: [(PROMPT, _beam(8, jax=jax, num_beams=3, ignore_eos=True, **kw))]
    je = _jax(ckpt)
    jmgr = JLoraManager(2)
    jmgr.add_adapter(path, name="X")
    je.set_lora_manager(jmgr)
    cfg = tiny_config("qwen2", dtype="float32")
    jmerged = _jax(ckpt, weights=jmerge(JLoader(cfg).load(ckpt), jload(path, 2)))
    jgot = _run(je, req(True, adapter_name="X"))[0].output_token_ids
    assert jgot != _run(jmerged, req(True))[0].output_token_ids  # the fault
    te = _port(ckpt)
    mgr = LoraManager(2)
    mgr.add_adapter(path, name="X")
    te.set_lora_manager(mgr)
    tcfg = TConfig.from_pretrained(ckpt)
    tcfg.dtype = "float32"
    merged = _port(ckpt, weights=merge_lora(CheckpointLoader(tcfg, device="cpu").load(ckpt),
                                            load_peft_adapter(path, 2)))
    got = _run(te, req(False, adapter_name="X"))[0].output_token_ids
    assert got == _run(merged, req(False))[0].output_token_ids
    assert got != _run(te, req(False))[0].output_token_ids


def test_beam_over_http_answers_the_best_hypothesis(ckpt):
    """``num_beams`` through ``/v1/completions``, streamed and not: the
    whole answer in one chunk, the engine's best hypothesis."""
    te = _port(ckpt)
    want = _run(_port(ckpt), [(PROMPT, _beam(6, num_beams=3, ignore_eos=True))])[0]
    app = build_app(te, None)
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    body = {"prompt": PROMPT, "max_tokens": 6, "num_beams": 3, "temperature": 0,
            "ignore_eos": True}
    try:
        req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["choices"][0]["token_ids"] == want.output_token_ids
        req = urllib.request.Request(base + "/v1/completions",
                                     data=json.dumps(dict(body, stream=True)).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            events = [json.loads(ln[6:]) for ln in r.read().decode().split("\n")
                      if ln.startswith("data: {")]
        ids = [e["choices"][0].get("token_ids") for e in events]
        assert [i for i in ids if i] == [want.output_token_ids]
    finally:
        app.stop()
