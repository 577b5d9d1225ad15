"""The request controls of the port against the JAX package, on the CPU.

* ``sample_tokens`` with each new operand (logit bias, n-gram bans, the
  trie's allow-list, forced tokens) and all together, against the JAX
  ``sample_tokens`` on the same seeded inputs: tokens exactly, logprobs to
  1e-5, output counts exactly.
* Greedy tokens of the port's engine against the JAX engine's for logit
  bias, n-gram bans, think budgets and trie decode, at ``decode_steps`` 1 / 4
  x ``async_decode`` off / on (tiny f32 model, blocks of 4 tokens), several
  streams at once.
* ``compute_prompt_loss`` (to 1e-4) and ``generate_with_hidden`` (tokens
  exactly, hidden states to 1e-4) against the JAX engine.
* ``n`` > 1 (streamed and not), ``top_logprobs``, ``loss`` and
  ``hidden_states`` over HTTP against the JAX frontend's response, same
  checkpoint and tokenizer.
* A trie opened by the prompt constrains the first token, each such
  stream prefilled alone as in the reference.
"""

import asyncio
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import (
    tiny_config, write_fake_checkpoint, write_fake_tokenizer,
)
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.ops import sampling as jsampling
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.engine.logits_processors import (
    MAX_ALLOW, TreeDecodeConfig, TreeDecodeState,
)
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel
from rtp_llm_tpu_torch.ops import sampling

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

BS, NB, BATCH, MSL = 4, 64, 4, 96
CONFIGS = [(1, False), (1, True), (4, False), (4, True)]  # (decode_steps, async_decode)
IDS = ["n1-sync", "n1-async", "n4-sync", "n4-async"]
# greedy [1, 2, 3] on the tiny checkpoint opens with 116, then repeats 32
TRIE = {"start_token_id": 116, "end_token_id": 100, "sep": "_",
        "prefix_dict": {"": [32, 40, 7], "32": [7, 9], "32_7": [11], "40": [5],
                        "7": [50, 51], "32_9": [12, 13]}}


# ---- sample_tokens ----

V, B = 50, 6


def _sampler_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    pmask = rng.random((B, V)) < 0.1
    counts = rng.integers(0, 3, (B, V)).astype(np.int32) * (rng.random((B, V)) < 0.1)
    params = dict(
        temperature=np.ones(B, np.float32), top_k=np.zeros(B, np.int32),
        top_p=np.ones(B, np.float32), do_sample=np.zeros(B, bool),
        repetition_penalty=np.array([1.0, 1.2, 1.0, 1.3, 1.0, 1.1], np.float32),
        presence_penalty=np.array([0.0, 0.5, 0.0, 0.0, 0.2, 0.0], np.float32),
        frequency_penalty=np.array([0.0, 0.0, 0.3, 0.0, 0.0, 0.1], np.float32),
        ban_eos=np.array([False, True, False, False, True, False]))
    bias_ids = np.full((B, 32), -1, np.int64)
    bias_vals = np.zeros((B, 32), np.float32)
    for r in range(B):
        n = int(rng.integers(0, 6))
        bias_ids[r, :n] = rng.integers(0, V, n)
        bias_vals[r, :n] = rng.uniform(-6, 6, n)
    bias_ids[0, 6:8] = (bias_ids[0, 0] if bias_ids[0, 0] >= 0 else 3)  # a repeated id adds twice
    bias_vals[0, 6:8] = 2.5
    # the plain argmax of each row among its bans, so the bans change it
    ban = np.full((B, 16), -1, np.int64)
    allow = np.full((B, MAX_ALLOW), -1, np.int64)
    for r in range(B):
        n = int(rng.integers(1, 5))
        ban[r, :n] = rng.integers(0, V, n)
        ban[r, n] = int(np.argmax(logits[r]))
        if r % 2:  # the others stay unconstrained
            m = int(rng.integers(1, 8))
            allow[r, :m] = rng.integers(0, V, m)
    forced = np.array([-1, 7, -1, -1, 30, -1], np.int64)
    active = np.array([True, True, False, True, True, True])
    return logits, pmask, counts, params, dict(
        bias=dict(bias_ids=bias_ids, bias_vals=bias_vals), ban=dict(ban_tokens=ban),
        allow=dict(allow_tokens=allow), forced=dict(forced_tokens=forced)), active


OPERANDS = ["bias", "ban", "allow", "forced", "all"]


@pytest.mark.parametrize("need_stats", [True, False], ids=["stats", "no-stats"])
@pytest.mark.parametrize("operand", OPERANDS)
def test_sample_tokens_operands_match_jax(operand, need_stats):
    """Greedy rows: tokens equal, logprobs within 1e-5, the counts' update
    equal (rows in ``active`` only)."""
    logits, pmask, counts, params, ops, active = _sampler_inputs(OPERANDS.index(operand))
    kw = {}
    for name in (OPERANDS[:4] if operand == "all" else [operand]):
        kw.update(ops[name])
    jp = jsampling.SamplingParams(**{k: jnp.asarray(v) for k, v in params.items()})
    jt, jlp, jc = jsampling.sample_tokens(
        jnp.asarray(logits), jp, jnp.asarray(pmask), jnp.asarray(counts), (2,),
        jax.random.PRNGKey(0), need_sampling=False, active=jnp.asarray(active),
        need_stats=need_stats, **{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                                                  else v) for k, v in kw.items()})
    tp = sampling.SamplingParams(**{k: torch.from_numpy(v) for k, v in params.items()})
    tc = torch.from_numpy(counts.copy())
    tt, tlp = sampling.sample_tokens(
        torch.from_numpy(logits), tp, torch.from_numpy(pmask), tc, (2,), None,
        need_sampling=False, active=torch.from_numpy(active), need_stats=need_stats,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    if operand in ("forced", "all"):
        assert tt[1] == 7 and tt[4] == 30
    if operand in ("ban", "all"):
        assert all(int(tt[r]) not in ops["ban"]["ban_tokens"][r].tolist() for r in range(B)
                   if operand == "ban" or ops["forced"]["forced_tokens"][r] < 0)


def test_sample_tokens_sampled_rows_honour_the_allow_list_and_bans():
    """Sampled rows draw only among allowed, unbanned tokens; forcing wins
    over the draw (the port's generator draws other numbers than JAX's)."""
    logits, pmask, counts, params, ops, _ = _sampler_inputs(7)
    params = {**params, "do_sample": np.ones(B, bool),
              "temperature": np.full(B, 2.0, np.float32)}
    tp = sampling.SamplingParams(**{k: torch.from_numpy(v) for k, v in params.items()})
    gen = torch.Generator().manual_seed(0)
    allow, ban = ops["allow"]["allow_tokens"], ops["ban"]["ban_tokens"]
    for _ in range(20):
        tt, _ = sampling.sample_tokens(
            torch.from_numpy(logits), tp, torch.from_numpy(pmask),
            torch.from_numpy(counts.copy()), (2,), gen, need_stats=False,
            ban_tokens=torch.from_numpy(ban), allow_tokens=torch.from_numpy(allow),
            forced_tokens=torch.tensor([-1, -1, -1, -1, 30, -1]))
        for r in range(B):
            t = int(tt[r])
            if r == 4:
                assert t == 30
                continue
            assert t not in ban[r].tolist()
            if (allow[r] >= 0).any():
                assert t in allow[r].tolist()


@pytest.mark.parametrize("need_stats", [True, False], ids=["stats", "no-stats"])
def test_sample_tokens_drops_ids_outside_the_vocabulary(need_stats):
    """Bias, ban and allow ids past V or below -1 are dropped, as the JAX
    sampler's ``mode="drop"`` scatters drop them: the same tokens (exactly),
    logprobs (1e-5) and counts as JAX, and the same tokens as the operands
    without those ids. A row that allows only such ids is constrained to
    nothing (both take token 0 there)."""
    logits, pmask, counts, params, ops, active = _sampler_inputs(11)
    clean = {**ops["bias"], **ops["ban"], **ops["allow"]}
    kw = {k: v.copy() for k, v in clean.items()}
    kw["bias_ids"][:, 20] = V + np.arange(B)
    kw["bias_ids"][:, 21] = -3
    kw["bias_vals"][:, 20:22] = 50.0
    kw["ban_tokens"][:, 15] = V + 7
    kw["allow_tokens"][1, 40:42] = [V, V + 40]
    kw["allow_tokens"][3] = -1
    kw["allow_tokens"][3, :2] = [V + 1, 2 * V]

    def port(operands):
        tp = sampling.SamplingParams(**{k: torch.from_numpy(v) for k, v in params.items()})
        tc = torch.from_numpy(counts.copy())
        tt, tlp = sampling.sample_tokens(
            torch.from_numpy(logits), tp, torch.from_numpy(pmask), tc, (2,), None,
            need_sampling=False, active=torch.from_numpy(active), need_stats=need_stats,
            **{k: torch.from_numpy(v) for k, v in operands.items()})
        return tt, tlp, tc
    jp = jsampling.SamplingParams(**{k: jnp.asarray(v) for k, v in params.items()})
    jt, jlp, jc = jsampling.sample_tokens(
        jnp.asarray(logits), jp, jnp.asarray(pmask), jnp.asarray(counts), (2,),
        jax.random.PRNGKey(0), need_sampling=False, active=jnp.asarray(active),
        need_stats=need_stats, **{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                                                  else v) for k, v in kw.items()})
    tt, tlp, tc = port(kw)
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    want = port(clean)[0].tolist()
    assert tt[3] == 0 and [t for r, t in enumerate(tt.tolist()) if r != 3] == [
        t for r, t in enumerate(want) if r != 3]


# ---- engines ----

def _port(ckpt, steps, asy, tree_path="", buckets=(16, 64)):
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL,
                                  prefill_buckets=buckets, decode_steps=steps,
                                  async_decode=asy),
        quant=QuantConfig(kv_cache_dtype="float32"), tree_decode_config_path=tree_path)
    weights = CheckpointLoader(cfg, device="cpu").load(ckpt)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), weights, econf, device="cpu")


def _jax(ckpt, steps, asy, tree_path=""):
    cfg = tiny_config("qwen2", dtype="float32")
    econf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=NB),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64),
                         decode_steps=steps, async_decode=asy),
        tree_decode_config_path=tree_path)
    econf.quant.kv_cache_dtype = "float32"
    return JEngine(create_model(cfg), JLoader(cfg).load(ckpt), econf)


def _run(engine, reqs, gen_cls, steps=400):
    streams = [engine.enqueue(p, gen_cls(**kw)) for p, kw in reqs]
    for _ in range(steps):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
    assert all(s.is_finished() for s in streams)
    return [s.output_token_ids for s in streams]


def _drained(te):
    for _ in range(20):
        if not te.has_work():
            break
        te.step()
    assert not te.has_work()
    assert sorted(te._free_slots) == list(range(BATCH))


def _greedy(n, **kw):
    return dict(max_new_tokens=n, do_sample=False, ignore_eos=True, **kw)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("ctl")), tiny_config("qwen2"))


@pytest.fixture(scope="module")
def tree_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("trie") / "trie.json"
    path.write_text(json.dumps(TRIE))
    return str(path)


@pytest.fixture(scope="module")
def engines(ckpt, tree_path):
    """(JAX engine, port engine) of one configuration, built once for the
    module; ``tree`` ones load the trie."""
    cache = {}

    def get(steps, asy, tree=False):
        key = (steps, asy, tree)
        if key not in cache:
            path = tree_path if tree else ""
            cache[key] = (_jax(ckpt, steps, asy, path), _port(ckpt, steps, asy, path))
        return cache[key]
    return get


CONTROL_REQS = {
    # a bias that reshapes the output without pinning it, beside a plain row
    "logit_bias": [([1, 2, 3], _greedy(12, logit_bias={"32": -4.0, "59": 2.0, 116: -1.5})),
                   ([5, 9, 42, 7, 11, 3], _greedy(9)),
                   ([7, 7, 1, 2], _greedy(10, logit_bias={59: -50.0, "65": 1.0}))],
    "no_repeat_ngram_size": [([1, 2, 3], _greedy(14, no_repeat_ngram_size=2)),
                             ([7, 7, 1, 2], _greedy(11, no_repeat_ngram_size=3)),
                             ([5, 9, 42, 7, 11, 3], _greedy(8))],
    # budgets that run out at different steps: one slot's change rewrites
    # the others' forcing too (the reference's rule)
    "max_thinking_tokens": [
        ([1, 2, 3], _greedy(16, max_thinking_tokens=2, think_start_token_id=116,
                            think_end_token_id=100)),
        ([5, 9, 42, 7, 11, 3], _greedy(14, max_thinking_tokens=3, think_start_token_id=65,
                                       think_end_token_id=101)),
        ([7, 7, 1, 2], _greedy(12, max_thinking_tokens=1, think_start_token_id=59,
                               think_end_token_id=59))],
    "trie": [([1, 2, 3], _greedy(14)), ([5, 9, 42, 7, 11, 3], _greedy(10)),
             ([7, 7, 1, 2], _greedy(9, logit_bias={"116": 30.0}))],
}


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
@pytest.mark.parametrize("control", sorted(CONTROL_REQS))
def test_control_greedy_tokens_match_jax(engines, control, steps, asy):
    je, te = engines(steps, asy, tree=control == "trie")
    reqs = CONTROL_REQS[control]
    want = _run(je, reqs, JGen)
    got = _run(te, reqs, GenerateConfig)
    assert got == want
    _drained(te)
    if control == "trie":  # every token after a start follows the trie
        for out in got:
            walk = TreeDecodeState(TreeDecodeConfig(**TRIE))
            for t in out:
                allowed = walk.allowed()
                assert allowed is None or t in allowed
                walk.update(t)
        assert 116 in got[0] and 116 in got[2]


# prompts and controls naming an id outside the tiny vocabulary (128)
BAD_IDS = {
    "prompt": ([1, 2, 128], {}),
    "prompt-negative": ([1, -2, 3], {}),
    "logit_bias": ([1, 2, 3], {"logit_bias": {"5": 1.0, "128": 5.0}}),
    "think_end_token_id": ([1, 2, 3], {"max_thinking_tokens": 1, "think_start_token_id": 116,
                                       "think_end_token_id": 300}),
}


@pytest.mark.parametrize("case", sorted(BAD_IDS))
def test_token_ids_outside_the_vocabulary_are_refused(engines, case):
    """``enqueue`` hands such a request back aborted with its error and
    queues nothing (on the card the id would index past the embedding or a
    scatter and fail the device); a stream beside it runs as it does alone.
    The teacher-forced loops raise ValueError."""
    _, te = engines(1, True)
    prompt, kw = BAD_IDS[case]
    alone = _run(te, [([5, 9, 42], _greedy(6))], GenerateConfig)
    good = te.enqueue([5, 9, 42], GenerateConfig(**_greedy(6)))
    bad = te.enqueue(prompt, GenerateConfig(**_greedy(6, **kw)))
    assert bad.is_finished() and "outside the vocabulary" in bad.error
    assert bad not in te.scheduler.waiting
    for _ in range(50):
        if good.is_finished():
            break
        te.step()
    assert [good.output_token_ids] == alone and good.error is None
    with pytest.raises(ValueError, match="outside the vocabulary"):
        te.generate_with_hidden(prompt, GenerateConfig(**_greedy(2, **kw)))
    if not kw:
        with pytest.raises(ValueError, match="outside the vocabulary"):
            te.compute_prompt_loss(prompt)
    _drained(te)


def test_trie_with_ids_outside_the_vocabulary_is_refused_at_load(ckpt, tmp_path):
    path = tmp_path / "trie.json"
    path.write_text(json.dumps({**TRIE, "prefix_dict": {"": [32, 500]}}))
    with pytest.raises(ValueError, match="outside the vocabulary"):
        _port(ckpt, 1, True, tree_path=str(path))


@pytest.mark.parametrize("fields", [
    {"logit_bias": {"abc": 1.0}}, {"logit_bias": {"5": "x"}}, {"logit_bias": {"5": float("nan")}},
    {"logit_bias": [5, 1.0]}, {"no_repeat_ngram_size": "3"}, {"max_thinking_tokens": -1},
    {"think_end_token_id": "7"}, {"top_logprobs": 1.5}], ids=lambda f: repr(f))
def test_malformed_control_values_are_refused(fields):
    """A value the engine's loop could not read raises ValueError at the
    request (HTTP 400), not later inside a step with the whole batch."""
    with pytest.raises(ValueError):
        GenerateConfig.from_dict(fields)


def test_controls_change_the_output(engines):
    """Each control's requests answer otherwise than without it (so the
    comparisons above see the control at work)."""
    _, te = engines(1, True)
    for control, reqs in CONTROL_REQS.items():
        if control == "trie":
            continue
        plain = [(p, _greedy(kw["max_new_tokens"])) for p, kw in reqs]
        assert _run(te, reqs, GenerateConfig) != _run(te, plain, GenerateConfig), control
    _, tt = engines(1, True, tree=True)
    _, pt = engines(1, True)
    reqs = CONTROL_REQS["trie"]
    assert _run(tt, reqs, GenerateConfig) != _run(pt, reqs, GenerateConfig)


def test_trie_opened_by_the_prompt_constrains_the_first_token(engines):
    """A prompt that opens the trie's region constrains the first token. As
    in the reference, a stream with a trie walk prefills alone (never in a
    packed group), so two such prompts together get the same allowed first
    token as one alone, and the reference's tokens."""
    je, te = engines(1, False, tree=True)
    prompt = [5, 9, 42, 7, 11, 3, 116]  # greedy goes on with 105, outside the trie
    allowed = TRIE["prefix_dict"][""] + [TRIE["end_token_id"]]
    reqs = [(prompt, _greedy(3)), (prompt, _greedy(3))]
    want = _run(je, reqs, JGen)
    got = _run(te, reqs, GenerateConfig)
    assert got == want
    assert all(out[0] in allowed for out in got)
    assert got == [_run(te, reqs[:1], GenerateConfig)[0]] * 2


@pytest.mark.parametrize("prompt_len", [5, 40, 64])
def test_prompt_loss_matches_jax(engines, ckpt, prompt_len):
    """Per-token NLL within 1e-4 (f32 weights), ``[len(prompt) - 1]``."""
    je, te = engines(1, True)
    prompt = np.random.default_rng(prompt_len).integers(1, 128, prompt_len).tolist()
    want = np.asarray(je.compute_prompt_loss(prompt))
    got = te.compute_prompt_loss(prompt)
    assert got.shape == (prompt_len - 1,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert te.cache_mgr.pool.used_blocks == len(te.cache_mgr.prefix_cache)


def test_prompt_loss_of_a_chunked_prompt(ckpt):
    """A prompt past the largest prefill bucket goes in chunks: the same
    NLL (1e-4) as one forward over it (the reference's loss loop takes
    such a prompt the same way)."""
    prompt = np.random.default_rng(1).integers(1, 128, 70).tolist()
    chunked = _port(ckpt, 1, True).compute_prompt_loss(prompt)
    whole = _port(ckpt, 1, True, buckets=(16, 128)).compute_prompt_loss(prompt)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("prompt_len,n_out", [(3, 8), (37, 5)])
def test_generate_with_hidden_matches_jax(engines, prompt_len, n_out):
    """Greedy tokens equal, hidden states ``[n_out, H]`` within 1e-4; the
    private allocation is freed."""
    je, te = engines(1, True)
    prompt = np.random.default_rng(prompt_len).integers(1, 128, prompt_len).tolist()
    js, jh = je.generate_with_hidden(prompt, JGen(**_greedy(n_out)))
    ts, th = te.generate_with_hidden(prompt, GenerateConfig(**_greedy(n_out)))
    assert ts.output_token_ids == js.output_token_ids
    assert th.shape == (n_out, 64) and th.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    assert ts.finish_reason.value == js.finish_reason.value == "length"
    assert te.cache_mgr.pool.used_blocks == len(te.cache_mgr.prefix_cache)


def test_generate_with_hidden_of_a_chunked_prompt(ckpt):
    """A prompt past the largest bucket goes in chunks: tokens equal and
    hidden states within 1e-4 of one forward over it."""
    prompt = np.random.default_rng(2).integers(1, 128, 70).tolist()
    cfg = GenerateConfig(**_greedy(4))
    s1, h1 = _port(ckpt, 1, True).generate_with_hidden(prompt, cfg)
    s2, h2 = _port(ckpt, 1, True, buckets=(16, 128)).generate_with_hidden(prompt, cfg)
    assert s1.output_token_ids == s2.output_token_ids
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=1e-4, rtol=0)


def test_warmup_runs_prefill_at_each_group_size(ckpt):
    """warmup() runs one prefill forward at 1, 2 and PREFILL_PACK rows into
    the null block, and touches no allocated block."""
    te = _port(ckpt, 1, True)
    rows, forward = [], te.model.forward

    def spy(weights, cache, inputs, **kw):
        rows.append(len(inputs.row_lens) if inputs.row_lens else None)
        assert not inputs.block_tables.any()
        return forward(weights, cache, inputs, **kw)
    te.model.forward = spy
    te.warmup()
    assert rows == [1, 2, te.PREFILL_PACK]
    assert te.cache_mgr.pool.used_blocks == 0


class _GraphRecorder:
    """Stands in for the card's graph cache: records what is captured, and
    from which thread."""

    def __init__(self):
        self.keys, self.threads = [], set()

    def __contains__(self, key):
        return key in self.keys

    def ready_thread(self):
        pass

    def capture(self, key):
        import threading

        self.keys.append(key)
        self.threads.add(threading.current_thread().name)


@pytest.mark.parametrize("steps", [1, 4])
def test_warmup_readies_every_window_serving_dispatches(ckpt, tree_path, steps):
    """warmup() captures the common windows itself and the rest (stats,
    constrained) on a background thread under the device lock; after it, a
    serving pass with penalties, logprobs, top_logprobs, n-gram bans, think
    budgets and a trie dispatches no window that warmup did not ready, so
    nothing is captured at first use."""
    te = _port(ckpt, steps, True, tree_path=tree_path)
    te._graphs = rec = _GraphRecorder()
    te.warmup()
    te.wait_warmup_complete()
    assert len(rec.keys) == len(set(rec.keys)) == len(te.warm_keys)
    assert rec.threads == {"MainThread", "decode-graph-warmup"}
    assert {k for k in te.warm_keys if k[2] or k[4]} == set(te._decode_warmup_keys(tail=True))
    reqs = [([1, 2, 3], _greedy(20, repetition_penalty=1.3)),
            ([5, 9, 42, 7, 11, 3], _greedy(12, return_logprobs=True, top_logprobs=2)),
            ([7, 7, 1, 2], dict(max_new_tokens=9, do_sample=True, temperature=0.8,
                                no_repeat_ngram_size=2)),
            ([9, 8, 7], _greedy(10, max_thinking_tokens=1, think_start_token_id=116,
                                think_end_token_id=100))]
    _run(te, reqs, GenerateConfig)
    plain = [([4, 5], _greedy(6)), ([6, 7, 8], _greedy(9, frequency_penalty=0.5))]
    te.tree_config = None  # the same engine without its trie: multi-step windows
    _run(te, plain, GenerateConfig)
    assert te.decode_keys <= te.warm_keys
    assert any(k[4] for k in te.decode_keys) and any(k[2] and not k[4] for k in te.decode_keys)
    assert any(k[3] == steps for k in te.decode_keys)


def test_warmup_without_tail_captures_only_the_common_windows(ckpt):
    """``warmup(tail=False)`` starts no background thread: the stats and
    constrained windows are left to first use."""
    te = _port(ckpt, 4, True)
    te._graphs = rec = _GraphRecorder()
    te.warmup(tail=False)
    te.wait_warmup_complete()
    assert te._warmup_thread is None
    assert rec.keys == te._decode_warmup_keys(tail=False) and rec.threads == {"MainThread"}


class _FailingRecorder(_GraphRecorder):
    def capture(self, key):
        if key[2]:
            raise RuntimeError("capture of a stats window failed")
        super().capture(key)


def test_failed_background_capture_is_reported(ckpt):
    """A capture that fails on the background thread is kept:
    ``wait_warmup_complete`` raises it, /health answers 503 and
    /worker_status says the engine is not alive."""
    from rtp_llm_tpu_torch.frontend.openai_api import build_app

    te = _port(ckpt, 1, True)
    te._graphs = _FailingRecorder()
    te.warmup()
    with pytest.raises(RuntimeError, match="warmup failed"):
        te.wait_warmup_complete()
    app = build_app(te)
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/health", timeout=60)
        assert e.value.code == 503 and b"stats window failed" in e.value.read()
        with urllib.request.urlopen(base + "/worker_status", timeout=60) as r:
            assert json.loads(r.read())["alive"] is False
    finally:
        app.stop()


@pytest.mark.parametrize("logprobs", [False, True], ids=["no-stats", "stats"])
def test_constrained_windows_follow_need_stats(engines, logprobs):
    """An n-gram-banned step replays the constrained window of its own
    ``need_stats`` (the reference's ``_decode_jit`` follows it too): greedy
    tokens equal JAX's, and with logprobs those within 1e-4."""
    je, te = engines(1, False)
    te.decode_keys.clear()
    reqs = [([1, 2, 3], _greedy(10, no_repeat_ngram_size=2, return_logprobs=logprobs))]
    js = [je.enqueue(p, JGen(**kw)) for p, kw in reqs]
    ts = [te.enqueue(p, GenerateConfig(**kw)) for p, kw in reqs]
    for _ in range(100):
        if all(s.is_finished() for s in js + ts):
            break
        je.step()
        te.step()
    assert [s.output_token_ids for s in ts] == [s.output_token_ids for s in js]
    assert {k[2] for k in te.decode_keys if k[4]} == {logprobs}
    if logprobs:
        np.testing.assert_allclose(ts[0].output_logprobs, js[0].output_logprobs,
                                   atol=1e-4, rtol=0)
        assert len(ts[0].output_logprobs) == 10


# ---- HTTP against the JAX frontend ----

def _shape(obj):
    """A response's structure: dict keys and value types, lists by their
    first element."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__


def _covers(port, ref):
    """The port's structure holds the reference's (it may add keys)."""
    if isinstance(ref, dict):
        return isinstance(port, dict) and all(k in port and _covers(port[k], v)
                                              for k, v in ref.items())
    if isinstance(ref, list):
        return isinstance(port, list) and (not ref or not port or _covers(port[0], ref[0]))
    return port == ref or {port, ref} <= {"int", "float"}


@pytest.fixture(scope="module")
def both_apps(tmp_path_factory):
    """(post to the port, post to the JAX app) on one checkpoint and one
    tokenizer."""
    from aiohttp.test_utils import TestClient, TestServer

    from rtp_llm_tpu.frontend.openai_api import OpenAIApp as JApp
    from rtp_llm_tpu.frontend.tokenizer_factory import TokenizerFactory as JTok
    from rtp_llm_tpu.server.engine_runner import EngineRunner as JRunner
    from rtp_llm_tpu_torch.frontend.openai_api import build_app
    from rtp_llm_tpu_torch.frontend.tokenizer_factory import TokenizerFactory

    path = str(tmp_path_factory.mktemp("http"))
    write_fake_checkpoint(path, tiny_config("qwen2"))
    write_fake_tokenizer(path, 128)
    app = build_app(_port(path, 1, True), TokenizerFactory.create(path))
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    runner = JRunner(_jax(path, 1, True)).start()
    japp = JApp(runner, JTok.create(path), model_name="tiny", model_type="qwen2")
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(japp.build_app()), loop=loop)
    loop.run_until_complete(client.start_server())

    def port_post(route, body):
        req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()

    def jax_post(route, body):
        async def go():
            r = await client.post(route, json=body)
            return r.status, await r.read()
        return loop.run_until_complete(go())

    yield port_post, jax_post
    loop.run_until_complete(client.close())
    loop.close()
    runner.stop()
    app.stop()


def _sse(raw):
    events = [ln[len("data: "):] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


CHAT = {"messages": [{"role": "user", "content": "w1 w2 w3"}]}
HTTP_CASES = {
    "n3": ("/v1/completions", {"prompt": [1, 2, 3], "n": 3}),
    "n3-chat": ("/v1/chat/completions", {**CHAT, "n": 3}),
    "top_logprobs-chat": ("/v1/chat/completions", {**CHAT, "top_logprobs": 2, "logprobs": True}),
    "logprobs": ("/v1/completions", {"prompt": [1, 2, 3], "logprobs": True}),
    "loss1": ("/v1/completions", {"prompt": [1, 5, 9, 42, 7], "calculate_loss": 1}),
    "loss2": ("/v1/completions", {"prompt": [1, 5, 9, 42, 7], "calculate_loss": 2}),
    "hidden": ("/v1/completions", {"prompt": [1, 2, 3], "return_hidden_states": True}),
    "hidden-chat-loss": ("/v1/chat/completions", {**CHAT, "return_hidden_states": True,
                                                  "calculate_loss": 2}),
}


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_http_controls_match_the_jax_frontend(both_apps, case):
    """The same greedy request to both servers: 200, the reference's
    response structure (the port adds ``token_ids`` and cached tokens),
    the same choices' texts, ``loss`` within 1e-4 and ``hidden_states``
    within 1e-4."""
    port_post, jax_post = both_apps
    route, body = HTTP_CASES[case]
    body = {**body, "max_tokens": 6, "temperature": 0, "ignore_eos": True}
    (ps, praw), (js, jraw) = port_post(route, body), jax_post(route, body)
    assert ps == js == 200
    got, want = json.loads(praw), json.loads(jraw)
    assert _covers(_shape(got), _shape(want)), (_shape(got), _shape(want))
    text = (lambda c: c["message"]["content"]) if "chat" in route else (lambda c: c["text"])
    assert [text(c) for c in got["choices"]] == [text(c) for c in want["choices"]]
    assert [c["index"] for c in got["choices"]] == list(range(body.get("n", 1)))
    if "loss" in want:
        np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4, rtol=0)
    if "hidden_states" in want["choices"][0]:
        np.testing.assert_allclose(got["choices"][0]["hidden_states"],
                                   want["choices"][0]["hidden_states"], atol=1e-4, rtol=0)
        assert len(got["choices"][0]["hidden_states"]) == 6
    if case == "top_logprobs-chat":
        content = got["choices"][0]["logprobs"]["content"]
        assert len(content) == 6 and all(e["top_logprobs"] == [] for e in content)
        np.testing.assert_allclose([e["logprob"] for e in content],
                                   [e["logprob"] for e in want["choices"][0]["logprobs"]["content"]],
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("route", ["/v1/completions", "/v1/chat/completions"])
def test_http_streamed_fanout_matches_the_jax_frontend(both_apps, route):
    """``n`` = 3 streamed: every choice's chunks carry its index, each ends
    with a finish reason, ``[DONE]`` comes last, and each choice's text is
    the reference's (greedy, so all three agree)."""
    port_post, jax_post = both_apps
    body = {**(CHAT if "chat" in route else {"prompt": [1, 2, 3]}), "n": 3, "stream": True,
            "max_tokens": 5, "temperature": 0, "ignore_eos": True}
    texts, fins = [], []
    for post in (port_post, jax_post):
        status, raw = post(route, body)
        assert status == 200
        t, f = {0: "", 1: "", 2: ""}, {}
        for c in _sse(raw):
            ch = c["choices"][0]
            t[ch["index"]] += (ch.get("delta", {}).get("content") or "") if "chat" in route \
                else ch.get("text", "")
            if ch.get("finish_reason"):
                f[ch["index"]] = ch["finish_reason"]
        texts.append(t)
        fins.append(f)
    assert fins[0] == fins[1] == {0: "length", 1: "length", 2: "length"}
    assert texts[0] == texts[1] and texts[0][0] == texts[0][1] == texts[0][2] != ""
