"""gemma and gemma2 in the port against the JAX package, on the CPU at tiny
shapes (f32).

The checkpoints are written by HF ``transformers`` (``GemmaForCausalLM`` /
``Gemma2ForCausalLM`` at a tiny config, ``save_pretrained``), with every
RMSNorm weight drawn away from HF's zero init so that the load-time ``1 +
w`` fold is visible, weights of std 0.2 and small soft-caps (attention 2.0,
final 3.0) that the scores and logits reach many times over. gemma2's
window (6 tokens) slides on the even layers: its engines keep those layers'
K/V in rings of ``ceil((6 + 16) / 4) + 1 = 7`` blocks a decode slot (blocks
of 4, largest prefill chunk 16), which a 40-token prompt wraps.

Checked: configs field by field, loaded weights bit for bit, forward logits
within 1e-4 over a prefill that crosses the window and two decode steps
(also on int8 and fp8 pools), both caps changing the logits by far more than
that, the ring tables and pool shapes, engine greedy tokens at
``decode_steps`` 1 / 4 x ``async_decode`` off / on beside the JAX engine, a
preempted stream re-admitted into another slot, int8 / fp8 pools, the beam
and speculative refusals, auto-sizing with the rings, the prompt loss and
the teacher-forced loop on a borrowed slot.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.config.model_config import ModelConfig as JConfig
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu.ops.attention.ref import paged_attention_ref as jax_attention_ref
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig, SpeculativeConfig,
)
from rtp_llm_tpu_torch.config import model_config as tmc
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.ops.attention import paged_attention
from rtp_llm_tpu_torch.ops.attention import decode as tdecode
from rtp_llm_tpu_torch.ops.attention import prefill as tprefill
from rtp_llm_tpu_torch.ops.kv_cache import FP8, SplitPool
from rtp_llm_tpu_torch.server.server import build_engine
from tests.test_torch_gptq_awq import assert_same_weights

BS, NB, BATCH, MSL = 4, 40, 4, 64
BUCKETS = (8, 16)
WINDOW, ATTN_CAP, FINAL_CAP = 6, 2.0, 3.0
NRING = -(-(WINDOW + BUCKETS[-1]) // BS) + 1  # 7 blocks, 28 tokens a ring
PROMPT = [1, 5, 9, 42, 7, 3, 11, 60, 2, 33, 17, 8]
LONG = [(7 * i + 3) % 90 + 1 for i in range(40)]  # past window + span: a ring wraps
CONFIGS = [(1, False), (1, True), (4, False), (4, True)]  # (decode_steps, async_decode)
IDS = ["n1-sync", "n1-async", "n4-sync", "n4-async"]
TYPES = ("gemma", "gemma2")
TOL = dict(rtol=1e-4, atol=1e-4)


def write_checkpoint(root: str, mt: str, caps=(ATTN_CAP, FINAL_CAP)) -> str:
    """A tiny HF checkpoint of ``mt`` (2 layers for gemma, 4 for gemma2),
    norms drawn from U(-0.5, 0.5), linears and embeddings N(0, 0.2^2)."""
    from transformers import Gemma2Config, Gemma2ForCausalLM, GemmaConfig, GemmaForCausalLM

    common = dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_attention_heads=4,
                  head_dim=16, max_position_embeddings=256, rms_norm_eps=1e-6,
                  initializer_range=0.2, eos_token_id=2, bos_token_id=1, pad_token_id=0)
    if mt == "gemma":
        cfg, cls = GemmaConfig(num_hidden_layers=2, num_key_value_heads=4, **common), \
            GemmaForCausalLM
    else:
        cfg, cls = Gemma2Config(num_hidden_layers=4, num_key_value_heads=2,
                                sliding_window=WINDOW, query_pre_attn_scalar=24,
                                attn_logit_softcapping=caps[0] or None,
                                final_logit_softcapping=caps[1] or None, **common), \
            Gemma2ForCausalLM
    torch.manual_seed(0)
    model = cls(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.uniform_(-0.5, 0.5)
    path = os.path.join(root, mt if caps == (ATTN_CAP, FINAL_CAP) else f"{mt}-uncapped")
    model.save_pretrained(path, safe_serialization=True)
    return path


def port_config(path: str) -> TConfig:
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def jax_config(path: str) -> JConfig:
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gemma"))
    out = {}
    for mt in TYPES:
        path = write_checkpoint(root, mt)
        out[mt] = (path, JLoader(jax_config(path)).load(path),
                   TLoader(port_config(path), device="cpu").load(path))
    return out


# ---- configs, presets, weights ----


@pytest.mark.parametrize("mt", TYPES)
def test_config_equals_jax_field_by_field(mt, ckpts):
    path = ckpts[mt][0]
    port, jax_cfg = port_config(path), jax_config(path)
    for f in dataclasses.fields(TConfig):
        assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    assert port.hidden_act == "gelu_tanh" and port.norm_unit_offset and port.scale_embeddings
    assert port.tie_word_embeddings
    if mt == "gemma2":
        assert (port.sandwich_norms, port.attn_soft_cap, port.final_logit_soft_cap,
                port.query_pre_attn_scalar, port.sliding_window,
                port.sliding_window_pattern) == (True, ATTN_CAP, FINAL_CAP, 24, WINDOW, 2)
        assert [port.is_swa_layer(i) for i in range(4)] == [True, False, True, False]
    else:
        assert port.sliding_window == 0 and not port.sandwich_norms


# the published config.json of HF google/gemma-2-9b and google/gemma-7b
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "attn_logit_softcapping": 50.0, "bos_token_id": 2, "cache_implementation": "hybrid",
    "eos_token_id": 1, "final_logit_softcapping": 30.0, "head_dim": 256,
    "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh",
    "hidden_size": 3584, "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 8192, "model_type": "gemma2", "num_attention_heads": 16,
    "num_hidden_layers": 42, "num_key_value_heads": 8, "pad_token_id": 0,
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
    "sliding_window": 4096, "sliding_window_size": 4096, "torch_dtype": "float32",
    "use_cache": True, "vocab_size": 256000}
GEMMA_7B = {
    "architectures": ["GemmaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 2, "eos_token_id": 1, "head_dim": 256, "hidden_act": "gelu",
    "hidden_size": 3072, "initializer_range": 0.02, "intermediate_size": 24576,
    "max_position_embeddings": 8192, "model_type": "gemma", "num_attention_heads": 16,
    "num_hidden_layers": 28, "num_key_value_heads": 16, "pad_token_id": 0, "rms_norm_eps": 1e-06,
    "rope_scaling": None, "rope_theta": 10000.0, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 256000}


@pytest.mark.parametrize("preset,hf", [("gemma2_9b_config", GEMMA2_9B),
                                       ("gemma_7b_config", GEMMA_7B)])
def test_presets_equal_the_published_configs(preset, hf):
    cfg = getattr(tmc, preset)()
    assert TConfig.from_hf_config(hf) == cfg
    jax_cfg = JConfig.from_hf_config(hf)
    for f in dataclasses.fields(TConfig):
        assert getattr(cfg, f.name) == getattr(jax_cfg, f.name), f.name
    hq, hkv = cfg.num_attention_heads, cfg.num_kv_heads
    tdecode.check_head(cfg.head_dim, hq, hkv, "paged_decode")  # the kernels take its heads
    assert tprefill.tile_plan(1, 2048, hq, hkv, cfg.head_dim).smem_bytes <= 232448
    model = LlamaFamilyModel(dataclasses.replace(cfg, num_layers=4), device="meta")
    assert model.swa_split == (preset == "gemma2_9b_config")
    assert model.sm_scale == 256 ** -0.5


@pytest.mark.parametrize("mt", TYPES)
def test_loaded_weights_equal_jax(mt, ckpts):
    """Bit for bit: the ``+1`` fold in f32 before the cast, the sandwich
    norms, no ``lm_head`` (tied)."""
    _, jw, tw = ckpts[mt]
    assert_same_weights(tw, jw)
    assert "lm_head" not in tw
    assert ("pre_ffn_norm" in tw and "post_ffn_norm" in tw) == (mt == "gemma2")
    # the fold: every norm is 1 + U(-0.5, 0.5)
    assert 0.5 <= float(tw["input_norm"].min()) and float(tw["input_norm"].max()) <= 1.5


# ---- forward ----


def _steps(b_tables):
    """(JAX inputs, port inputs) of a 12-token prefill over the 6-token
    window, then two decode steps."""
    t = len(PROMPT)
    rows = [dict(tokens=np.asarray([PROMPT], np.int32),
                 positions=np.arange(t, dtype=np.int32)[None], block_tables=b_tables,
                 kv_lens=np.asarray([t], np.int32), q_offsets=np.asarray([0], np.int32))]
    for j, tok in enumerate((13, 21)):
        rows.append(dict(tokens=np.asarray([[tok]], np.int32),
                         positions=np.asarray([[t + j]], np.int32), block_tables=b_tables,
                         kv_lens=np.asarray([t + j + 1], np.int32),
                         q_offsets=np.asarray([t + j], np.int32)))
    return ([JInputs(**{k: jnp.asarray(v) for k, v in r.items()}) for r in rows],
            [ModelInputs(**{k: torch.from_numpy(v) for k, v in r.items()}) for r in rows])


def _port_logits(path, tw, kv="float32", **cfg_kw):
    cfg = dataclasses.replace(port_config(path), **cfg_kw)
    model = LlamaFamilyModel(cfg, device="cpu")
    fused = model.fuse_weights(dict(tw))
    dtype = {"float32": torch.float32, "int8": torch.int8, "fp8": FP8}[kv]
    cache = model.init_cache(8, BS, dtype)
    out = []
    for tin in _steps(np.arange(1, 6, dtype=np.int32)[None])[1]:
        o, cache = model.forward(fused, cache, tin)
        out.append(o.logits)
    return out


@pytest.mark.parametrize("kv", ["float32", "int8", "fp8"])
@pytest.mark.parametrize("mt", TYPES)
def test_forward_logits_match_jax(mt, kv, ckpts):
    """Prefill and decode logits against the JAX ``LlamaFamilyModel`` (its
    split cache for gemma2), 1e-4 in f32 (the two sum in different orders);
    on int8 and fp8 pools too."""
    path, jw, tw = ckpts[mt]
    jmodel = create_model(jax_config(path))
    jdt = {"float32": jnp.float32, "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv]
    jcache = jmodel.init_cache(8, BS, jdt)
    want = []
    for jin in _steps(np.arange(1, 6, dtype=np.int32)[None])[0]:
        jout, jcache = jmodel.forward(jw, jcache, jin)
        want.append(np.asarray(jout.logits))
    for got, w in zip(_port_logits(path, tw, kv), want):
        np.testing.assert_allclose(got.numpy(), w, **TOL)
    # the final cap binds: every logit within it
    if mt == "gemma2":
        assert max(float(np.abs(w).max()) for w in want) < FINAL_CAP


@pytest.mark.parametrize("cap", ["attn_soft_cap", "final_logit_soft_cap"])
def test_each_cap_moves_the_logits_far_past_the_tolerance(cap, ckpts):
    """A cap that never binds tests nothing: with either cap taken out, the
    logits move by more than 100 times the forward tolerance."""
    path, _, tw = ckpts["gemma2"]
    capped = _port_logits(path, tw)
    uncapped = _port_logits(path, tw, **{cap: 0.0})
    moved = max(float((a - b).abs().max()) for a, b in zip(capped, uncapped))
    assert moved > 100 * TOL["atol"], moved


def test_soft_capped_attention_matches_jax_reference():
    """The plain attention's cap against the JAX ``paged_attention_ref``,
    the deferred current token's score capped too."""
    rng = np.random.default_rng(0)
    b, hq, hkv, d, nb = 2, 4, 2, 16, 6
    q = (3 * rng.standard_normal((b, 1, hq, d))).astype(np.float32)
    k = rng.standard_normal((nb * BS, hkv * d)).astype(np.float32)
    v = rng.standard_normal((nb * BS, hkv * d)).astype(np.float32)
    bt = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32)
    lens = np.asarray([11, 6], np.int32)
    ck = rng.standard_normal((b, hkv * d)).astype(np.float32)
    cv = rng.standard_normal((b, hkv * d)).astype(np.float32)
    for cur in (False, True):
        kw = dict(cur_k=ck, cur_v=cv) if cur else {}
        want = jax_attention_ref(*(jnp.asarray(a) for a in (q, k, v, bt, lens, lens - 1)), 0.25,
                                 block_size=BS, soft_cap=ATTN_CAP,
                                 **{n: jnp.asarray(a) for n, a in kw.items()})
        got = paged_attention(*(torch.from_numpy(a) for a in (q, k, v, bt, lens, lens - 1)), 0.25,
                              BS, soft_cap=ATTN_CAP,
                              **{n: torch.from_numpy(a) for n, a in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ring_tables_and_pool_shapes(ckpts):
    """The split pools beside the JAX model's: the paged pool of the global
    layers, the rings of the sliding layers (one more block: the ring pool's
    null block, where dropped writes go), the same ring count and ring
    table, and the write slots of a prefill that wraps the ring."""
    path, _, _ = ckpts["gemma2"]
    jmodel = create_model(jax_config(path))
    jmodel.swa_prefill_span = BUCKETS[-1]
    jcache = jmodel.init_cache(NB, BS, jnp.float32, max_slots=BATCH)
    model = LlamaFamilyModel(port_config(path), device="cpu")
    model.swa_prefill_span = BUCKETS[-1]
    cache = model.init_cache(NB, BS, torch.float32, max_slots=BATCH)
    assert isinstance(cache, SplitPool) and not isinstance(cache, dict)
    assert model.swa_nring == jmodel.swa_nring == NRING
    assert tuple(cache.full.shape) == jcache["full"].shape
    ls, two, nsw, hd = jcache["swa"].shape
    assert tuple(cache.swa.shape) == (ls, two, nsw + BS, hd)
    assert model._swa_pos == jmodel._swa_pos and model._full_pos == jmodel._full_pos
    # the ring table of slots (2, 0) over 16 table columns, and the slots a
    # 40-token row writes (the last (NRING - 1) * BS positions)
    mb, t = 16, len(LONG)
    inputs = ModelInputs(tokens=torch.zeros((2, t)), positions=torch.arange(t)[None].repeat(2, 1),
                         block_tables=torch.zeros((2, mb), dtype=torch.int32),
                         kv_lens=torch.tensor([t, t], dtype=torch.int32),
                         q_offsets=torch.zeros(2, dtype=torch.int32),
                         state_slots=torch.tensor([2, 0]))
    sites = model._attention_sites(cache, inputs, inputs.state_slots, None,
                                   inputs.positions.reshape(-1), None, (2, t))
    _, li, table, ring_slots, null, window = sites[0]
    want_table = np.asarray([2, 0])[:, None] * NRING + np.arange(mb)[None] % NRING
    np.testing.assert_array_equal(table.numpy(), want_table)
    assert window == WINDOW and li == 0 and null == BATCH * NRING * BS + BS - 1
    written = ring_slots.view(2, t)[0]
    kept = np.arange(t) >= t - (NRING - 1) * BS
    assert bool((written[~kept] == 2 ** 30).all())
    assert len(set(written[kept].tolist())) == int(kept.sum())  # distinct ring slots
    assert sites[1][0] is cache.full and sites[1][5] == 0  # global layers: paged pool


# ---- engines ----


def port_engine(path, steps=1, asy=True, kv="float32", num_blocks=NB, batch=BATCH, **kw):
    econf = EngineConfig(cache=CacheConfig(block_size=BS, num_blocks=num_blocks),
                         scheduler=SchedulerConfig(max_batch_size=batch, max_seq_len=MSL,
                                                   prefill_buckets=BUCKETS, decode_steps=steps,
                                                   async_decode=asy),
                         quant=QuantConfig(kv_cache_dtype=kv), **kw)
    return build_engine(path, econf, device="cpu", dtype="float32")


def jax_engine(path, jw, steps=1, asy=True, kv="float32", num_blocks=NB):
    econf = JEngineConfig(cache=JCache(block_size=BS, test_num_blocks=num_blocks),
                          scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL,
                                           prefill_buckets=BUCKETS, decode_steps=steps,
                                           async_decode=asy))
    econf.quant.kv_cache_dtype = kv
    return JEngine(create_model(jax_config(path)), jw, econf)


REQS = [(LONG, 12), (PROMPT, 10), (PROMPT[:5], 16)]


def serve(engine, gen_cls, reqs=REQS, steps=800, watch=None):
    """Greedy tokens of ``reqs`` ((prompt, new tokens) pairs) served
    together, each stream's logprobs beside them (a random tiny model
    repeats tokens soon; its logprobs still follow every K/V it reads)."""
    streams = [engine.enqueue(p, gen_cls(max_new_tokens=n, do_sample=False, ignore_eos=True,
                                         return_logprobs=True))
               for p, n in reqs]
    for _ in range(steps):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
        if watch is not None:
            watch(engine, streams)
    assert all(s.is_finished() for s in streams)
    return ([list(s.output_token_ids) for s in streams],
            np.asarray([x for s in streams for x in s.output_logprobs]))


def assert_same_serve(got, want):
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], **TOL)


@pytest.fixture(scope="module")
def jax_tokens(ckpts):
    """The JAX engine's greedy tokens of REQS served together, per type."""
    out = {}
    for mt in TYPES:
        path, jw, _ = ckpts[mt]
        out[mt] = serve(jax_engine(path, jw), JGen)
    return out


@pytest.mark.parametrize("steps,asy", CONFIGS, ids=IDS)
@pytest.mark.parametrize("mt", TYPES)
def test_served_tokens_match_jax_engine(mt, steps, asy, ckpts, jax_tokens):
    """``server.build_engine`` serves three streams at once (one 40-token
    prompt that wraps its rings) with the JAX engine's greedy tokens; a
    split model's streams take their slots before their prefills, one
    stream a prefill, in-layer K/V writes."""
    path = ckpts[mt][0]
    engine = port_engine(path, steps, asy)
    seen = []
    orig = engine._prefill_forward

    def spy(stream, row):  # the slot is the stream's before its prefill runs
        seen.append(stream.slot)
        return orig(stream, row)

    engine._prefill_forward = spy
    assert_same_serve(serve(engine, GenerateConfig), jax_tokens[mt])
    if mt == "gemma2":
        assert engine.swa_split and not engine._defer_decode
        assert engine.cache_mgr.prefix_cache is None
        assert all(s >= 0 for s in seen) and len(seen) == len(REQS)
    else:
        assert not engine.swa_split and isinstance(engine.kv, torch.Tensor)
    assert sorted(engine._free_slots) == list(range(BATCH))


def test_single_stream_matches_jax_and_uncapped_differs(ckpts, tmp_path):
    """The lone 40-token prompt alone against the JAX engine, and the same
    weights uncapped serving other logprobs."""
    path, jw, _ = ckpts["gemma2"]
    want = serve(jax_engine(path, jw), JGen, reqs=[(LONG, 16)])
    assert_same_serve(serve(port_engine(path), GenerateConfig, reqs=[(LONG, 16)]), want)
    free = write_checkpoint(str(tmp_path), "gemma2", caps=(0.0, 0.0))
    other = serve(port_engine(free), GenerateConfig, reqs=[(LONG, 16)])
    assert float(np.abs(other[1] - want[1]).max()) > 100 * TOL["atol"]


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_pools_match_jax_engine(kv, ckpts):
    """Split pools of int8 (data and scales in each half) and fp8 e4m3."""
    path, jw, _ = ckpts["gemma2"]
    engine = port_engine(path, kv=kv)
    pool = engine.kv
    if kv == "int8":
        assert set(pool.full) == set(pool.swa) == {"data", "scale"}
    else:
        assert pool.full.dtype == pool.swa.dtype == FP8
    assert_same_serve(serve(engine, GenerateConfig), serve(jax_engine(path, jw, kv=kv), JGen))


def test_preempted_stream_readmitted_into_another_slot(ckpts):
    """23 usable blocks for two streams that peak at 13 and 12: growing them
    preempts the newer, which gives up its slot (1) and is re-admitted
    (recompute) into the one the older freed (0), whose rings its prefill
    writes anew; tokens and logprobs are those of an unpreempted JAX
    engine."""
    path, jw, _ = ckpts["gemma2"]
    reqs = [(PROMPT, 40), (PROMPT[:5], 40)]
    want = serve(jax_engine(path, jw), JGen, reqs=reqs)
    engine = port_engine(path, num_blocks=24)
    slots, preempted = {}, []

    def watch(eng, streams):
        for i, s in enumerate(streams):
            if s.slot >= 0 and (not slots.get(i) or slots[i][-1] != s.slot):
                slots.setdefault(i, []).append(s.slot)
            if s.state.value == "waiting" and s.output_token_ids:
                preempted.append(i)

    assert_same_serve(serve(engine, GenerateConfig, reqs=reqs, watch=watch), want)
    assert preempted, "the pool must be small enough to preempt"
    assert slots[1] == [1, 0], slots
    assert sorted(engine._free_slots) == list(range(BATCH))


def test_refusals(ckpts):
    """A beam request to a split model is refused at ``enqueue`` (the
    server's 400); a speculative config raises at construction."""
    path = ckpts["gemma2"][0]
    engine = port_engine(path)
    s = engine.enqueue(PROMPT, GenerateConfig(max_new_tokens=4, num_beams=2))
    assert s.is_finished() and "beam search" in (s.error or "")
    with pytest.raises(ValueError, match="speculative"):
        port_engine(path, speculative=SpeculativeConfig(method="prompt_lookup", draft_tokens=2))
    # gemma (one pool) takes beams
    ok = port_engine(ckpts["gemma"][0]).enqueue(PROMPT, GenerateConfig(max_new_tokens=4,
                                                                      num_beams=2))
    assert not ok.is_finished()


def test_auto_sizing_takes_the_rings_off_the_budget(ckpts):
    """With ``num_blocks`` 0 the pool takes the CPU budget (256 MiB) less
    the rings, int8 scales included; rings past the budget raise, naming
    the bytes and the slots that fit."""
    path = ckpts["gemma2"][0]
    cfg = port_config(path)
    for kv, elem, scale in (("float32", 4, 0), ("int8", 1, 2)):
        engine = port_engine(path, kv=kv, num_blocks=0)
        per_head = cfg.head_dim * elem + scale
        block = lambda layers: 2 * layers * BS * cfg.num_kv_heads * per_head
        rings = (BATCH * NRING + 1) * block(2)
        assert engine.ring_bytes() == (NRING * block(2), block(2))
        assert engine.num_blocks == ((256 << 20) - rings) // block(2)
        assert engine.kv_block_bytes() == block(2)
        data = engine.kv.swa["data"] if kv == "int8" else engine.kv.swa
        assert data.shape[2] == (BATCH * NRING + 1) * BS
    with pytest.raises(ValueError, match=r"slots take \d+ bytes .* at most \d+ slots fit"):
        port_engine(path, num_blocks=0, batch=200000)


def test_prompt_loss_and_teacher_forced_loop_borrow_a_free_slot(ckpts):
    """``compute_prompt_loss`` equals the JAX engine's and
    ``generate_with_hidden`` its tokens; while a stream decodes in slot 0,
    both write a free slot's rings (the JAX engine's write ring 0): the
    stream's tokens are those it serves alone."""
    path, jw, _ = ckpts["gemma2"]
    jengine = jax_engine(path, jw)
    engine = port_engine(path)
    np.testing.assert_allclose(engine.compute_prompt_loss(LONG).numpy(),
                               np.asarray(jengine.compute_prompt_loss(LONG)), **TOL)
    cfg = dict(max_new_tokens=6, do_sample=False, ignore_eos=True)
    # (the JAX loop takes a prompt of one prefill bucket at most)
    want, want_h = jengine.generate_with_hidden(PROMPT, JGen(**cfg))
    got, got_h = engine.generate_with_hidden(PROMPT, GenerateConfig(**cfg))
    assert list(got.output_token_ids) == list(want.output_token_ids)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    alone = serve(port_engine(path), GenerateConfig, reqs=[(LONG, 16)])
    s = engine.enqueue(LONG, GenerateConfig(max_new_tokens=16, do_sample=False, ignore_eos=True,
                                            return_logprobs=True))
    for _ in range(4):
        engine.step()
    assert s.slot == 0 and not s.is_finished()
    engine.compute_prompt_loss(PROMPT * 3)
    engine.generate_with_hidden(PROMPT * 2, GenerateConfig(**cfg))
    while not s.is_finished():
        engine.step()
    assert_same_serve(([list(s.output_token_ids)], np.asarray(s.output_logprobs)), alone)
    assert sorted(engine._free_slots) == list(range(BATCH))


def test_c8_the_reference_loss_loop_writes_a_live_slots_ring(ckpts):
    """C8, a fault of the reference: the JAX engine's ``compute_prompt_loss``
    on a split model runs its prefill with no ``state_slots``, so its
    sliding layers write ring 0, the ring of the stream in decode slot 0:
    that stream's later tokens change. The port's loop borrows a free slot
    (``test_prompt_loss_and_teacher_forced_loop_borrow_a_free_slot``)."""
    path, jw, _ = ckpts["gemma2"]
    alone = serve(jax_engine(path, jw), JGen, reqs=[(LONG, 16)])
    jengine = jax_engine(path, jw)
    s = jengine.enqueue(LONG, JGen(max_new_tokens=16, do_sample=False, ignore_eos=True,
                                   return_logprobs=True))
    for _ in range(4):
        jengine.step()
    assert s.slot == 0 and not s.is_finished()
    jengine.compute_prompt_loss(PROMPT * 3)
    while not s.is_finished():
        jengine.step()
    moved = float(np.abs(np.asarray(s.output_logprobs) - alone[1]).max())
    assert moved > 100 * TOL["atol"], moved
