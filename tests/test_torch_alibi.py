"""The ALiBi families in the port against the JAX package, on the CPU (f32,
tiny shapes).

* ``alibi_slopes`` at 8, 6 and 40 heads equals the JAX schedule.
* The plain ALiBi attention against the JAX ``paged_attention_ref``: G 1
  and 2, bf16 / int8 / e4m3 pools, T 1 with and without the deferred
  current token, T > 1 behind reused prefixes (``q_offsets`` > 0) and a
  sliding window; the bias moves every case. The kernels' operand checks.
* baichuan (13B-shaped: ALiBi), baichuan2 (its ``NormHead``), bloom (JAX
  fake checkpoints, seed 1, scale 0.2) and mpt (written by HF's
  ``MptForCausalLM``: the JAX fake writer cuts one ``Wqkv`` for three
  members), each against the JAX package: the config field by field, the
  weights bit for bit, prefill and decode logits at 4e-4; baichuan2 beside
  a JAX model given the normalised head (C19: the JAX package serves the
  raw one).
* ``LlmEngine`` greedy tokens equal the JAX engine's with prefix reuse on
  and off (baichuan, bloom, mpt), and on the 13B-shaped baichuan with LoRA
  adapters, beams and prompt-lookup speculation.
* C18: the JAX package's opt-in Pallas prefill drops the bias (its gate
  does not test for it); K3 run through the JAX dispatch in interpret mode.
"""

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.engine_config import SpeculativeConfig as JSpec
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.config.model_config import ModelConfig as JConfig
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.lora import LoraManager as JLoraManager
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu.models.llama_family import alibi_slopes as j_slopes
from rtp_llm_tpu.ops import attention as jattn
from rtp_llm_tpu.ops.attention import paged_attention_ref as j_ref
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig, SpeculativeConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.lora import LoraManager
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.models.llama_family import alibi_slopes
from rtp_llm_tpu_torch.ops import attention as tattn
from rtp_llm_tpu_torch.ops.attention import decode as tdecode
from tests.test_torch_gptq_awq import assert_same_weights
from tests.test_torch_lora import write_fake_adapter

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

BS = 16
TOL = dict(rtol=4e-4, atol=4e-4)
FP8 = torch.float8_e4m3fn


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---- slopes ----------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 6, 40])
def test_alibi_slopes_match_jax(n):
    assert alibi_slopes(n) == list(j_slopes(n))


# ---- the plain ALiBi attention ---------------------------------------------


def _pool(rng, kind, ns, hkv, d):
    """(port k, port v, JAX k, JAX v, port scale kwargs, JAX scale kwargs)
    of a pool of ``kind`` holding the same values on both sides."""
    f = [rng.standard_normal((ns, hkv, d)).astype(np.float32) for _ in range(2)]
    if kind == "int8":
        out, tkw, jkw = [], {}, {}
        for name, x in zip("kv", f):
            s = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(ml_dtypes.bfloat16)
            q = np.clip(np.round(x / s[..., None].astype(np.float32)), -127, 127).astype(np.int8)
            out.append(q.reshape(ns, hkv * d))
            tkw[f"{name}_scale"] = torch.from_numpy(s.view(np.uint16).copy()).view(torch.bfloat16)
            jkw[f"{name}_scale"] = jnp.asarray(s)
        return _t(out[0]), _t(out[1]), jnp.asarray(out[0]), jnp.asarray(out[1]), tkw, jkw
    dt = ml_dtypes.bfloat16 if kind == "bf16" else ml_dtypes.float8_e4m3fn
    tdt = torch.bfloat16 if kind == "bf16" else FP8
    arrs = [x.reshape(ns, hkv * d).astype(dt) for x in f]
    bits = np.uint16 if kind == "bf16" else np.uint8
    tt = [torch.from_numpy(a.view(bits).copy()).view(tdt) for a in arrs]
    return tt[0], tt[1], jnp.asarray(arrs[0]), jnp.asarray(arrs[1]), {}, {}


MODES = {  # (T, kv_lens, q_offsets or None for kv_len - 1, cur token, window)
    "decode": (1, [1, 17, 100, 0], None, False, 0),
    "decode_cur": (1, [1, 17, 100, 0], None, True, 0),
    "prefill_offsets": (24, [20, 54, 100], [0, 30, 76], False, 0),
    "window": (24, [20, 54, 100], [0, 30, 76], False, 8),
}


@pytest.mark.parametrize("pool", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_alibi_attention_matches_jax(mode, g, pool):
    """The port's plain attention with ``alibi_slopes`` against the JAX
    reference on the same pool, queries and slopes (the bias after the
    scale, before the mask; 0 for the deferred current token); without the
    slopes the output moves by far more than the tolerance."""
    t, lens, offs, cur, window = MODES[mode]
    rng = np.random.default_rng(hash((mode, g, pool)) % 2**32)
    hkv, d, nb, mb = 2, 16, 40, 8
    hq = hkv * g
    b = len(lens)
    lens = np.asarray(lens, np.int32)
    offs = np.maximum(lens - 1, 0) if offs is None else np.asarray(offs, np.int32)
    tk, tv, jk, jv, tkw, jkw = _pool(rng, pool, nb * BS, hkv, d)
    bt = rng.permutation(np.arange(1, nb))[: b * mb].reshape(b, mb).astype(np.int32)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    slopes = np.asarray(alibi_slopes(hq), np.float32)
    if cur:
        ck, cv = (rng.standard_normal((b, hkv * d)).astype(np.float32) for _ in range(2))
        tkw.update(cur_k=_t(ck), cur_v=_t(cv))
        jkw.update(cur_k=jnp.asarray(ck), cur_v=jnp.asarray(cv))
    want = np.asarray(j_ref(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
                            jnp.asarray(offs), 0.25, block_size=BS, sliding_window=window,
                            alibi_slopes=jnp.asarray(slopes), **jkw))
    args = (_t(q), tk, tv, _t(bt), _t(lens), _t(offs), 0.25, BS)
    got = tattn.paged_attention(*args, sliding_window=window, alibi_slopes=_t(slopes),
                                **tkw).numpy()
    live = (offs[:, None] + np.arange(t)[None, :]) < lens[:, None]
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)
    plain = tattn.paged_attention(*args, sliding_window=window, **tkw).numpy()
    assert np.abs(plain[live] - got[live]).max() > 1e-2
    if t == 1:  # the decode wrapper's CPU route is the same plain version
        got1 = tdecode.paged_decode_attention(_t(q[:, 0]), tk, tv, _t(bt), _t(lens), 0.25, BS,
                                              sliding_window=window, alibi_slopes=_t(slopes),
                                              **tkw)
        np.testing.assert_array_equal(got1.numpy(), got[:, 0])


def test_kernel_alibi_operand_checks():
    """What the CUDA kernels take: contiguous f32 ``[Hq]`` slopes on the
    queries' device, never beside a soft-cap."""
    cpu = torch.device("cpu")
    ok = torch.ones(8)
    tdecode.check_alibi(None, 8, 0.0, cpu)
    tdecode.check_alibi(ok, 8, 0.0, cpu)
    for bad in (ok.double(), torch.ones(4), torch.ones(16)[::2]):
        with pytest.raises(ValueError):
            tdecode.check_alibi(bad, 8, 0.0, cpu)
    with pytest.raises(NotImplementedError):
        tdecode.check_alibi(ok, 8, 50.0, cpu)


# ---- the families ----------------------------------------------------------

KINDS = ("baichuan", "baichuan2", "bloom", "mpt")
PROMPT = [1, 5, 9, 42, 7, 3, 11, 60, 2, 33, 17, 8]
LONG = [(7 * i + 3) % 90 + 1 for i in range(30)]


def _write_mpt(path, seed):
    """A tiny MPT checkpoint written by HF ``MptForCausalLM`` (2 layers, 4
    heads of 16), every parameter redrawn from ``seed``: norm weights
    1 + N(0, 0.1^2), the rest N(0, 0.2^2)."""
    from transformers import MptConfig, MptForCausalLM

    cfg = MptConfig(vocab_size=128, d_model=64, n_heads=4, n_layers=2, expansion_ratio=2,
                    max_seq_len=256, eos_token_id=2)
    torch.manual_seed(0)
    model = MptForCausalLM(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            p.copy_(1.0 + 0.1 * draw if "norm" in name else 0.2 * draw)
    model.save_pretrained(path, safe_serialization=True)
    return path


def write_checkpoint(root, kind, seed=1):
    path = os.path.join(root, kind)
    if kind == "mpt":
        return _write_mpt(path, seed)
    # baichuan at a tiny width takes ALiBi as the 13B does (use_alibi)
    extra = {"use_alibi": True} if kind.startswith("baichuan") else None
    return write_fake_checkpoint(path, tiny_config(kind), seed=seed, scale=0.2,
                                 extra_config=extra)


def port_config(path):
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def jax_config(path):
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def _normalised_head(jw):
    """The JAX weights with Baichuan2's head rows L2-normalised (what its
    NormHead serves)."""
    h = np.asarray(jw["lm_head"], np.float32)
    return dict(jw, lm_head=jnp.asarray(h / np.linalg.norm(h, axis=0, keepdims=True)))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("alibi"))
    out = {}
    for kind in KINDS:
        path = write_checkpoint(root, kind)
        jw = JLoader(jax_config(path)).load(path)
        if port_config(path).norm_head:
            jw = _normalised_head(jw)
        out[kind] = (path, jw, TLoader(port_config(path), device="cpu").load(path))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_config_equals_jax_field_by_field(kind, ckpts):
    port, jax_cfg = port_config(ckpts[kind][0]), jax_config(ckpts[kind][0])
    for f in dataclasses.fields(TConfig):
        assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    assert port.use_alibi and port.norm_head == (kind == "baichuan2")
    assert port.gated_mlp == kind.startswith("baichuan")
    assert port.hidden_act == {"bloom": "gelu_tanh", "mpt": "gelu"}.get(kind, "silu")


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_weights_equal_jax(kind, ckpts):
    """Bit for bit under the JAX names (bloom's ``embed_norm`` and biases,
    mpt's ``Wqkv`` thirds), Baichuan2's head normalised on both sides."""
    _, jw, tw = ckpts[kind]
    if kind == "bloom":  # the JAX bloom names its biases ``q_proj.bias`` too
        assert "embed_norm" in tw and "embed_norm.bias" in tw and "q_proj.bias" in tw
    if kind == "baichuan2":
        np.testing.assert_allclose(tw["lm_head"].numpy(), np.asarray(jw["lm_head"]),
                                   rtol=1e-6, atol=1e-7)
        tw, jw = ({n: x for n, x in w.items() if n != "lm_head"} for w in (tw, jw))
    assert_same_weights(tw, jw)


def _steps(prompt, bt):
    """(JAX inputs, port inputs) of a prefill of ``prompt``, then two decode
    steps."""
    t = len(prompt)
    rows = [dict(tokens=np.asarray([prompt], np.int32),
                 positions=np.arange(t, dtype=np.int32)[None], block_tables=bt,
                 kv_lens=np.asarray([t], np.int32), q_offsets=np.asarray([0], np.int32))]
    for j, tok in enumerate((13, 21)):
        rows.append(dict(tokens=np.asarray([[tok]], np.int32),
                         positions=np.asarray([[t + j]], np.int32), block_tables=bt,
                         kv_lens=np.asarray([t + j + 1], np.int32),
                         q_offsets=np.asarray([t + j], np.int32)))
    return ([JInputs(**{k: jnp.asarray(v) for k, v in r.items()}) for r in rows],
            [ModelInputs(**{k: torch.from_numpy(v) for k, v in r.items()}) for r in rows])


def port_logits(path, tw, prompt=PROMPT, cfg=None):
    model = LlamaFamilyModel(cfg or port_config(path), device="cpu")
    fused = model.fuse_weights(dict(tw))
    cache = model.init_cache(16, 4, torch.float32)
    out = []
    for tin in _steps(prompt, np.arange(1, 11, dtype=np.int32)[None])[1]:
        o, cache = model.forward(fused, cache, tin, need_all_logits=True)
        out.append(o.all_logits.numpy())
    return out


def jax_logits(path, jw, prompt=PROMPT, cfg=None):
    jmodel = create_model(cfg or jax_config(path))
    jcache = jmodel.init_cache(16, 4, jnp.float32)
    out = []
    for jin in _steps(prompt, np.arange(1, 11, dtype=np.int32)[None])[0]:
        jout, jcache = jmodel.forward(jw, jcache, jin, need_all_logits=True)
        out.append(np.asarray(jout.all_logits))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_forward_logits_match_jax(kind, ckpts):
    """Every row's logits of a 12-token prefill and two decode steps against
    the JAX ``LlamaFamilyModel`` (f32, 4e-4); without the bias they move."""
    path, jw, tw = ckpts[kind]
    got = port_logits(path, tw)
    for a, b in zip(got, jax_logits(path, jw)):
        np.testing.assert_allclose(a, b.reshape(a.shape), **TOL)
    rope = port_logits(path, tw, cfg=dataclasses.replace(port_config(path), use_alibi=False))
    assert np.abs(rope[0] - got[0]).max() > 100 * TOL["atol"]


def test_c19_baichuan2_norm_head(ckpts):
    """C19: Baichuan2's NormHead L2-normalises each head row at inference;
    the JAX package serves the raw rows and its logits move far from the
    port's."""
    path, _, tw = ckpts["baichuan2"]
    raw = JLoader(jax_config(path)).load(path)
    got = port_logits(path, tw)[0]
    want = jax_logits(path, raw)[0].reshape(got.shape)
    assert np.abs(got - want).max() > 100 * TOL["atol"]
    assert port_config(path).norm_head
    assert TConfig.from_hf_config({"model_type": "baichuan", "vocab_size": 125696}).norm_head
    assert not TConfig.from_hf_config({"model_type": "baichuan", "vocab_size": 64000}).norm_head


# ---- engines ---------------------------------------------------------------

NB, BATCH, MSL = 64, 4, 96


def _port_engine(path, prefix=True, spec="none", weights=None):
    cfg = port_config(path)
    econf = EngineConfig(
        cache=CacheConfig(block_size=4, num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL,
                                  prefill_buckets=(16, 64)),
        quant=QuantConfig(kv_cache_dtype="float32"),
        speculative=SpeculativeConfig(method=spec, draft_tokens=3))
    if weights is None:
        weights = TLoader(cfg, device="cpu").load(path)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), weights, econf, device="cpu")


def _jax_engine(path, jw, prefix=True, spec="none"):
    jconf = JEngineConfig(
        cache=JCache(block_size=4, test_num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64)),
        speculative=JSpec(method=spec, draft_tokens=3))
    jconf.quant.kv_cache_dtype = "float32"
    return JEngine(create_model(jax_config(path)), jw, jconf)


def _serve(engine, reqs, gen_cls, steps=400):
    streams = [engine.enqueue(p, gen_cls(**kw)) for p, kw in reqs]
    for _ in range(steps):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
    assert all(s.is_finished() for s in streams)
    return [s.output_token_ids for s in streams]


def _greedy(n, **kw):
    return dict(max_new_tokens=n, do_sample=False, ignore_eos=True, **kw)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix_on", "prefix_off"])
@pytest.mark.parametrize("kind", ["baichuan", "bloom", "mpt"])
def test_served_tokens_match_jax_engine(kind, prefix, ckpts):
    """Greedy tokens of four streams served together (a packed prefill,
    then decode windows), then the long prompt again behind its cached
    prefix (prefix on: the prefill's q_offset > 0), equal the JAX
    engine's."""
    path, jw, tw = ckpts[kind]
    te, je = _port_engine(path, prefix, weights=tw), _jax_engine(path, jw, prefix)
    reqs = [(LONG, _greedy(8)), (PROMPT[:5], _greedy(8)), (PROMPT, _greedy(6)),
            (LONG[3:20], _greedy(7))]
    for r in (reqs, reqs[:1]):
        assert _serve(te, r, GenerateConfig) == [list(x) for x in _serve(je, r, JGen)]
    if prefix:
        again = te.enqueue(LONG, GenerateConfig(**_greedy(2)))
        while not again.is_finished():
            te.step()
        assert again.reuse_len > 0


def _lora(path, jw, tw, adapters):
    te, je = _port_engine(path, weights=tw), _jax_engine(path, jw)
    for engine, cls in ((te, LoraManager), (je, JLoraManager)):
        mgr = cls(2)
        for name, p in adapters.items():
            mgr.add_adapter(p, name=name)
        engine.set_lora_manager(mgr)
    reqs = [(LONG, _greedy(8, adapter_name="X")), (PROMPT[:5], _greedy(8)),
            (PROMPT, _greedy(6, adapter_name="Y"))]
    return te, je, reqs


@pytest.mark.parametrize("feature", ["lora", "beams", "prompt_lookup"])
def test_engine_features_on_alibi_match_jax(feature, ckpts, tmp_path):
    """The 13B-shaped baichuan (ALiBi) through LoRA adapters (mixed X / Y /
    none, every target), beam search (3 beams) and prompt-lookup
    speculation (repeating prompts, K 3): tokens equal the JAX engine's,
    and each feature is in play (adapters change tokens, three distinct
    hypotheses, verify steps taken)."""
    path, jw, tw = ckpts["baichuan"]
    if feature == "lora":
        dims = {t: (64, 64) for t in ("q_proj", "k_proj", "v_proj", "o_proj")}
        dims.update(gate_proj=(64, 128), up_proj=(64, 128), down_proj=(128, 64))
        adapters = {n: write_fake_adapter(str(tmp_path / n), seed=s, dims=dims)
                    for n, s in (("X", 3), ("Y", 4))}
        te, je, reqs = _lora(path, jw, tw, adapters)
        got = _serve(te, reqs, GenerateConfig)
        assert got == [list(x) for x in _serve(je, reqs, JGen)]
        base = _serve(te, [(p, {k: v for k, v in kw.items() if k != "adapter_name"})
                           for p, kw in reqs], GenerateConfig)
        assert got[0] != base[0] and got[2] != base[2] and got[1] == base[1]
    elif feature == "beams":
        te, je = _port_engine(path, weights=tw), _jax_engine(path, jw)
        reqs = [(PROMPT, _greedy(8, num_beams=3))]
        stream = te.enqueue(*reqs[0][:1], GenerateConfig(**reqs[0][1]))
        while not stream.is_finished():
            te.step()
        assert [stream.output_token_ids] == [list(x) for x in _serve(je, reqs, JGen)]
        assert len({tuple(tokens) for tokens, _ in stream.beam_hypotheses}) == 3
    else:
        te = _port_engine(path, spec="prompt_lookup", weights=tw)
        je = _jax_engine(path, jw, spec="prompt_lookup")
        reqs = [([7, 8, 9, 7, 8, 9, 7, 8] * 2, _greedy(12)), ([1, 2, 3] * 4, _greedy(12))]
        got = _serve(te, reqs, GenerateConfig)
        assert got == [list(x) for x in _serve(je, reqs, JGen)]
        assert te.spec_stats["steps"] > 0
        assert got == _serve(_port_engine(path, weights=tw), reqs, GenerateConfig)


# ---- C18: the JAX package's Pallas prefill gate ----------------------------


def test_c18_jax_pallas_prefill_drops_the_bias(monkeypatch):
    """C18: with ``enable_pallas_prefill`` the JAX dispatch sends an ALiBi
    prefill (D 128, one row, no window) to its Pallas K3, whose call takes
    no slopes (``rtp_llm_tpu/ops/attention/__init__.py:228-247``): run here
    in interpret mode through the dispatch, it answers the unbiased
    attention. The port's dispatch hands the slopes to whichever path runs
    and matches the biased JAX reference."""
    from rtp_llm_tpu.ops.attention import pallas_prefill

    monkeypatch.setenv("RTP_ENABLE_PALLAS_PREFILL", "1")
    calls = []
    real = pallas_prefill.paged_prefill_attention

    def interpreted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw, interpret=True)
    monkeypatch.setattr(pallas_prefill, "paged_prefill_attention", interpreted)
    rng = np.random.default_rng(18)
    t, hq, hkv, d, nb = 32, 4, 2, 128, 8
    q = rng.standard_normal((1, t, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((nb * BS, hkv * d)).astype(np.float32) for _ in range(2))
    bt = np.arange(1, 1 + -(-t // BS), dtype=np.int32)[None]
    lens, offs = np.asarray([t], np.int32), np.asarray([0], np.int32)
    slopes = np.asarray(alibi_slopes(hq), np.float32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(lens),
             jnp.asarray(offs), d ** -0.5, BS)
    pallas = np.asarray(jattn.paged_attention(*jargs, backend="pallas",
                                              alibi_slopes=jnp.asarray(slopes)))
    assert len(calls) == 1
    biased = np.asarray(j_ref(*jargs, alibi_slopes=jnp.asarray(slopes)))
    unbiased = np.asarray(j_ref(*jargs))
    np.testing.assert_allclose(pallas, unbiased, rtol=2e-2, atol=2e-2)
    assert np.abs(pallas - biased).max() > 0.1
    got = tattn.paged_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens), _t(offs), d ** -0.5, BS,
                                alibi_slopes=_t(slopes)).numpy()
    np.testing.assert_allclose(got, biased, rtol=1e-5, atol=1e-5)
