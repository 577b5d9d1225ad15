"""The llama-layout families of the port (mistral, yi, internlm, internlm2,
phi3) against the JAX package, on the CPU at tiny shapes.

Each family's HF ``config.json`` and a fake checkpoint in the family's own
tensor names (phi3's fused ``qkv_proj`` / ``gate_up_proj``, internlm2's
``wqkv`` grouped per kv head and its w1 / w3 / w2, internlm's attention and
``o_proj`` biases) are written from a seeded numpy generator. The port's
``ModelConfig`` equals the JAX one field by field, apart from the sliding
window (C6: the JAX package reads it only under ``use_sliding_window``; its
side of a comparison is given the window explicitly). The loaded weight
dicts are equal bit for bit, and the forward logits (a 12-token prefill over
a 6-token window, then two decode steps) agree within 1e-4 (f32; the two
sum in different orders). Through ``server.build_engine``, the port's
engine serves each checkpoint with the JAX engine's greedy tokens. Also:
C7 (a ``rope_scaling`` type the tables do not compute), the presets, and
the attention dispatch's head-width checks.
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
from rtp_llm_tpu.ops.rope import compute_rope_freqs as jax_rope
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
)
from rtp_llm_tpu_torch.config import model_config as tmc
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.ops.attention import decode as tdecode
from rtp_llm_tpu_torch.ops.attention import prefill as tprefill
from rtp_llm_tpu_torch.ops.rope import compute_rope_freqs as port_rope
from rtp_llm_tpu_torch.server.server import build_engine
from tests.test_torch_gptq_awq import assert_same_weights

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

FAMILIES = ("mistral", "yi", "internlm", "internlm2", "phi3")
WINDOW = 6  # the tiny mistral / phi3 window: the 12-token prompt crosses it
PROMPT = [1, 5, 9, 42, 7, 3, 11, 60, 2, 33, 17, 8]
BS = 4


def hf_config(mt: str) -> dict:
    """A tiny HF config.json of family ``mt``, with its family's keys."""
    hf = dict(model_type=mt, vocab_size=96, hidden_size=64, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
              eos_token_id=2, tie_word_embeddings=False)
    if mt in ("mistral", "phi3"):
        hf["sliding_window"] = WINDOW  # no use_sliding_window, as published
    if mt in ("internlm", "phi3"):
        hf["num_key_value_heads"] = 4  # both are MHA
    if mt == "internlm":
        hf["bias"] = True
    if mt == "internlm2":
        hf.update(bias=False, rope_theta=1000000.0,
                  rope_scaling={"type": "dynamic", "factor": 2.0})
    return hf


def hf_tensors(hf: dict, rng) -> dict:
    """Random f32 tensors under the family's HF names ([out, in] linears)."""
    mt = hf["model_type"]
    h, i, v, L = (hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"],
                  hf["num_hidden_layers"])
    hq, hkv = hf["num_attention_heads"], hf["num_key_value_heads"]
    d = h // hq
    lin = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    norm = lambda n: (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {}
    if mt == "internlm2":
        t["model.tok_embeddings.weight"] = lin(v, h)
        t["output.weight"] = lin(v, h)
        t["model.norm.weight"] = norm(h)
        for l in range(L):
            p = f"model.layers.{l}."
            t[p + "attention_norm.weight"] = norm(h)
            t[p + "ffn_norm.weight"] = norm(h)
            t[p + "attention.wqkv.weight"] = lin((hq + 2 * hkv) * d, h)
            t[p + "attention.wo.weight"] = lin(h, hq * d)
            t[p + "feed_forward.w1.weight"] = lin(i, h)
            t[p + "feed_forward.w3.weight"] = lin(i, h)
            t[p + "feed_forward.w2.weight"] = lin(h, i)
        return t
    t["model.embed_tokens.weight"] = lin(v, h)
    t["lm_head.weight"] = lin(v, h)
    t["model.norm.weight"] = norm(h)
    for l in range(L):
        p = f"model.layers.{l}."
        t[p + "input_layernorm.weight"] = norm(h)
        t[p + "post_attention_layernorm.weight"] = norm(h)
        t[p + "self_attn.o_proj.weight"] = lin(h, hq * d)
        t[p + "mlp.down_proj.weight"] = lin(h, i)
        if mt == "phi3":
            t[p + "self_attn.qkv_proj.weight"] = lin((hq + 2 * hkv) * d, h)
            t[p + "mlp.gate_up_proj.weight"] = lin(2 * i, h)
            continue
        for n, rows in (("q", hq * d), ("k", hkv * d), ("v", hkv * d)):
            t[p + f"self_attn.{n}_proj.weight"] = lin(rows, h)
            if hf.get("bias"):
                t[p + f"self_attn.{n}_proj.bias"] = lin(rows)
        if hf.get("bias"):
            t[p + "self_attn.o_proj.bias"] = lin(h)
        t[p + "mlp.gate_proj.weight"] = lin(i, h)
        t[p + "mlp.up_proj.weight"] = lin(i, h)
    return t


def write_family_checkpoint(root: str, mt: str, seed: int = 0) -> str:
    from safetensors.numpy import save_file

    hf = hf_config(mt)
    path = os.path.join(root, mt)
    os.makedirs(path, exist_ok=True)
    save_file(hf_tensors(hf, np.random.default_rng(seed)), os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return path


def port_config(path: str) -> TConfig:
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def jax_config(path: str) -> JConfig:
    """The JAX config, given the port's window explicitly (C6)."""
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    cfg.sliding_window = port_config(path).sliding_window
    return cfg


@pytest.fixture(scope="module")
def family(request, tmp_path_factory):
    mt = request.param
    path = write_family_checkpoint(str(tmp_path_factory.mktemp("families")), mt)
    jw = JLoader(jax_config(path)).load(path)
    tw = TLoader(port_config(path), device="cpu").load(path)
    return mt, path, jw, tw


families = pytest.mark.parametrize("family", FAMILIES, indirect=True)


# ---- configs ----


@pytest.mark.parametrize("mt", FAMILIES)
def test_config_equals_jax_field_by_field(mt):
    hf = hf_config(mt)
    port, jax_cfg = TConfig.from_hf_config(hf), JConfig.from_hf_config(hf)
    for f in dataclasses.fields(TConfig):
        if f.name == "sliding_window":
            continue
        assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    # C6: the port applies the published window of mistral / phi3
    assert port.sliding_window == (WINDOW if mt in ("mistral", "phi3") else 0)
    assert jax_cfg.sliding_window == 0
    assert port.attention_bias == (mt == "internlm")


# Mistral-7B-v0.1's published config.json (HF mistralai/Mistral-7B-v0.1)
MISTRAL_7B_V01 = {
    "architectures": ["MistralForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 32768, "model_type": "mistral",
    "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 8,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 4096,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 32000}


def test_c6_published_mistral_window():
    """C6: the JAX package loads Mistral-7B-v0.1 with no window (it reads
    ``sliding_window`` only under qwen2's ``use_sliding_window``); the port
    applies the 4096 HF's Mistral attention applies. Qwen2 keeps the gate."""
    assert JConfig.from_hf_config(MISTRAL_7B_V01).sliding_window == 0
    port = TConfig.from_hf_config(MISTRAL_7B_V01)
    assert port.sliding_window == 4096
    assert port == tmc.mistral_7b_config()
    qwen = {"model_type": "qwen2", "sliding_window": 4096, "use_sliding_window": False}
    assert TConfig.from_hf_config(qwen).sliding_window == 0
    assert TConfig.from_hf_config({**qwen, "use_sliding_window": True}).sliding_window == 4096


@pytest.mark.parametrize("preset,d,window", [
    ("mistral_7b_config", 128, 4096), ("phi3_mini_config", 96, 2047),
    ("internlm2_7b_config", 128, 0), ("qwen2_0_5b_config", 64, 0)])
def test_presets(preset, d, window):
    cfg = getattr(tmc, preset)()
    assert cfg.head_dim == d and cfg.sliding_window == window
    assert cfg.model_type in tmc.SUPPORTED_TYPES
    hq, hkv = cfg.num_attention_heads, cfg.num_kv_heads
    tdecode.check_head(d, hq, hkv, "paged_decode")  # the kernels take its heads
    assert tprefill.tile_plan(1, 2048, hq, hkv, d).rows <= tprefill.BLOCK_ROWS
    # the published rope_scaling computes, and equals the JAX tables
    for got, want in zip(port_rope(d, 64, cfg.rope_theta, cfg.rope_scaling),
                         jax_rope(d, 64, cfg.rope_theta, cfg.rope_scaling)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_c7_unknown_rope_type():
    """C7: the JAX tables of a ``longrope`` (Phi-3 128k) config equal the
    unscaled ones (the type is ignored); the port computes longrope / su
    (HF's two tables, ``tests/test_torch_longrope.py``) and refuses at load a
    type it does not compute (Qwen2-VL's ``mrope``)."""
    longrope = {"type": "longrope", "short_factor": [1.0] * 48, "long_factor": [4.0] * 48,
                "original_max_position_embeddings": 4096}
    for got, want in zip(jax_rope(96, 64, 10000.0, longrope), jax_rope(96, 64, 10000.0, None)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    base = port_rope(96, 64, 10000.0, None)[0]
    for rtype in ("longrope", "su"):
        long = port_rope(96, 64, 10000.0, {**longrope, "type": rtype}, 131072, long=True)[0]
        assert np.abs(long - base).max() > 0.1
    for rtype in ("mrope", "fancy"):
        with pytest.raises(ValueError, match=rtype):
            port_rope(96, 64, 10000.0, {**longrope, "type": rtype})
        cfg = dataclasses.replace(tmc.phi3_mini_config(), num_layers=1,
                                  rope_scaling={"rope_type": rtype})
        with pytest.raises(ValueError, match=rtype):
            LlamaFamilyModel(cfg, device="cpu")


# ---- loading and forward ----


@families
def test_loaded_weights_equal_jax(family):
    mt, _, jw, tw = family
    assert_same_weights(tw, jw)
    if mt == "internlm":
        assert "o_proj.bias" in tw
    if mt in ("phi3", "internlm2"):  # the fused checkpoint tensors come apart
        assert tw["q_proj"].shape == (2, 64, 64)


def test_internlm2_wqkv_split_layout():
    """internlm2's ``wqkv`` rows, per kv head: the group's query heads, then
    its key head, then its value head."""
    from rtp_llm_tpu_torch.loader.weight_maps import internlm2_split_qkv

    cfg = tmc.ModelConfig(model_type="internlm2", hidden_size=8, num_attention_heads=4,
                          num_kv_heads=2, head_dim=2)
    rows = (torch.arange(16) // 2)[:, None].repeat(1, 3)  # each row tagged with its head
    heads = lambda t: t[::2, 0].tolist()
    q, k, v = (internlm2_split_qkv(j)(rows, cfg) for j in range(3))
    assert heads(q) == [0, 1, 4, 5] and heads(k) == [2, 6] and heads(v) == [3, 7]


def _steps():
    """(JAX inputs, port inputs) of a 12-token prefill and two decode steps."""
    t = len(PROMPT)
    bt = np.arange(1, 6, dtype=np.int32)[None]
    rows = [dict(tokens=np.asarray([PROMPT], np.int32),
                 positions=np.arange(t, dtype=np.int32)[None], block_tables=bt,
                 kv_lens=np.asarray([t], np.int32), q_offsets=np.asarray([0], np.int32))]
    for j, tok in enumerate((13, 21)):
        rows.append(dict(tokens=np.asarray([[tok]], np.int32),
                         positions=np.asarray([[t + j]], np.int32), block_tables=bt,
                         kv_lens=np.asarray([t + j + 1], np.int32),
                         q_offsets=np.asarray([t + j], np.int32)))
    return ([JInputs(**{k: jnp.asarray(v) for k, v in r.items()}) for r in rows],
            [ModelInputs(**{k: torch.from_numpy(v) for k, v in r.items()}) for r in rows])


@families
def test_forward_logits_match_jax(family):
    """Prefill and decode logits against the JAX ``LlamaFamilyModel``: 1e-4
    (f32). The window (mistral, phi3) cuts the prompt's early keys."""
    mt, path, jw, tw = family
    jsteps, tsteps = _steps()
    jmodel = create_model(jax_config(path))
    jcache = jmodel.init_cache(8, BS, jnp.float32)
    model = LlamaFamilyModel(port_config(path), device="cpu")
    fused = model.fuse_weights(tw)
    cache = model.init_cache(8, BS, torch.float32)
    for jin, tin in zip(jsteps, tsteps):
        jout, jcache = jmodel.forward(jw, jcache, jin)
        out, cache = model.forward(fused, cache, tin)
        np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                                   rtol=1e-4, atol=1e-4)


@families
def test_served_tokens_match_jax_engine(family):
    """``server.build_engine`` (the ``serve`` entry point's loader) serves
    the checkpoint with the JAX engine's greedy tokens (f32, blocks of 4)."""
    mt, path, jw, _ = family
    econf = EngineConfig(cache=CacheConfig(block_size=BS, num_blocks=24),
                         scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=64,
                                                   prefill_buckets=(16, 64)),
                         quant=QuantConfig(kv_cache_dtype="float32"))
    engine = build_engine(path, econf, device="cpu", dtype="float32")
    jconf = JEngineConfig(cache=JCache(block_size=BS, test_num_blocks=24),
                          scheduler=JSched(max_batch_size=4, max_seq_len=64,
                                           prefill_buckets=(16, 64)))
    jconf.quant.kv_cache_dtype = "float32"
    jengine = JEngine(create_model(jax_config(path)), jw, jconf)
    for prompt in (PROMPT, PROMPT[:5]):
        got = engine.generate(prompt, GenerateConfig(max_new_tokens=8, do_sample=False,
                                                     ignore_eos=True)).output_token_ids
        want = jengine.generate(prompt, JGen(max_new_tokens=8, do_sample=False,
                                             ignore_eos=True)).output_token_ids
        assert got == list(want)


# ---- the attention dispatch's head widths ----


@pytest.mark.parametrize("d", [64, 96, 128])
def test_dispatch_admits_served_head_dims(d):
    tdecode.check_head(d, 14, 2, "paged_decode")
    tdecode.check_head(d, 32, 32, "paged_decode")
    for hq, hkv in ((14, 2), (32, 32), (32, 8)):
        plan = tprefill.tile_plan(2, 300, hq, hkv, d)
        staged = tprefill.staged_dims(d)
        assert staged % 64 == 0 and d <= staged < d + 64
        # Q, the ring of (K, V) stages, slack: within one block's 227 KB
        assert plan.smem_bytes == (tprefill.BLOCK_ROWS + 2 * tprefill.RING_STAGES
                                   * tprefill.KEY_TILE) * staged * 2 + 1024
        assert plan.smem_bytes <= 232448
    for mod in (tdecode, tprefill):
        names = {k.name for (dt, dd), k in mod.KERNELS_BY_DIM.items() if dd == d}
        assert len(names) == 3  # one entry a pool type
        assert all(mod.kernel_for(dt, d) is k for (dt, dd), k in mod.KERNELS_BY_DIM.items()
                   if dd == d)


@pytest.mark.parametrize("d", [48, 32, 512])
def test_dispatch_refuses_other_head_dims(d):
    with pytest.raises(NotImplementedError, match="64, 80, 96, 128, 256"):
        tdecode.check_head(d, 8, 8, "paged_decode")
    with pytest.raises(ValueError, match="head_dim"):
        tprefill.tile_plan(1, 64, 8, 8, d)
    # the wrappers refuse it on a CUDA tensor before any launch (here: meta)
    q = torch.empty((1, 8, d), device="meta", dtype=torch.bfloat16)
    pool = torch.empty((64, 8 * d), device="meta", dtype=torch.bfloat16)
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="head_dim"):
        tdecode.paged_decode_attention(q, pool, pool, bt, bt[:, 0], 1.0, 64)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tprefill.paged_prefill_attention(q[:, None], pool, pool, bt, bt[:, 0], bt[:, 0], 1.0, 64)


@pytest.mark.parametrize("d", [64, 96])
def test_decode_split_plan_at_new_widths(d):
    """The decode split plan and strip deal depend on shapes alone: the same
    at every head width (what changes is a row's bytes)."""
    assert tdecode.num_splits(64, 2, 32, 64, 132) == tdecode.num_splits(64, 2, 32, 64, 132, 2)
    strips = [s for split in range(2) for w in range(tdecode.WARPS)
              for s in tdecode.split_strips(3000, 2047, False, 2, split, w)]
    assert sorted(strips) == list(range((3000 - 2047) // tdecode.STRIP, -(-3000 // tdecode.STRIP)))


@pytest.mark.parametrize("mt", ["phi3", "internlm2"])
def test_packed_fused_checkpoint_splits_on_out_columns(mt, tmp_path):
    """A GPTQ checkpoint of a fused layout (phi3's ``qkv_proj`` /
    ``gate_up_proj``, internlm2's grouped ``wqkv``), written by
    ``rtp_llm_tpu/loader/gptq_export.py`` with act-order: each member is the
    fused tensor's canonical form cut on its out columns, as a float
    tensor's rows are cut, with the fused tensor's permutation. (The JAX
    loader gives every member the whole fused tensor there.)"""
    from safetensors.numpy import load_file

    from rtp_llm_tpu.loader.gptq_export import export_gptq_checkpoint
    from rtp_llm_tpu_torch.loader.weight_maps import get_weight_specs
    from rtp_llm_tpu_torch.ops.quant_gemm import dequantize
    from rtp_llm_tpu_torch.quant.gptq_awq import gptq_to_canonical

    dense = write_family_checkpoint(str(tmp_path), mt)
    out = os.path.join(str(tmp_path), "gptq")
    export_gptq_checkpoint(dense, out, jax_config(dense), group_size=16, act_order=True)
    cfg = port_config(out)
    tw = TLoader(cfg, device="cpu").load(out)
    st = load_file(os.path.join(out, "model.safetensors"))
    specs = {sp.name: sp for sp in get_weight_specs(cfg)}
    for name in ("q_proj", "k_proj", "v_proj") + (("gate_proj", "up_proj") if mt == "phi3"
                                                   else ()):
        base = specs[name].hf_pattern.replace("{l}", "1")[: -len(".weight")]
        v, s, z, perm = gptq_to_canonical(
            *(torch.from_numpy(st[base + x]) for x in (".qweight", ".qzeros", ".scales")),
            torch.from_numpy(st[base + ".g_idx"]))
        gi = torch.arange(v.shape[0]) // 16
        fused = (v.float() - z[gi]) * s[gi]  # [in, fused out], rows in group order
        want = TLoader._hf_rows(specs[name], fused.T, cfg).T
        zs = (tw[name + ".zero"][1] * tw[name + ".scale"][1]).repeat_interleave(16, dim=0)
        got = dequantize(tw[name][1], tw[name + ".scale"][1]) - zs
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert torch.equal(tw[name + ".act_perm"][1], perm)
