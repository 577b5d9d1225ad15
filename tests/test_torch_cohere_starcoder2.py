"""cohere and starcoder2 in the port against the JAX package, and the
reference's model-type aliases, on the CPU at tiny shapes (f32).

The checkpoints are written by HF ``transformers`` (``CohereForCausalLM``,
with ``use_qk_norm`` off and on, and ``Starcoder2ForCausalLM``) at a tiny
config, every parameter redrawn from a seeded numpy generator (norm weights
around 1, biases and linears N(0, 0.2^2)), so that the LayerNorm biases, the
linears' biases, the per-head q / k norms and ``logit_scale`` all move the
logits. starcoder2's window (6 tokens) is crossed by the 12-token prompt.

Checked: configs field by field (the JAX side of a starcoder2 comparison is
given the window explicitly: C11), the presets against the published
config.json, loaded weights bit for bit, forward logits within 1e-4 over a
prefill and two decode steps, greedy tokens through ``server.build_engine``
beside the JAX engine (starcoder2 with sliding-window recycling on), the
port against HF's ``CohereForCausalLM`` and ``Starcoder2ForCausalLM`` (C11:
the JAX package's windowless StarCoder2 differs from HF), C12 (a starcoder2
checkpoint without norm biases), the aliases and their refusals.
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
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu_torch.config import CacheConfig, EngineConfig, GenerateConfig, QuantConfig
from rtp_llm_tpu_torch.config import SchedulerConfig
from rtp_llm_tpu_torch.config import model_config as tmc
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.ops.attention import decode as tdecode
from rtp_llm_tpu_torch.ops.attention import prefill as tprefill
from rtp_llm_tpu_torch.server.server import build_engine
from tests.test_torch_gptq_awq import assert_same_weights

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

BS, NB = 4, 32
WINDOW = 6
PROMPT = [1, 5, 9, 42, 7, 3, 11, 60, 2, 33, 17, 8]
LONG = [(7 * i + 3) % 90 + 1 for i in range(30)]
KINDS = ("cohere", "cohere_qk", "starcoder2")
TOL = dict(rtol=1e-4, atol=1e-4)


def write_checkpoint(root: str, kind: str, seed: int = 0, norm_bias: bool = True) -> str:
    """A tiny HF checkpoint of ``kind`` (2 layers, 4 / 2 heads of 16),
    every parameter drawn from ``np.random.default_rng(seed)``: norm weights
    1 + N(0, 0.1^2), the rest N(0, 0.2^2). ``norm_bias`` False drops
    starcoder2's LayerNorm biases from the file (C12)."""
    from safetensors.torch import load_file, save_file
    from transformers import CohereConfig, CohereForCausalLM, Starcoder2Config
    from transformers import Starcoder2ForCausalLM

    common = dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                  eos_token_id=2, bos_token_id=1, pad_token_id=0, rope_theta=10000.0)
    if kind.startswith("cohere"):
        cfg, cls = CohereConfig(logit_scale=0.25, use_qk_norm=kind == "cohere_qk",
                                layer_norm_eps=1e-5, **common), CohereForCausalLM
    else:
        cfg, cls = Starcoder2Config(sliding_window=WINDOW, use_bias=True, norm_epsilon=1e-5,
                                    hidden_act="gelu_pytorch_tanh", **common), \
            Starcoder2ForCausalLM
    torch.manual_seed(0)
    model = cls(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            p.copy_(1.0 + 0.1 * draw if "norm" in name and name.endswith("weight")
                    else 0.2 * draw)
    path = os.path.join(root, kind if norm_bias else f"{kind}-no-norm-bias")
    model.save_pretrained(path, safe_serialization=True)
    if not norm_bias:
        f = os.path.join(path, "model.safetensors")
        t = {k: v for k, v in load_file(f).items() if not ("norm" in k and k.endswith(".bias"))}
        save_file(t, f, metadata={"format": "pt"})
    return path


def port_config(path: str) -> TConfig:
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def jax_config(path: str, window: bool = True) -> JConfig:
    """The JAX config; ``window``: given the port's window (C11)."""
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    if window:
        cfg.sliding_window = port_config(path).sliding_window
    return cfg


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohere_starcoder2"))
    out = {}
    for kind in KINDS:
        path = write_checkpoint(root, kind)
        out[kind] = (path, JLoader(jax_config(path)).load(path),
                     TLoader(port_config(path), device="cpu").load(path))
    return out


# ---- configs ----


@pytest.mark.parametrize("kind", KINDS)
def test_config_equals_jax_field_by_field(kind, ckpts):
    path = ckpts[kind][0]
    port, jax_cfg = port_config(path), jax_config(path, window=False)
    for f in dataclasses.fields(TConfig):
        if f.name == "sliding_window":
            continue
        assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    assert jax_cfg.sliding_window == 0
    if kind == "starcoder2":
        assert port.sliding_window == WINDOW and port.norm_type == "layernorm"
        assert port.hidden_act == "gelu_tanh" and not port.gated_mlp
    else:
        assert port.sliding_window == 0 and port.norm_type == "layernorm_nobias"
        assert port.parallel_residual and port.rope_gptj_pairs and port.logit_scale == 0.25
        assert port.use_qk_norm == (kind == "cohere_qk") and port.gated_mlp
    assert port.tie_word_embeddings


# the published config.json of HF bigcode/starcoder2-7b, CohereForAI/aya-23-8B
# and CohereForAI/c4ai-command-r-plus
STARCODER2_7B = {
    "architectures": ["Starcoder2ForCausalLM"], "attention_dropout": 0.1,
    "residual_dropout": 0.1, "embedding_dropout": 0.1, "bos_token_id": 0, "eos_token_id": 0,
    "hidden_act": "gelu_pytorch_tanh", "hidden_size": 4608, "initializer_range": 0.018042,
    "intermediate_size": 18432, "max_position_embeddings": 16384, "mlp_type": "default",
    "model_type": "starcoder2", "norm_epsilon": 1e-05, "norm_type": "layer_norm",
    "num_attention_heads": 36, "num_hidden_layers": 32, "num_key_value_heads": 4,
    "rope_theta": 1000000, "sliding_window": 4096, "torch_dtype": "bfloat16", "use_bias": True,
    "use_cache": True, "vocab_size": 49152}
AYA_23_8B = {
    "architectures": ["CohereForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 5, "eos_token_id": 255001, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336, "layer_norm_eps": 1e-05,
    "logit_scale": 0.125, "max_position_embeddings": 8192, "model_type": "cohere",
    "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 8,
    "pad_token_id": 0, "rope_theta": 10000, "torch_dtype": "float16", "use_cache": True,
    "use_qk_norm": False, "vocab_size": 256000}
COMMAND_R_PLUS = {
    "architectures": ["CohereForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 5, "eos_token_id": 255001, "hidden_act": "silu", "hidden_size": 12288,
    "initializer_range": 0.02, "intermediate_size": 33792, "layer_norm_eps": 1e-05,
    "logit_scale": 0.8333333333333334, "max_position_embeddings": 8192, "model_type": "cohere",
    "num_attention_heads": 96, "num_hidden_layers": 64, "num_key_value_heads": 8,
    "pad_token_id": 0, "rope_theta": 75000000.0, "torch_dtype": "float16", "use_cache": True,
    "use_qk_norm": True, "vocab_size": 256000}


@pytest.mark.parametrize("preset,hf,group", [
    ("starcoder2_7b_config", STARCODER2_7B, 9), ("aya_23_8b_config", AYA_23_8B, 4),
    ("command_r_plus_config", COMMAND_R_PLUS, 12)])
def test_presets_equal_the_published_configs(preset, hf, group):
    cfg = getattr(tmc, preset)()
    assert TConfig.from_hf_config(hf) == cfg
    jax_cfg = JConfig.from_hf_config(hf)
    for f in dataclasses.fields(TConfig):
        if f.name != "sliding_window":
            assert getattr(cfg, f.name) == getattr(jax_cfg, f.name), f.name
    hq, hkv = cfg.num_attention_heads, cfg.num_kv_heads
    assert hq // hkv == group and cfg.head_dim == 128
    tdecode.check_head(cfg.head_dim, hq, hkv, "paged_decode")  # the kernels take its group
    plan = tprefill.tile_plan(1, 2048, hq, hkv, cfg.head_dim)
    assert plan.group == group and plan.tokens == 128 // group


def test_c11_published_starcoder2_window():
    """C11: the JAX package loads StarCoder2-7B with no window (it reads
    ``sliding_window`` only under qwen2's ``use_sliding_window``); the port
    applies the 4096 HF's Starcoder2 attention applies."""
    assert JConfig.from_hf_config(STARCODER2_7B).sliding_window == 0
    assert TConfig.from_hf_config(STARCODER2_7B).sliding_window == 4096


# ---- weights and forward ----


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_weights_equal_jax(kind, ckpts):
    """Bit for bit, under the JAX names: starcoder2's ``*_norm.bias`` and
    ``*_proj.bias``, cohere's per-head ``q_norm`` / ``k_norm``, no
    ``post_attn_norm`` for cohere, no ``lm_head`` (tied)."""
    _, jw, tw = ckpts[kind]
    assert_same_weights(tw, jw)
    assert "lm_head" not in tw
    if kind == "starcoder2":
        for n in ("input_norm.bias", "post_attn_norm.bias", "final_norm.bias", "q_proj.bias",
                  "o_proj.bias", "up_proj.bias", "down_proj.bias"):
            assert n in tw, n
        assert "gate_proj" not in tw
    else:
        assert "post_attn_norm" not in tw and "gate_proj" in tw
        if kind == "cohere_qk":
            assert tw["q_norm"].shape == (2, 4, 16) and tw["k_norm"].shape == (2, 2, 16)


def _steps(bt):
    """(JAX inputs, port inputs) of a 12-token prefill (crossing the
    6-token window), then two decode steps."""
    t = len(PROMPT)
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


def _port_logits(path, tw, **cfg_kw):
    cfg = dataclasses.replace(port_config(path), **cfg_kw)
    model = LlamaFamilyModel(cfg, device="cpu")
    fused = model.fuse_weights(dict(tw))
    cache = model.init_cache(8, BS, torch.float32)
    out = []
    for tin in _steps(np.arange(1, 6, dtype=np.int32)[None])[1]:
        o, cache = model.forward(fused, cache, tin, need_all_logits=True)
        out.append((o.logits, o.all_logits))
    return out


def _jax_logits(path, jw, window=True):
    jmodel = create_model(jax_config(path, window))
    jcache = jmodel.init_cache(8, BS, jnp.float32)
    out = []
    for jin in _steps(np.arange(1, 6, dtype=np.int32)[None])[0]:
        jout, jcache = jmodel.forward(jw, jcache, jin, need_all_logits=True)
        out.append((np.asarray(jout.logits), np.asarray(jout.all_logits)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_forward_logits_match_jax(kind, ckpts):
    """Prefill and decode logits (last rows and every row, scaled by
    ``logit_scale``) against the JAX ``LlamaFamilyModel``: 1e-4 (f32; the
    two sum in different orders)."""
    path, jw, tw = ckpts[kind]
    for (got, got_all), (want, want_all) in zip(_port_logits(path, tw), _jax_logits(path, jw)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got_all.numpy(), want_all.reshape(got_all.shape), **TOL)


@pytest.mark.parametrize("field,value", [("logit_scale", 1.0), ("parallel_residual", False)])
def test_each_cohere_part_moves_the_logits(field, value, ckpts):
    """A part that changed nothing would test nothing: ``logit_scale`` and
    the parallel residual each move the logits far past the tolerance (the
    latter read with the input norm standing in for the post-attention
    one)."""
    path, _, tw = ckpts["cohere_qk"]
    tw = dict(tw, post_attn_norm=tw["input_norm"])
    base = _port_logits(path, tw)
    other = _port_logits(path, tw, **{field: value})
    assert max(float((a[0] - b[0]).abs().max()) for a, b in zip(base, other)) > 100 * TOL["atol"]


def _hf_logits(path, cls_name, prompt):
    import transformers

    model = getattr(transformers, cls_name).from_pretrained(path, torch_dtype=torch.float32)
    model.eval()
    with torch.no_grad():
        return model(torch.tensor([prompt])).logits[0].numpy()


def _port_all_logits(path, tw, prompt):
    model = LlamaFamilyModel(port_config(path), device="cpu")
    fused = model.fuse_weights(dict(tw))
    cache = model.init_cache(16, BS, torch.float32)
    t = len(prompt)
    inp = ModelInputs(tokens=torch.tensor([prompt], dtype=torch.int32),
                      positions=torch.arange(t, dtype=torch.int32)[None],
                      block_tables=torch.arange(1, 1 + -(-t // BS), dtype=torch.int32)[None],
                      kv_lens=torch.tensor([t], dtype=torch.int32),
                      q_offsets=torch.tensor([0], dtype=torch.int32))
    out, _ = model.forward(fused, cache, inp, need_all_logits=True)
    return out.all_logits.numpy()


@pytest.mark.parametrize("kind", ["cohere", "cohere_qk"])
def test_cohere_matches_hf(kind, ckpts):
    """The port against HF ``CohereForCausalLM`` (GPT-J pair RoPE, weight-only
    LayerNorms, the per-head q / k norms, ``logit_scale``), as the JAX
    package's test holds its cohere."""
    path, _, tw = ckpts[kind]
    np.testing.assert_allclose(_port_all_logits(path, tw, PROMPT),
                               _hf_logits(path, "CohereForCausalLM", PROMPT),
                               rtol=4e-4, atol=4e-4)


def test_c11_starcoder2_window_matches_hf_and_jax_differs(ckpts):
    """C11: past its 6-token window the port's StarCoder2 equals HF's
    ``Starcoder2ForCausalLM``; the JAX package, reading no window from the
    config, attends to the whole prompt and differs."""
    path, jw, tw = ckpts["starcoder2"]
    prompt = LONG[:20]
    hf = _hf_logits(path, "Starcoder2ForCausalLM", prompt)
    np.testing.assert_allclose(_port_all_logits(path, tw, prompt), hf, rtol=4e-4, atol=4e-4)
    jmodel = create_model(jax_config(path, window=False))
    t = len(prompt)
    jin = JInputs(tokens=jnp.asarray([prompt], jnp.int32),
                  positions=jnp.arange(t, dtype=jnp.int32)[None],
                  block_tables=jnp.arange(1, 1 + -(-t // BS), dtype=jnp.int32)[None],
                  kv_lens=jnp.asarray([t], jnp.int32), q_offsets=jnp.asarray([0], jnp.int32))
    jout, _ = jmodel.forward(jw, jmodel.init_cache(16, BS, jnp.float32), jin,
                             need_all_logits=True)
    jl = np.asarray(jout.all_logits).reshape(hf.shape)
    np.testing.assert_allclose(jl[:WINDOW], hf[:WINDOW], rtol=4e-4, atol=4e-4)
    assert float(np.abs(jl[WINDOW:] - hf[WINDOW:]).max()) > 100 * 4e-4


def test_c12_starcoder2_norms_without_bias(ckpts, tmp_path):
    """C12: a starcoder2 checkpoint without LayerNorm biases. The port
    keys the norm on ``norm_type`` and runs a LayerNorm of zero bias, as HF
    does (its LayerNorms keep a zero bias); the JAX package keys the
    LayerNorm on a loaded bias and runs RMSNorm there, which moves the
    logits."""
    path, _, tw = ckpts["starcoder2"]
    bare = write_checkpoint(str(tmp_path), "starcoder2", norm_bias=False)
    tw0 = TLoader(port_config(bare), device="cpu").load(bare)
    assert not any(n.endswith("_norm.bias") for n in tw0)
    zero = dict(tw0, **{n: torch.zeros_like(tw[n]) for n in tw if n.endswith("_norm.bias")})
    got = _port_all_logits(bare, tw0, PROMPT)
    np.testing.assert_allclose(got, _port_all_logits(bare, zero, PROMPT), rtol=1e-5, atol=1e-5)
    # HF with the biases at zero: the same numbers
    from transformers import Starcoder2ForCausalLM

    hf = Starcoder2ForCausalLM.from_pretrained(path, torch_dtype=torch.float32)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name and name.endswith(".bias"):
                p.zero_()
        want = hf(torch.tensor([PROMPT])).logits[0].numpy()
    np.testing.assert_allclose(got, want, rtol=4e-4, atol=4e-4)
    jw0 = JLoader(jax_config(bare)).load(bare)
    jl = [a[1] for a in _jax_logits(bare, jw0)][0].reshape(got.shape)
    assert float(np.abs(jl - got).max()) > 100 * TOL["atol"]


# ---- the model's new parts ----


def test_non_gated_fusion_and_lora_members(ckpts):
    """starcoder2: q / k / v and their ``*_proj.bias`` fuse into
    ``qkv_proj`` / ``qkv_bias``; ``up_proj`` stays alone (no gate) and
    keeps its bias; LoRA sees ``up_proj`` as a linear of its own."""
    _, _, tw = ckpts["starcoder2"]
    model = LlamaFamilyModel(port_config(ckpts["starcoder2"][0]), device="cpu")
    fused = model.fuse_weights(dict(tw))
    assert "qkv_proj" in fused and "qkv_bias" in fused and "gate_up_proj" not in fused
    assert "up_proj" in fused and "up_proj.bias" in fused and "q_proj.bias" not in fused
    assert torch.equal(fused["qkv_bias"][:, :64], tw["q_proj.bias"])
    assert "up_proj" in model.lora_members and "gate_up_proj" not in model.lora_members
    cohere = LlamaFamilyModel(port_config(ckpts["cohere"][0]), device="cpu")
    assert "gate_up_proj" in cohere.fuse_weights(dict(ckpts["cohere"][2]))


# ---- engines ----


def _port_engine(path, recycle):
    econf = EngineConfig(cache=CacheConfig(block_size=BS, num_blocks=NB,
                                           enable_prefix_cache=not recycle,
                                           swa_recycle=recycle),
                         scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=64,
                                                   prefill_buckets=(16, 64)),
                         quant=QuantConfig(kv_cache_dtype="float32"))
    return build_engine(path, econf, device="cpu", dtype="float32")


def _jax_engine(path, jw):
    jconf = JEngineConfig(cache=JCache(block_size=BS, test_num_blocks=NB),
                          scheduler=JSched(max_batch_size=4, max_seq_len=64,
                                           prefill_buckets=(16, 64)))
    jconf.quant.kv_cache_dtype = "float32"
    return JEngine(create_model(jax_config(path)), jw, jconf)


@pytest.mark.parametrize("kind", KINDS)
def test_served_tokens_match_jax_engine(kind, ckpts):
    """``server.build_engine`` serves each checkpoint with the JAX engine's
    greedy tokens (f32, blocks of 4); starcoder2 with sliding-window
    recycling on, a 30-token prompt past its window."""
    path, jw, _ = ckpts[kind]
    engine = _port_engine(path, recycle=kind == "starcoder2")
    if kind == "starcoder2":
        assert engine.cache_mgr.swa_keep > 0
    jengine = _jax_engine(path, jw)
    for prompt in (LONG, PROMPT[:5]):
        gc = dict(max_new_tokens=8, do_sample=False, ignore_eos=True)
        got = engine.generate(prompt, GenerateConfig(**gc)).output_token_ids
        want = jengine.generate(prompt, JGen(**gc)).output_token_ids
        assert got == list(want)


# ---- aliases ----

ALIASES = {"qwen_2": "qwen2", "qwen_2-mtp": "qwen2", "qwen_2_embedding": "qwen2",
           "cosyvoice_qwen": "qwen2", "qwen_3": "qwen3", "qwen_3_tool": "qwen3",
           "qwen35_dense": "qwen3", "aquila": "llama", "xverse": "llama"}


def _alias_hf(alias):
    target = ALIASES[alias]
    hf = dict(model_type=alias, vocab_size=96, hidden_size=64, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=256, rms_norm_eps=1e-5, eos_token_id=2)
    if target == "llama":
        hf["attention_bias"] = False
    return hf


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_alias_config_equals_jax(alias):
    """Each copied alias: the port's config equals the JAX one field by
    field (``model_type`` rewritten for the first table, kept for the
    second), the target's rules applied (qwen35_dense takes qwen3's q / k
    norms), its trunk's weight map and the frontend's template and
    renderer the JAX package picks."""
    from rtp_llm_tpu.frontend.chat_renderer import create_renderer as jrenderer
    from rtp_llm_tpu.frontend.legacy_templates import template_for as jtemplate
    from rtp_llm_tpu.loader.weight_maps import get_weight_specs as jspecs
    from rtp_llm_tpu_torch.frontend.chat_renderer import create_renderer
    from rtp_llm_tpu_torch.frontend.legacy_templates import template_for
    from rtp_llm_tpu_torch.loader.weight_maps import get_weight_specs

    hf = _alias_hf(alias)
    port, jax_cfg = TConfig.from_hf_config(hf), JConfig.from_hf_config(hf)
    for f in dataclasses.fields(TConfig):
        assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    assert tmc.arch_of(port.model_type) == ALIASES[alias]
    assert port.use_qk_norm == (ALIASES[alias] == "qwen3")
    assert port.attention_bias == (ALIASES[alias] == "qwen2")
    assert ({(s.name, s.hf_pattern) for s in get_weight_specs(port)}
            == {(s.name, s.hf_pattern) for s in jspecs(jax_cfg)})
    t, jt = template_for(port.model_type), jtemplate(jax_cfg.model_type)
    assert (t and t.name) == (jt and jt.name)
    assert (type(create_renderer(None, port.model_type)).__name__
            == type(jrenderer(None, jax_cfg.model_type)).__name__)


@pytest.mark.parametrize("alias", ["qwen_2", "qwen35_dense", "aquila"])
def test_alias_serves_jax_tokens(alias, tmp_path):
    """One alias a target: a checkpoint of the target's layout under the
    alias's ``model_type`` serves the JAX engine's greedy tokens."""
    target = ALIASES[alias]
    path = write_fake_checkpoint(str(tmp_path / alias), tiny_config(target), seed=3,
                                 scale=0.3, extra_config={"model_type": alias})
    jw = JLoader(jax_config(path)).load(path)
    assert_same_weights(TLoader(port_config(path), device="cpu").load(path), jw)
    engine = _port_engine(path, recycle=False)
    jengine = _jax_engine(path, jw)
    gc = dict(max_new_tokens=8, do_sample=False, ignore_eos=True)
    got = engine.generate(PROMPT, GenerateConfig(**gc)).output_token_ids
    assert got == list(jengine.generate(PROMPT, JGen(**gc)).output_token_ids)


@pytest.mark.parametrize("alias,target", [("qwen_v2_audio", "qwen2_audio"), ("kimi_k2", "deepseek_v3"),
                                          ("glm_5", "glm4_moe"), ("qwen3_next_mtp", "qwen3_next")])
def test_unserved_alias_raises_naming_its_target(alias, target):
    with pytest.raises(ValueError, match=target):
        TConfig.from_hf_config({"model_type": alias})
