"""The partial-rotary families in the port against the JAX package and HF
``transformers``, on the CPU (f32, tiny shapes): glm4, chatglm (ChatGLM2 /
3), gpt_neox, phi and qwen v1.

glm4, gpt_neox (its parallel and sequential residuals) and phi checkpoints
are written by HF's ``Glm4ForCausalLM`` / ``GPTNeoXForCausalLM`` /
``PhiForCausalLM`` at tiny configs (2 layers, heads of 16 or 20 dims), every
parameter redrawn from a seeded numpy generator (norm weights 1 + N(0,
0.1^2), the rest N(0, 0.2^2)). ChatGLM and Qwen v1 ship their modelling
code outside ``transformers``: their checkpoints are written here in their
published names from the same kind of draws, and are held against the JAX
package only.

* RoPE over a slice of the head, in neox halves (gpt_neox, phi) and GPT-J
  pairs (glm4, chatglm), against the JAX functions: the rotated dims equal
  bit for bit in f32, the dims past ``rotary_dim`` untouched.
* Presets against the published config.json of microsoft/phi-2,
  THUDM/GLM-4-9B-0414, THUDM/chatglm3-6b, EleutherAI/gpt-neox-20b and
  Qwen/Qwen-7B; configs field by field against the JAX package, aliases
  included; the refusals.
* The port against HF's models at 4e-4 (glm4, gpt_neox both residuals,
  phi).
* Weights bit for bit against the JAX loader and logits of the same
  parameters against the JAX model at 4e-4, every family.
* C24: GPT-NeoX-20B's ``gelu_fast`` runs as SiLU in the JAX model.
* Qwen v1 up to ``seq_length``: both packages agree at the last positions
  of the table (the JAX package does not model ``use_dynamic_ntk`` /
  ``use_logn_attn``, which act past it: an expected divergence).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtp_llm_tpu.config.model_config import ModelConfig as JConfig
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu.ops import rope as jrope
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.config.model_config import (
    chatglm3_6b_config, glm4_9b_config, gpt_neox_20b_config, phi_2_config, qwen_7b_config,
)
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.ops import rope as trope
from tests.test_more_families import _save_manual_ckpt
from tests.test_torch_gptq_awq import assert_same_weights

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

TOL = dict(rtol=4e-4, atol=4e-4)
PROMPT = [1, 5, 9, 42, 7, 3, 11, 60, 2, 33, 17, 8, 90, 4, 4, 61]
BS = 4
V = 128

# name -> (HF class, its config kwargs): tiny forms of the families HF ships
HF_FORMS = {
    "glm4": ("Glm4", dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                          head_dim=16, intermediate_size=96, partial_rotary_factor=0.5,
                          attention_bias=True)),
    "neox_parallel": ("GPTNeoX", dict(hidden_size=64, num_attention_heads=4,
                                      intermediate_size=96, rotary_pct=0.25, hidden_act="gelu",
                                      use_parallel_residual=True)),
    "neox_sequential": ("GPTNeoX", dict(hidden_size=64, num_attention_heads=4,
                                        intermediate_size=96, rotary_pct=0.25, hidden_act="gelu",
                                        use_parallel_residual=False)),
    "phi": ("Phi", dict(hidden_size=80, num_attention_heads=4, num_key_value_heads=4,
                        intermediate_size=96, partial_rotary_factor=0.4, hidden_act="gelu_new")),
}
MANUAL_FORMS = ("chatglm", "qwen")


def _redraw(model, seed, std):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            norm = "norm" in name
            p.copy_(1.0 + 0.1 * draw if norm and name.endswith("weight") else std * draw)
    return model


def write_hf_form(path, form, std=0.2, seed=0, **over):
    import transformers

    cls, kw = HF_FORMS[form]
    kw = dict(kw, **over)
    cfg = getattr(transformers, cls + "Config")(
        vocab_size=V, num_hidden_layers=2, max_position_embeddings=256,
        tie_word_embeddings=False, eos_token_id=2, bos_token_id=1, pad_token_id=0, **kw)
    torch.manual_seed(0)
    model = getattr(transformers, cls + "ForCausalLM")(cfg)
    _redraw(model, seed, std).save_pretrained(path, safe_serialization=True)
    return path


def write_manual_form(path, form, std=0.2, seed=0):
    """A ChatGLM2 / 3 or Qwen v1 checkpoint in its published names: 2
    layers, hidden 64, heads of 16 (ChatGLM: 4 query heads on 2 kv heads,
    qkv biases; Qwen: 4 heads, full-head RoPE, c_attn biases)."""
    rng = np.random.default_rng(seed)
    h, heads, d, layers = 64, 4, 16, 2
    w = lambda *shape: rng.standard_normal(shape) * std
    norm = lambda n: 1.0 + 0.1 * rng.standard_normal(n)
    t = {}
    if form == "chatglm":
        kvh, i = 2, 96
        qd, kvd = heads * d, kvh * d
        t["transformer.embedding.word_embeddings.weight"] = w(V, h)
        t["transformer.encoder.final_layernorm.weight"] = norm(h)
        t["transformer.output_layer.weight"] = w(V, h)
        for l in range(layers):
            p = f"transformer.encoder.layers.{l}."
            t[p + "input_layernorm.weight"] = norm(h)
            t[p + "post_attention_layernorm.weight"] = norm(h)
            t[p + "self_attention.query_key_value.weight"] = w(qd + 2 * kvd, h)
            t[p + "self_attention.query_key_value.bias"] = w(qd + 2 * kvd)
            t[p + "self_attention.dense.weight"] = w(h, qd)
            t[p + "mlp.dense_h_to_4h.weight"] = w(2 * i, h)
            t[p + "mlp.dense_4h_to_h.weight"] = w(h, i)
        hf = {"model_type": "chatglm", "hidden_size": h, "num_layers": layers,
              "num_attention_heads": heads, "multi_query_attention": True,
              "multi_query_group_num": kvh, "kv_channels": d, "ffn_hidden_size": i,
              "padded_vocab_size": V, "seq_length": 256, "add_qkv_bias": True,
              "layernorm_epsilon": 1e-5, "rmsnorm": True, "add_bias_linear": False,
              "post_layer_norm": True, "apply_residual_connection_post_layernorm": False,
              "eos_token_id": 2}
    else:
        i = 96
        t["transformer.wte.weight"] = w(V, h)
        t["transformer.ln_f.weight"] = norm(h)
        t["lm_head.weight"] = w(V, h)
        for l in range(layers):
            p = f"transformer.h.{l}."
            t[p + "ln_1.weight"] = norm(h)
            t[p + "ln_2.weight"] = norm(h)
            t[p + "attn.c_attn.weight"] = w(3 * h, h)
            t[p + "attn.c_attn.bias"] = w(3 * h)
            t[p + "attn.c_proj.weight"] = w(h, h)
            t[p + "mlp.w1.weight"] = w(i, h)
            t[p + "mlp.w2.weight"] = w(i, h)
            t[p + "mlp.c_proj.weight"] = w(h, i)
        hf = {"model_type": "qwen", "vocab_size": V, "hidden_size": h, "num_hidden_layers": layers,
              "num_attention_heads": heads, "kv_channels": d, "intermediate_size": 2 * i,
              "seq_length": 256, "max_position_embeddings": 256, "layer_norm_epsilon": 1e-6,
              "rotary_emb_base": 10000, "rotary_pct": 1.0, "use_dynamic_ntk": True,
              "use_logn_attn": True, "eos_token_id": 2}
    _save_manual_ckpt(path, t, hf)
    return path


def hf_logits(path, form, prompt=PROMPT):
    import transformers

    cls = HF_FORMS[form][0]
    model = getattr(transformers, cls + "ForCausalLM").from_pretrained(
        path, torch_dtype=torch.float32)
    model.eval()
    with torch.no_grad():
        return model(torch.tensor([prompt])).logits[0].numpy()


def port_config(path):
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def jax_config(path):
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def _inputs(prompt, mod, start=0):
    t = len(prompt)
    rows = dict(tokens=np.asarray([prompt], np.int32),
                positions=np.arange(start, start + t, dtype=np.int32)[None],
                block_tables=np.arange(1, 1 + -(-(start + t) // BS), dtype=np.int32)[None],
                kv_lens=np.asarray([start + t], np.int32),
                q_offsets=np.asarray([start], np.int32))
    if mod == "jax":
        return JInputs(**{k: jnp.asarray(v) for k, v in rows.items()})
    return ModelInputs(**{k: torch.from_numpy(v) for k, v in rows.items()})


def port_logits(cfg, weights, prompt=PROMPT, start=0):
    """Every row's logits of ``prompt`` at positions ``start`` on (the
    pool's rows before it stay zero: only the positions differ)."""
    model = LlamaFamilyModel(cfg, device="cpu")
    w = model.fuse_weights(dict(weights))
    blocks = -(-(start + len(prompt)) // BS) + 2
    out, _ = model.forward(w, model.init_cache(blocks, BS, torch.float32),
                           _inputs(prompt, "port", start), need_all_logits=True)
    return out.all_logits.numpy()


def jax_logits(cfg, jw, prompt=PROMPT, start=0):
    model = create_model(cfg)
    blocks = -(-(start + len(prompt)) // BS) + 2
    out, _ = model.forward(jw, model.init_cache(blocks, BS, jnp.float32),
                           _inputs(prompt, "jax", start), need_all_logits=True)
    return np.asarray(out.all_logits).reshape(len(prompt), -1)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("partial_rotary"))
    out = {form: write_hf_form(os.path.join(root, form), form) for form in HF_FORMS}
    out.update({form: write_manual_form(os.path.join(root, form), form)
                for form in MANUAL_FORMS})
    return out


@pytest.fixture(scope="module")
def loaded(ckpts):
    """{form: (port weights, JAX weights)} from each package's loader."""
    return {form: (TLoader(port_config(path), device="cpu").load(path),
                   JLoader(jax_config(path)).load(path)) for form, path in ckpts.items()}


# ---- RoPE over a slice of the head -----------------------------------------


@pytest.mark.parametrize("d,rot", [(80, 32), (96, 24), (128, 64), (20, 8)],
                         ids=["phi2", "neox20b", "glm4", "tiny"])
@pytest.mark.parametrize("form", ["neox_halves", "gptj_pairs"])
def test_partial_rope_matches_jax(form, d, rot):
    """The tables at ``rotary_dim`` and the rotation of a head's first
    ``rotary_dim`` dims (JAX ``apply_rope_partial_neox`` /
    ``apply_rope_partial_interleaved``): the rotated dims equal the JAX
    function's bit for bit in f32, the rest are the input's."""
    cos_t, sin_t = trope.compute_rope_freqs(rot, 512, 10000.0)
    cos_j, sin_j = jrope.compute_rope_freqs(rot, 512, 10000.0)
    np.testing.assert_array_equal(cos_t, cos_j)
    rng = np.random.default_rng(d + rot)
    x = rng.standard_normal((2, 6, 4, d)).astype(np.float32)
    pos = rng.integers(0, 512, size=(2, 6))
    fn = trope.rotate_partial if form == "neox_halves" else trope.rotate_pairs_partial
    got = fn(torch.from_numpy(x), *trope.rope_at(torch.from_numpy(pos), torch.from_numpy(cos_t),
                                                 torch.from_numpy(sin_t))).numpy()
    jfn = (jrope.apply_rope_partial_neox if form == "neox_halves"
           else jrope.apply_rope_partial_interleaved)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(pos), cos_j, sin_j, rot))
    np.testing.assert_array_equal(got[..., :rot], want[..., :rot])
    np.testing.assert_array_equal(got[..., rot:], x[..., rot:])
    assert not np.array_equal(got[..., :rot], x[..., :rot])


def test_model_takes_the_partial_rotation_of_its_family():
    """The model's tables are ``rotary_dim`` wide and its rotation is the
    family's: pairs for glm4 / chatglm, halves for gpt_neox / phi, whole
    heads otherwise."""
    for preset, fn, rot in ((phi_2_config, trope.rotate_partial, 32),
                            (glm4_9b_config, trope.rotate_pairs_partial, 64),
                            (chatglm3_6b_config, trope.rotate_pairs_partial, 64),
                            (gpt_neox_20b_config, trope.rotate_partial, 24),
                            (qwen_7b_config, trope.rotate, 128)):
        cfg = dataclasses.replace(preset(), num_layers=1, max_position_embeddings=64)
        model = LlamaFamilyModel(cfg, device="cpu")
        assert cfg.rotary_dim == rot and model.cos.shape == (64, rot // 2)
        assert model.rotate is fn, preset.__name__


# ---- configs ---------------------------------------------------------------

# the published config.json of each preset's checkpoint
PHI_2 = {
    "architectures": ["PhiForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 50256,
    "embd_pdrop": 0.0, "eos_token_id": 50256, "hidden_act": "gelu_new", "hidden_size": 2560,
    "initializer_range": 0.02, "intermediate_size": 10240, "layer_norm_eps": 1e-05,
    "max_position_embeddings": 2048, "model_type": "phi", "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 32, "partial_rotary_factor": 0.4,
    "qk_layernorm": False, "resid_pdrop": 0.1, "rope_scaling": None, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float16", "use_cache": True,
    "vocab_size": 51200}
GLM4_9B = {
    "architectures": ["Glm4ForCausalLM"], "attention_bias": True, "attention_dropout": 0.0,
    "eos_token_id": [151329, 151336, 151338], "head_dim": 128, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 13696,
    "max_position_embeddings": 32768, "model_type": "glm4", "num_attention_heads": 32,
    "num_hidden_layers": 40, "num_key_value_heads": 2, "pad_token_id": 151329,
    "partial_rotary_factor": 0.5, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 151552}
CHATGLM3_6B = {
    "_name_or_path": "THUDM/chatglm3-6b", "model_type": "chatglm",
    "architectures": ["ChatGLMModel"], "add_bias_linear": False, "add_qkv_bias": True,
    "apply_query_key_layer_scaling": True, "apply_residual_connection_post_layernorm": False,
    "attention_dropout": 0.0, "attention_softmax_in_fp32": True, "bias_dropout_fusion": True,
    "ffn_hidden_size": 13696, "fp32_residual_connection": False, "hidden_dropout": 0.0,
    "hidden_size": 4096, "kv_channels": 128, "layernorm_epsilon": 1e-05,
    "multi_query_attention": True, "multi_query_group_num": 2, "num_attention_heads": 32,
    "num_layers": 28, "original_rope": True, "padded_vocab_size": 65024,
    "post_layer_norm": True, "rmsnorm": True, "seq_length": 8192, "use_cache": True,
    "torch_dtype": "float16", "tie_word_embeddings": False, "eos_token_id": 2,
    "pad_token_id": 0}
GPT_NEOX_20B = {
    "architectures": ["GPTNeoXForCausalLM"], "bos_token_id": 0, "eos_token_id": 0,
    "hidden_act": "gelu_fast", "hidden_size": 6144, "initializer_range": 0.02,
    "intermediate_size": 24576, "layer_norm_eps": 1e-05, "max_position_embeddings": 2048,
    "model_type": "gpt_neox", "num_attention_heads": 64, "num_hidden_layers": 44,
    "rotary_emb_base": 10000, "rotary_pct": 0.25, "tie_word_embeddings": False,
    "torch_dtype": "float16", "use_cache": True, "use_parallel_residual": True,
    "vocab_size": 50432}
QWEN_7B = {
    "architectures": ["QWenLMHeadModel"], "attn_dropout_prob": 0.0, "bf16": False,
    "emb_dropout_prob": 0.0, "fp16": False, "fp32": False, "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 22016, "kv_channels": 128,
    "layer_norm_epsilon": 1e-06, "max_position_embeddings": 8192, "model_type": "qwen",
    "no_bias": True, "num_attention_heads": 32, "num_hidden_layers": 32, "onnx_safe": None,
    "rotary_emb_base": 10000, "rotary_pct": 1.0, "scale_attn_weights": True,
    "seq_length": 8192, "tie_word_embeddings": False, "tokenizer_class": "QWenTokenizer",
    "use_cache": True, "use_dynamic_ntk": True, "use_flash_attn": "auto",
    "use_logn_attn": True, "vocab_size": 151936}
PUBLISHED = {"phi_2": (phi_2_config, PHI_2), "glm4_9b": (glm4_9b_config, GLM4_9B),
             "chatglm3_6b": (chatglm3_6b_config, CHATGLM3_6B),
             "gpt_neox_20b": (gpt_neox_20b_config, GPT_NEOX_20B),
             "qwen_7b": (qwen_7b_config, QWEN_7B)}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_presets_equal_the_published_configs(name):
    preset, hf = PUBLISHED[name]
    assert TConfig.from_hf_config(hf) == preset()


# the aliases of each family's type, as the JAX package maps them
ALIASES = {"glm4": ("chatglm4",), "gpt_neox": ("gpt_neox_13b",),
           "chatglm": ("chat_glm_2", "chat_glm_3", "chatglm2", "chatglm3"),
           "qwen": ("qwen_7b", "qwen_13b", "qwen_1b8", "qwen_agent", "qwen_tool")}
CONFIG_CASES = {name: hf for name, (_, hf) in PUBLISHED.items()}
CONFIG_CASES.update({f"alias_{a}": dict(hf, model_type=a) for name, (_, hf) in PUBLISHED.items()
                     for a in ALIASES.get(hf["model_type"], ())})
CONFIG_CASES["gpt_neox_gelu"] = dict(GPT_NEOX_20B, hidden_act="gelu", use_parallel_residual=False)


@pytest.mark.parametrize("name", sorted(CONFIG_CASES))
def test_config_equals_jax_field_by_field(name):
    """The port's config against the JAX one, every field the port has
    (``model_type`` rewritten or kept as each table says); gpt_neox's
    ``hidden_act`` but for C24 (``gelu_fast``: the port reads HF's tanh
    GELU, the JAX package passes the name on to a model that runs SiLU)."""
    hf = CONFIG_CASES[name]
    port, jax_cfg = TConfig.from_hf_config(hf), JConfig.from_hf_config(hf)
    for f in dataclasses.fields(TConfig):
        if f.name == "hidden_act" and hf.get("hidden_act") == "gelu_fast":
            assert (port.hidden_act, jax_cfg.hidden_act) == ("gelu_tanh", "gelu_fast")
            continue
        assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name


def test_refusals():
    """chatglm4v and glm4_moe (ROADMAP A11) still raise naming their
    family; phi's ``qk_layernorm`` and ChatGLM options outside the
    released models' raise at load."""
    for mt in ("chatglm4v", "glm4_moe", "glm_5", "glm4_moe_lite"):
        with pytest.raises(ValueError, match="not ported yet") as e:
            TConfig.from_hf_config(dict(GLM4_9B, model_type=mt))
        assert ("glm4_moe" if mt != "chatglm4v" else "chatglm4v") in str(e.value)
    with pytest.raises(NotImplementedError, match="qk_layernorm"):
        TConfig.from_hf_config(dict(PHI_2, qk_layernorm=True))
    for key, value in (("rmsnorm", False), ("add_bias_linear", True),
                       ("apply_residual_connection_post_layernorm", True),
                       ("post_layer_norm", False)):
        with pytest.raises(NotImplementedError, match=key):
            TConfig.from_hf_config(dict(CHATGLM3_6B, **{key: value}))
    with pytest.raises(NotImplementedError, match="hidden_act"):
        TConfig.from_hf_config(dict(GPT_NEOX_20B, hidden_act="relu"))


# ---- the port against HF and JAX -------------------------------------------


@pytest.mark.parametrize("form", sorted(HF_FORMS))
def test_port_matches_hf(form, ckpts):
    """Every row's logits of a 16-token prompt against HF's model: glm4's
    pairs over half the head and its sandwich norms, gpt_neox's halves over
    a quarter with either residual, phi's halves over 0.4 of a 20-dim head,
    its shared norm and the LM head's bias."""
    path = ckpts[form]
    cfg = port_config(path)
    got = port_logits(cfg, TLoader(cfg, device="cpu").load(path))
    np.testing.assert_allclose(got, hf_logits(path, form), **TOL)


@pytest.mark.parametrize("form", sorted(HF_FORMS) + list(MANUAL_FORMS))
def test_weights_and_logits_match_jax(form, ckpts, loaded):
    """Weights bit for bit against the JAX loader, and the logits of the
    JAX parameters carried over by ``convert.weights_from_jax`` against
    the JAX model's."""
    tw, jw = loaded[form]
    assert_same_weights(tw, jw)
    carried = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    path = ckpts[form]
    np.testing.assert_allclose(port_logits(port_config(path), carried),
                               jax_logits(jax_config(path), jw), **TOL)


def test_loaders_cut_the_fused_tensors_as_published(ckpts, loaded):
    """ChatGLM's ``query_key_value`` cut contiguously at [q, k, v] and its
    ``dense_h_to_4h`` as [gate | up]; Qwen v1's ``c_attn`` in thirds, ``w2``
    the gate and ``w1`` the up branch (HF ``QWenMLP``: ``w1(x) *
    silu(w2(x))``); gpt_neox's ``query_key_value`` per head."""
    from safetensors.numpy import load_file

    def raw(form):
        return load_file(os.path.join(ckpts[form], "model.safetensors"))

    t, w = raw("chatglm"), loaded["chatglm"][0]
    qkv = t["transformer.encoder.layers.1.self_attention.query_key_value.weight"]
    np.testing.assert_array_equal(w["k_proj"][1].numpy(), qkv[64:96].T)
    h4h = t["transformer.encoder.layers.0.mlp.dense_h_to_4h.weight"]
    np.testing.assert_array_equal(w["gate_proj"][0].numpy(), h4h[:96].T)
    np.testing.assert_array_equal(w["up_proj"][0].numpy(), h4h[96:].T)
    t, w = raw("qwen"), loaded["qwen"][0]
    np.testing.assert_array_equal(w["gate_proj"][1].numpy(), t["transformer.h.1.mlp.w2.weight"].T)
    np.testing.assert_array_equal(w["v_bias"][0].numpy(), t["transformer.h.0.attn.c_attn.bias"][128:])
    t, w = raw("neox_parallel"), loaded["neox_parallel"][0]
    qkv = t["gpt_neox.layers.0.attention.query_key_value.weight"].reshape(4, 3, 16, 64)
    np.testing.assert_array_equal(w["k_proj"][0].numpy(), qkv[:, 1].reshape(64, 64).T)


def test_c24_jax_gpt_neox_gelu_fast(tmp_path):
    """C24: GPT-NeoX-20B's ``hidden_act`` ``gelu_fast`` is HF's tanh GELU;
    the JAX gpt_neox branch passes the name through and its model maps
    every name but ``gelu_tanh`` / ``gelu`` to SiLU. At std 0.3 its logits
    part from HF's, and meet them under gelu_tanh; the port reads
    ``gelu_fast`` as gelu_tanh and meets HF."""
    path = write_hf_form(str(tmp_path / "neox_gelu_fast"), "neox_parallel", std=0.3,
                         hidden_act="gelu_fast")
    hf = hf_logits(path, "neox_parallel")
    cfg = port_config(path)
    assert cfg.hidden_act == "gelu_tanh"
    np.testing.assert_allclose(port_logits(cfg, TLoader(cfg, device="cpu").load(path)), hf,
                               **TOL)
    jcfg = jax_config(path)
    assert jcfg.hidden_act == "gelu_fast"
    jw = JLoader(jcfg).load(path)
    assert float(np.abs(jax_logits(jcfg, jw) - hf).max()) > 100 * TOL["atol"]
    np.testing.assert_allclose(jax_logits(dataclasses.replace(jcfg, hidden_act="gelu_tanh"), jw),
                               hf, **TOL)


def test_qwen_agrees_with_jax_up_to_seq_length(ckpts, loaded):
    """Qwen v1's tables hold ``seq_length`` positions in both packages
    (neither models ``use_dynamic_ntk`` / ``use_logn_attn``, which act only
    past it): the prompt at the last 16 positions of the table gives the
    same logits, and other logits than at position 0."""
    path = ckpts["qwen"]
    _, jw = loaded["qwen"]
    carried = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    cfg, jcfg = port_config(path), jax_config(path)
    assert cfg.max_position_embeddings == jcfg.max_position_embeddings == 256
    assert cfg.rope_scaling is None and jcfg.rope_scaling is None
    start = 256 - len(PROMPT)
    got = port_logits(cfg, carried, start=start)
    np.testing.assert_allclose(got, jax_logits(jcfg, jw, start=start), **TOL)
    assert not np.allclose(got, port_logits(cfg, carried), **TOL)
