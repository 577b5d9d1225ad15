"""falcon's multi-head form and bloom in the port against HF
``transformers``, and the JAX package's faults there (ROADMAP C13-C17), on
the CPU (f32, tiny shapes).

The checkpoints are written by HF's ``FalconForCausalLM`` /
``BloomForCausalLM`` at a tiny config (2 layers, 4 heads of 16), every
parameter redrawn from a seeded numpy generator: norm weights 1 + N(0,
0.1^2), the rest N(0, std^2). The port matches HF at 4e-4 with ALiBi and
RoPE, the sequential and the parallel residual, biased and unbiased linears,
tied and untied heads, bloom's names with and without the ``transformer.``
prefix. Each JAX fault is shown alone: the JAX package is given a copy of
the checkpoint whose ``query_key_value`` rows are reordered into the q / k /
v thirds it slices (C13), and weights at std 0.02, where exact and tanh
GELU agree, or its config patched to exact GELU (C14 at std 0.2; C15 needs
std 0.3 to show). Falcon's multi-query and new-decoder forms configure
(``tests/test_torch_mqa_families.py`` holds them); a group past the
kernels' 128 query heads a kv head raises at config time.
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
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.config.model_config import bloom_7b1_config, falcon_rw_1b_config
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

TOL = dict(rtol=4e-4, atol=4e-4)
PROMPT = [1, 5, 9, 42, 7, 3, 11, 60, 2, 33, 17, 8, 90, 4, 4, 61]
BS = 4

# (alibi, parallel_attn, bias, tie_word_embeddings) of each falcon case
FALCON = {"alibi_seq_bias": (True, False, True, True), "alibi_par": (True, True, False, True),
          "rope_seq_bias": (False, False, True, True), "rope_par": (False, True, False, True),
          "alibi_untied": (True, False, True, False)}


def _redraw(model, seed, std):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            p.copy_(1.0 + 0.1 * draw if "layernorm" in name or "ln_f" in name
                    else std * draw)
    return model


def write_falcon(path, alibi, parallel, bias, tie, std=0.2, seed=0):
    from transformers import FalconConfig, FalconForCausalLM

    cfg = FalconConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, multi_query=False, new_decoder_architecture=False,
                       parallel_attn=parallel, bias=bias, alibi=alibi, tie_word_embeddings=tie,
                       eos_token_id=2, bos_token_id=1)
    torch.manual_seed(0)
    _redraw(FalconForCausalLM(cfg), seed, std).save_pretrained(path, safe_serialization=True)
    return path


def write_bloom(path, std=0.2, seed=0):
    from transformers import BloomConfig, BloomForCausalLM

    cfg = BloomConfig(vocab_size=128, hidden_size=64, n_layer=2, n_head=4, eos_token_id=2)
    torch.manual_seed(0)
    _redraw(BloomForCausalLM(cfg), seed, std).save_pretrained(path, safe_serialization=True)
    return path


def _rewrite(path, out, fn):
    """A copy of checkpoint ``path`` at ``out``: ``fn(tensors)`` -> tensors;
    config.json as it is."""
    import shutil

    from safetensors.torch import load_file, save_file

    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(path, "config.json"), out)
    t = fn(load_file(os.path.join(path, "model.safetensors")))
    save_file(t, os.path.join(out, "model.safetensors"), metadata={"format": "pt"})
    return out


def to_thirds(tensors, n=4, d=16):
    """``query_key_value`` rows (and bias) from HF's per-head ``[n, 3, d]``
    into contiguous q / k / v thirds, the layout the JAX spec slices."""
    return {k: (v.reshape(n, 3, d, *v.shape[1:]).transpose(0, 1).reshape(v.shape)
                if "query_key_value" in k else v) for k, v in tensors.items()}


def hf_logits(path, cls_name):
    import transformers

    model = getattr(transformers, cls_name).from_pretrained(path, torch_dtype=torch.float32)
    model.eval()
    with torch.no_grad():
        return model(torch.tensor([PROMPT])).logits[0].numpy()


def port_logits(path):
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    model = LlamaFamilyModel(cfg, device="cpu")
    w = model.fuse_weights(TLoader(cfg, device="cpu").load(path))
    t = len(PROMPT)
    inp = ModelInputs(tokens=torch.tensor([PROMPT], dtype=torch.int32),
                      positions=torch.arange(t, dtype=torch.int32)[None],
                      block_tables=torch.arange(1, 1 + -(-t // BS), dtype=torch.int32)[None],
                      kv_lens=torch.tensor([t], dtype=torch.int32),
                      q_offsets=torch.tensor([0], dtype=torch.int32))
    out, _ = model.forward(w, model.init_cache(16, BS, torch.float32), inp, need_all_logits=True)
    return out.all_logits.numpy()


def jax_logits(path, patch=None):
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    if patch:
        patch(cfg)
    w = JLoader(cfg).load(path)
    model = create_model(cfg)
    if patch:
        patch(model)
    t = len(PROMPT)
    inp = JInputs(tokens=jnp.asarray([PROMPT], jnp.int32),
                  positions=jnp.arange(t, dtype=jnp.int32)[None],
                  block_tables=jnp.arange(1, 1 + -(-t // BS), dtype=jnp.int32)[None],
                  kv_lens=jnp.asarray([t], jnp.int32), q_offsets=jnp.asarray([0], jnp.int32))
    out, _ = model.forward(w, model.init_cache(16, BS, jnp.float32), inp, need_all_logits=True)
    return np.asarray(out.all_logits).reshape(t, -1)


def _far(a, b):
    return float(np.abs(a - b).max()) > 100 * TOL["atol"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("falcon"))


@pytest.mark.parametrize("case", sorted(FALCON))
def test_falcon_matches_hf(case, root):
    """The port against HF's ``FalconForCausalLM`` in its multi-head form:
    per-head qkv, ALiBi slopes times sm_scale (or RoPE), exact GELU, the
    sequential or parallel residual, biased or unbiased linears, tied or
    untied head."""
    path = write_falcon(os.path.join(root, case), *FALCON[case])
    np.testing.assert_allclose(port_logits(path), hf_logits(path, "FalconForCausalLM"), **TOL)


@pytest.mark.parametrize("prefixed", [True, False], ids=["transformer_prefix", "bare_names"])
def test_bloom_matches_hf(prefixed, root):
    """The port against HF's ``BloomForCausalLM`` from its own
    ``save_pretrained`` (names under ``transformer.``) and from the names the
    published bigscience/bloom-* files use (no prefix)."""
    path = write_bloom(os.path.join(root, "bloom"))
    if not prefixed:
        path = _rewrite(path, os.path.join(root, "bloom-bare"), lambda t: {
            k.removeprefix("transformer."): v for k, v in t.items()})
    np.testing.assert_allclose(port_logits(path), hf_logits(path, "BloomForCausalLM"), **TOL)


def test_c13_jax_falcon_qkv_split(root):
    """C13: the JAX spec slices ``query_key_value`` as contiguous q / k / v
    thirds; HF splits it per head (``[n, 3, d]``). Off from HF everywhere
    (RoPE, no biases, untied), and equal to HF once the rows are reordered
    into thirds."""
    path = write_falcon(os.path.join(root, "c13"), False, True, False, False, std=0.02)
    hf = hf_logits(path, "FalconForCausalLM")
    np.testing.assert_allclose(port_logits(path), hf, **TOL)
    assert _far(jax_logits(path), hf)
    thirds = _rewrite(path, os.path.join(root, "c13-thirds"), to_thirds)
    np.testing.assert_allclose(jax_logits(thirds), hf, **TOL)


def _exact_gelu(obj):
    """A JAX config patched to exact GELU (C15 aside)."""
    if isinstance(obj, JConfig):
        obj.hidden_act = "gelu"


def test_c14_jax_falcon_alibi_unscaled(root):
    """C14: HF's falcon scales the ALiBi bias with the scores, ``(qk +
    alibi) * inv_norm_factor``; the JAX package adds it unscaled. With the
    rows in thirds (C13 aside) and exact GELU (C15 aside) the JAX logits
    stay off HF's, and meet them once its slopes are multiplied by
    ``sm_scale``."""
    path = write_falcon(os.path.join(root, "c14"), True, True, False, False)
    hf = hf_logits(path, "FalconForCausalLM")
    np.testing.assert_allclose(port_logits(path), hf, **TOL)
    thirds = _rewrite(path, os.path.join(root, "c14-thirds"), to_thirds)
    assert _far(jax_logits(thirds, _exact_gelu), hf)

    def scaled(obj):
        _exact_gelu(obj)
        if getattr(obj, "alibi_slopes", None) is not None:
            obj.alibi_slopes = obj.alibi_slopes * obj.sm_scale
    np.testing.assert_allclose(jax_logits(thirds, scaled), hf, **TOL)


def test_c15_jax_falcon_gelu_tanh(root):
    """C15: HF's ``FalconMLP`` runs exact GELU; the JAX package sets
    gelu_tanh. At std 0.3 the logits part by more than the tolerance; exact
    GELU closes the gap. (At std 0.02 the two GELUs agree within it.)"""
    path = write_falcon(os.path.join(root, "c15"), False, True, False, False, std=0.3)
    hf = hf_logits(path, "FalconForCausalLM")
    np.testing.assert_allclose(port_logits(path), hf, **TOL)
    thirds = _rewrite(path, os.path.join(root, "c15-thirds"), to_thirds)
    assert not np.allclose(jax_logits(thirds), hf, **TOL)
    np.testing.assert_allclose(jax_logits(thirds, _exact_gelu), hf, **TOL)


def test_c16_jax_load_failures(root):
    """C16: the JAX falcon branch never reads ``tie_word_embeddings`` (HF's
    default is tied), so a tied checkpoint has no ``lm_head`` for it; the
    JAX bloom map reads only bare names, so ``BloomForCausalLM``'s own
    ``save_pretrained`` does not load. The port serves both as HF does."""
    tied = write_falcon(os.path.join(root, "c16-falcon"), False, True, False, True, std=0.02)
    with pytest.raises(KeyError, match="lm_head"):
        jax_logits(tied)
    np.testing.assert_allclose(port_logits(tied), hf_logits(tied, "FalconForCausalLM"), **TOL)
    bloom = write_bloom(os.path.join(root, "c16-bloom"))
    with pytest.raises(KeyError, match="embed_tokens"):
        jax_logits(bloom)
    bare = _rewrite(bloom, os.path.join(root, "c16-bloom-bare"), lambda t: {
        k.removeprefix("transformer."): v for k, v in t.items()})
    np.testing.assert_allclose(jax_logits(bare), hf_logits(bloom, "BloomForCausalLM"), **TOL)


def test_c17_jax_falcon_drops_linear_biases(root):
    """C17: with ``bias`` true (falcon-rw-1b / -7b) every falcon linear
    carries a bias; the JAX spec maps none of them, so the loader leaves
    them behind. Rows in thirds (C13 aside): the JAX logits stay off HF's,
    the port's meet them."""
    path = write_falcon(os.path.join(root, "c17"), False, True, True, False, std=0.02)
    hf = hf_logits(path, "FalconForCausalLM")
    np.testing.assert_allclose(port_logits(path), hf, **TOL)
    thirds = _rewrite(path, os.path.join(root, "c17-thirds"), to_thirds)
    assert _far(jax_logits(thirds), hf)


@pytest.mark.parametrize("hf,match", [
    (dict(multi_query=True), "multi-query"),
    (dict(multi_query=False, new_decoder_architecture=True, num_kv_heads=8), "new-decoder"),
], ids=["falcon_7b_mqa", "falcon_40b_new_decoder"])
def test_falcon_forms_the_kernels_do_not_take_raise(hf, match):
    """Falcon's multi-query form (71 query heads on one kv head at D 64) and
    new-decoder form (groups of 71 / 8, ``ln_attn`` / ``ln_mlp``) configure
    and build since the kernels' head-chunk mode; a group past the 128 query
    heads they take at D 64 raises at config time."""
    base = dict(model_type="falcon", hidden_size=4544, num_attention_heads=71, **hf)
    cfg = TConfig.from_hf_config(base)
    assert (cfg.num_kv_heads, cfg.parallel_norms, cfg.parallel_residual) == (
        (1, "shared", True) if match == "multi-query" else (8, "dual", True))
    LlamaFamilyModel(cfg, device="cpu")
    wide = 129 * cfg.num_kv_heads
    with pytest.raises(NotImplementedError, match="at most 128"):
        TConfig.from_hf_config(dict(base, hidden_size=wide * 64, num_attention_heads=wide))


# the published config.json of HF tiiuae/falcon-rw-1b and bigscience/bloom-7b1
FALCON_RW_1B = {
    "alibi": True, "apply_residual_connection_post_layernorm": False,
    "architectures": ["FalconForCausalLM"], "attention_dropout": 0.0, "bias": True,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_dropout": 0.0, "hidden_size": 2048,
    "initializer_range": 0.02, "layer_norm_epsilon": 1e-05, "model_type": "falcon",
    "multi_query": False, "new_decoder_architecture": False, "num_attention_heads": 32,
    "num_hidden_layers": 24, "parallel_attn": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 50304}
BLOOM_7B1 = {
    "apply_residual_connection_post_layernorm": False, "architectures": ["BloomForCausalLM"],
    "attention_dropout": 0.0, "attention_softmax_in_fp32": True, "bos_token_id": 1,
    "eos_token_id": 2, "hidden_dropout": 0.0, "hidden_size": 4096, "initializer_range": 0.02,
    "layer_norm_epsilon": 1e-05, "masked_softmax_fusion": True, "model_type": "bloom",
    "n_head": 32, "n_inner": None, "n_layer": 30, "offset_alibi": 100, "pad_token_id": 3,
    "pretraining_tp": 1, "skip_bias_add": True, "skip_bias_add_qkv": False,
    "slow_but_exact": False, "unk_token_id": 0, "use_cache": True, "vocab_size": 250880}


@pytest.mark.parametrize("preset,hf", [(falcon_rw_1b_config, FALCON_RW_1B),
                                       (bloom_7b1_config, BLOOM_7B1)])
def test_presets_equal_the_published_configs(preset, hf):
    assert TConfig.from_hf_config(hf) == preset()
