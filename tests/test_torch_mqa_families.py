"""The multi-query families in the port against HF ``transformers`` and the
JAX package, on the CPU (f32, tiny shapes): gpt_bigcode (StarCoder /
WizardCoder) and falcon's multi-query and new-decoder forms.

The checkpoints are written by HF's ``GPTBigCodeForCausalLM`` /
``FalconForCausalLM`` at tiny configs (2 layers, heads of 8 dims), every
parameter redrawn from a seeded numpy generator (norm weights 1 + N(0,
0.1^2), the rest N(0, 0.2^2)): a gpt_bigcode with 18 query heads on one kv
head (G 18 > 16, the head-chunk mode's range) and one without
``multi_query``, a falcon with 18 query heads on one kv head, and falcon's
new decoder (16 / 2 heads) with ``num_ln_in_parallel_attn`` 1 and 2.

* Presets against the published config.json of bigcode/starcoder,
  tiiuae/falcon-7b and tiiuae/falcon-40b; configs field by field against
  the JAX package where it is right.
* The port against HF's models at 4e-4, every form.
* Weights bit for bit against the JAX loader and logits against the JAX
  model through ``convert.py`` (the same parameters on both sides) at 4e-4.
* Served greedy tokens beside the JAX engine: prefix reuse on and off, int8
  and fp8 pools, ``decode_steps`` 4 with async decode, beams, prompt lookup
  and LoRA on the gpt_bigcode; falcon's two forms with prefix reuse on / off.
* The reference's faults, each pinned with the port's HF-equal answer: C20
  (falcon's new-decoder QKV split), C21 (its two norms), C22 (gpt_bigcode
  without multi_query), C23 (gpt_bigcode's ``gelu_fast`` / ``gelu_new``
  taken for exact GELU), and the learned-position cap (an expected
  divergence: the JAX package clamps a position past its table).

Falcon's JAX config runs gelu_tanh and cannot load a tied checkpoint (C15,
C16, settled): the falcon checkpoints here are untied and the JAX side is
given exact GELU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.engine_config import SpeculativeConfig as JSpec
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.config.model_config import ModelConfig as JConfig
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.lora import LoraManager as JLoraManager
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig, SpeculativeConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.config.model_config import (
    falcon_7b_config, falcon_40b_config, starcoder_15b_config,
)
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.lora import LoraManager
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from tests.test_torch_gptq_awq import assert_same_weights
from tests.test_torch_lora import write_fake_adapter

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

TOL = dict(rtol=4e-4, atol=4e-4)
PROMPT = [1, 5, 9, 42, 7, 3, 11, 60, 2, 33, 17, 8, 90, 4, 4, 61]
LONG = [(7 * i + 3) % 90 + 1 for i in range(30)]
BS = 4
N_POS = 64  # the gpt_bigcodes' n_positions

# name -> (HF class, its config kwargs)
FORMS = {
    "bigcode_mqa": ("GPTBigCode", dict(n_embd=144, n_head=18, n_inner=96, multi_query=True)),
    "bigcode_mha": ("GPTBigCode", dict(n_embd=64, n_head=8, n_inner=96, multi_query=False)),
    "falcon_mqa": ("Falcon", dict(hidden_size=144, num_attention_heads=18, multi_query=True)),
    "falcon_nd1": ("Falcon", dict(hidden_size=128, num_attention_heads=16, num_kv_heads=2,
                                  new_decoder_architecture=True, num_ln_in_parallel_attn=1)),
    "falcon_nd2": ("Falcon", dict(hidden_size=128, num_attention_heads=16, num_kv_heads=2,
                                  new_decoder_architecture=True)),
}


def _redraw(model, seed, std):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            norm = any(k in name for k in ("ln_", "layernorm", ".ln"))
            p.copy_(1.0 + 0.1 * draw if norm and name.endswith("weight") else std * draw)
    return model


def write_form(path, form, std=0.2, seed=0, **over):
    import transformers

    cls, kw = FORMS[form]
    kw = dict(kw, **over)
    if cls == "GPTBigCode":
        cfg = transformers.GPTBigCodeConfig(vocab_size=128, n_layer=2, n_positions=N_POS,
                                            eos_token_id=2, bos_token_id=1, **kw)
    else:
        cfg = transformers.FalconConfig(vocab_size=128, num_hidden_layers=2, bias=False,
                                        alibi=False, parallel_attn=True, tie_word_embeddings=False,
                                        eos_token_id=2, bos_token_id=1, **kw)
    torch.manual_seed(0)
    model = getattr(transformers, cls + "ForCausalLM")(cfg)
    _redraw(model, seed, std).save_pretrained(path, safe_serialization=True)
    return path


def _rewrite(path, out, fn):
    """A copy of checkpoint ``path`` at ``out``: ``fn(tensors)`` -> tensors."""
    import shutil

    from safetensors.torch import load_file, save_file

    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(path, "config.json"), out)
    t = fn(load_file(os.path.join(path, "model.safetensors")))
    save_file(t, os.path.join(out, "model.safetensors"), metadata={"format": "pt"})
    return out


def hf_logits(path, positions=None, prompt=PROMPT):
    import transformers

    cls = "GPTBigCode" if "bigcode" in path else "Falcon"
    model = getattr(transformers, cls + "ForCausalLM").from_pretrained(
        path, torch_dtype=torch.float32)
    model.eval()
    with torch.no_grad():
        return model(torch.tensor([prompt]), position_ids=positions).logits[0].numpy()


def port_config(path):
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    return cfg


def jax_config(path):
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    if cfg.model_type == "falcon":
        cfg.hidden_act = "gelu"  # C15 aside
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


def port_logits(cfg, weights, prompt=PROMPT):
    model = LlamaFamilyModel(cfg, device="cpu")
    w = model.fuse_weights(dict(weights))
    out, _ = model.forward(w, model.init_cache(32, BS, torch.float32), _inputs(prompt, "port"),
                           need_all_logits=True)
    return out.all_logits.numpy()


def jax_logits(cfg, jw, prompt=PROMPT, start=0):
    model = create_model(cfg)
    out, _ = model.forward(jw, model.init_cache(48, BS, jnp.float32),
                           _inputs(prompt, "jax", start), need_all_logits=True)
    return np.asarray(out.all_logits).reshape(len(prompt), -1)


def _far(a, b):
    return float(np.abs(a - b).max()) > 100 * TOL["atol"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mqa"))
    return {form: write_form(os.path.join(root, form), form) for form in FORMS}


@pytest.fixture(scope="module")
def loaded(ckpts):
    """{form: (port weights, JAX weights)} of the forms the JAX loader reads
    as HF does."""
    return {form: (TLoader(port_config(ckpts[form]), device="cpu").load(ckpts[form]),
                   JLoader(jax_config(ckpts[form])).load(ckpts[form]))
            for form in ("bigcode_mqa", "falcon_mqa", "falcon_nd1")}


# ---- configs ---------------------------------------------------------------

# the published config.json of HF bigcode/starcoder, tiiuae/falcon-7b and
# tiiuae/falcon-40b
STARCODER = {
    "activation_function": "gelu", "architectures": ["GPTBigCodeForCausalLM"],
    "attention_softmax_in_fp32": True, "multi_query": True, "attn_pdrop": 0.1,
    "bos_token_id": 0, "embd_pdrop": 0.1, "eos_token_id": 0, "initializer_range": 0.02,
    "layer_norm_epsilon": 1e-05, "model_type": "gpt_bigcode", "n_embd": 6144, "n_head": 48,
    "n_inner": 24576, "n_layer": 40, "n_positions": 8192, "resid_pdrop": 0.1,
    "scale_attention_softmax_in_fp32": True, "scale_attn_weights": True,
    "summary_activation": None, "summary_first_dropout": 0.1, "summary_proj_to_labels": True,
    "summary_type": "cls_index", "summary_use_proj": True, "torch_dtype": "float32",
    "use_cache": True, "vocab_size": 49152}
FALCON_7B = {
    "alibi": False, "apply_residual_connection_post_layernorm": False,
    "architectures": ["FalconForCausalLM"], "attention_dropout": 0.0, "bias": False,
    "bos_token_id": 11, "eos_token_id": 11, "hidden_dropout": 0.0, "hidden_size": 4544,
    "initializer_range": 0.02, "layer_norm_epsilon": 1e-05, "model_type": "falcon",
    "multi_query": True, "new_decoder_architecture": False, "num_attention_heads": 71,
    "num_hidden_layers": 32, "parallel_attn": True, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 65024}
FALCON_40B = {
    "alibi": False, "apply_residual_connection_post_layernorm": False,
    "architectures": ["FalconForCausalLM"], "attention_dropout": 0.0, "bias": False,
    "bos_token_id": 11, "eos_token_id": 11, "hidden_dropout": 0.0, "hidden_size": 8192,
    "initializer_range": 0.02, "layer_norm_epsilon": 1e-05, "model_type": "falcon",
    "new_decoder_architecture": True, "num_attention_heads": 128, "num_hidden_layers": 60,
    "num_kv_heads": 8, "parallel_attn": True, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 65024}


@pytest.mark.parametrize("preset,hf", [(starcoder_15b_config, STARCODER),
                                       (falcon_7b_config, FALCON_7B),
                                       (falcon_40b_config, FALCON_40B)],
                         ids=["starcoder", "falcon_7b", "falcon_40b"])
def test_presets_equal_the_published_configs(preset, hf):
    assert TConfig.from_hf_config(hf) == preset()


# fields where the JAX config departs from HF's for falcon (C15, C16, C21)
JAX_FALCON_FAULTS = ("hidden_act", "tie_word_embeddings", "parallel_norms")


@pytest.mark.parametrize("hf", [STARCODER, FALCON_7B, FALCON_40B, dict(STARCODER, model_type="starcoder"),
                                dict(STARCODER, model_type="wizardcoder",
                                     activation_function="gelu_pytorch_tanh")],
                         ids=["starcoder", "falcon_7b", "falcon_40b", "alias_starcoder",
                              "alias_wizardcoder"])
def test_config_equals_jax_field_by_field(hf):
    """The port's config against the JAX one (the aliases keep their
    ``model_type`` on the gpt_bigcode trunk, as ARCH_ALIASES there); falcon
    but for the fields of C15, C16 and C21."""
    port, jax_cfg = TConfig.from_hf_config(hf), JConfig.from_hf_config(hf)
    skip = JAX_FALCON_FAULTS if port.model_type == "falcon" else ()
    for f in dataclasses.fields(TConfig):
        if f.name not in skip:
            assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    assert port.hidden_act == ("gelu_tanh" if hf.get("activation_function") ==
                               "gelu_pytorch_tanh" else "gelu")


def test_groups_past_the_kernels_raise():
    with pytest.raises(NotImplementedError, match="at most 128"):
        TConfig.from_hf_config(dict(FALCON_7B, hidden_size=129 * 64, num_attention_heads=129))
    with pytest.raises(NotImplementedError, match="at most 128"):
        TConfig.from_hf_config(dict(STARCODER, n_embd=136 * 128, n_head=136))


# ---- the port against HF ---------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS))
def test_port_matches_hf(form, ckpts):
    """Every row's logits of a 16-token prompt against HF's model: learned
    positions, the contiguous or per-head c_attn, falcon's contiguous,
    grouped and per-head query_key_value, one or two norms."""
    path = ckpts[form]
    cfg = port_config(path)
    got = port_logits(cfg, TLoader(cfg, device="cpu").load(path))
    np.testing.assert_allclose(got, hf_logits(path), **TOL)


# ---- the port against JAX --------------------------------------------------


@pytest.mark.parametrize("form", ["bigcode_mqa", "falcon_mqa", "falcon_nd1"])
def test_weights_and_logits_match_jax(form, ckpts, loaded):
    """Weights bit for bit (bigcode, falcon's multi-query form: the JAX
    loader reads them as HF does), and the logits of the JAX parameters
    carried over by ``convert.weights_from_jax`` against the JAX model's
    (every form, falcon's new decoder on the rows the JAX loader cuts)."""
    tw, jw = loaded[form]
    if form != "falcon_nd1":
        assert_same_weights(tw, jw)
    carried = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    cfg = port_config(ckpts[form])
    np.testing.assert_allclose(port_logits(cfg, carried), jax_logits(jax_config(ckpts[form]), jw),
                               **TOL)


def test_c20_jax_falcon_new_decoder_qkv_split(ckpts, tmp_path):
    """C20: falcon's new decoder lays ``query_key_value`` out per kv group
    (``[Hkv, G + 2, D]``, HF ``_split_heads``); the JAX spec slices it as
    contiguous ``[q; k; v]``. Its logits leave HF's, and meet them once the
    rows are reordered into the contiguous layout."""
    path = ckpts["falcon_nd1"]
    hf = hf_logits(path)
    jcfg = jax_config(path)
    assert _far(jax_logits(jcfg, JLoader(jcfg).load(path)), hf)
    hkv, g, d = 2, 8, 8

    def contiguous(t):
        out = {}
        for k, v in t.items():
            if "query_key_value" in k:
                x = v.reshape(hkv, g + 2, d, *v.shape[1:])
                v = torch.cat([x[:, :g].reshape(-1, *v.shape[1:]),
                               x[:, g].reshape(-1, *v.shape[1:]),
                               x[:, g + 1].reshape(-1, *v.shape[1:])])
            out[k] = v.contiguous()
        return out
    fixed = _rewrite(path, str(tmp_path / "nd1-contiguous"), contiguous)
    np.testing.assert_allclose(jax_logits(jcfg, JLoader(jcfg).load(fixed)), hf, **TOL)


def test_c21_jax_falcon_new_decoder_norms(ckpts):
    """C21: falcon's new decoder with ``num_ln_in_parallel_attn`` 2 (HF's
    default for the form) has ``ln_attn`` and ``ln_mlp``; the JAX map reads
    only ``input_layernorm``, so such a checkpoint does not load. The port
    maps the two norms (``parallel_norms`` "dual") and meets HF."""
    path = ckpts["falcon_nd2"]
    jcfg = jax_config(path)
    with pytest.raises(KeyError, match="input_norm|input_layernorm"):
        JLoader(jcfg).load(path)
    cfg = port_config(path)
    assert cfg.parallel_norms == "dual" and jcfg.parallel_norms == "shared"
    np.testing.assert_allclose(port_logits(cfg, TLoader(cfg, device="cpu").load(path)),
                               hf_logits(path), **TOL)


def test_c22_jax_gpt_bigcode_without_multi_query(ckpts, tmp_path):
    """C22: without ``multi_query`` HF views ``c_attn`` per head (``[Hq, 3,
    D]``); the JAX spec cuts contiguous q | k | v. Its logits leave HF's,
    and meet them once the rows are reordered into thirds."""
    path = ckpts["bigcode_mha"]
    hf = hf_logits(path)
    jcfg = jax_config(path)
    assert _far(jax_logits(jcfg, JLoader(jcfg).load(path)), hf)
    n, d = 8, 8

    def thirds(t):
        return {k: (v.reshape(n, 3, d, *v.shape[1:]).transpose(0, 1).reshape(v.shape)
                    .contiguous() if "c_attn" in k else v) for k, v in t.items()}
    fixed = _rewrite(path, str(tmp_path / "mha-thirds"), thirds)
    np.testing.assert_allclose(jax_logits(jcfg, JLoader(jcfg).load(fixed)), hf, **TOL)


def test_c23_jax_gpt_bigcode_gelu_fast(tmp_path):
    """C23: HF's ``gelu_new`` / ``gelu_fast`` are the tanh GELU; the JAX
    gpt_bigcode branch takes every name without "tanh" for exact GELU. At
    std 0.3 its logits part from HF's by more than the tolerance and meet
    them under gelu_tanh; the port reads both names as gelu_tanh."""
    path = write_form(str(tmp_path / "bigcode_gelu_fast"), "bigcode_mqa", std=0.3,
                      activation_function="gelu_fast")
    hf = hf_logits(path)
    cfg = port_config(path)
    assert cfg.hidden_act == "gelu_tanh"
    np.testing.assert_allclose(port_logits(cfg, TLoader(cfg, device="cpu").load(path)), hf,
                               **TOL)
    jcfg = jax_config(path)
    assert jcfg.hidden_act == "gelu"
    jw = JLoader(jcfg).load(path)
    assert not np.allclose(jax_logits(jcfg, jw), hf, **TOL)
    np.testing.assert_allclose(jax_logits(dataclasses.replace(jcfg, hidden_act="gelu_tanh"), jw),
                               hf, **TOL)


def test_learned_positions_cap(ckpts, loaded):
    """Learned positions: an engine caps ``max_seq_len`` at ``n_positions``
    (a longer prompt is refused with the scheduler's error, a stream stops
    at the table's end); the JAX engine, given the same ``max_seq_len``,
    serves past the table (its positions clamped to the last row): an
    expected divergence, ROADMAP C."""
    path = ckpts["bigcode_mqa"]
    tw, jw = loaded["bigcode_mqa"]
    engine = _port_engine(path, tw, msl=4 * N_POS)
    assert engine.config.scheduler.max_seq_len == N_POS
    long = engine.enqueue(list(range(1, N_POS + 1)), GenerateConfig(max_new_tokens=2))
    engine.step()
    assert long.is_finished() and "max_seq_len" in long.error
    req = [(LONG, _greedy(2 * N_POS))]
    got = _serve(engine, req, GenerateConfig)[0]
    assert len(LONG) + len(got) == N_POS
    want = _serve(_jax_engine(path, jw, msl=4 * N_POS), req, JGen)[0]
    assert len(LONG) + len(want) > N_POS and want[:len(got)] == got


# ---- engines ---------------------------------------------------------------

NB, BATCH, MSL = 64, 4, N_POS


def _port_engine(path, weights, prefix=True, kv="float32", steps=1, asy=False, spec="none",
                 msl=MSL):
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=msl, prefill_buckets=(16, 64),
                                  decode_steps=steps, async_decode=asy),
        quant=QuantConfig(kv_cache_dtype=kv),
        speculative=SpeculativeConfig(method=spec, draft_tokens=3))
    cfg = port_config(path)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"), dict(weights), econf, device="cpu")


def _jax_engine(path, jw, prefix=True, kv="float32", steps=1, asy=False, spec="none",
                msl=MSL):
    jconf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=NB, enable_prefix_cache=prefix),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=msl, prefill_buckets=(16, 64),
                         decode_steps=steps, async_decode=asy),
        speculative=JSpec(method=spec, draft_tokens=3))
    jconf.quant.kv_cache_dtype = kv
    return JEngine(create_model(jax_config(path)), jw, jconf)


def _serve(engine, reqs, gen_cls, steps=400):
    streams = [engine.enqueue(p, gen_cls(**kw)) for p, kw in reqs]
    for _ in range(steps):
        if all(s.is_finished() for s in streams):
            break
        engine.step()
    assert all(s.is_finished() for s in streams)
    return [list(s.output_token_ids) for s in streams]


def _greedy(n, **kw):
    return dict(max_new_tokens=n, do_sample=False, ignore_eos=True, **kw)


REQS = [(LONG, _greedy(8)), (PROMPT[:5], _greedy(8)), (PROMPT, _greedy(6)),
        (LONG[3:20], _greedy(7))]
# (form, engine kwargs) of each served case
SERVED = {"bigcode_prefix_on": ("bigcode_mqa", {}),
          "bigcode_prefix_off": ("bigcode_mqa", dict(prefix=False)),
          "bigcode_int8_pool": ("bigcode_mqa", dict(kv="int8")),
          "bigcode_steps4_async": ("bigcode_mqa", dict(steps=4, asy=True)),
          "bigcode_fp8_pool": ("bigcode_mqa", dict(kv="fp8")),
          "falcon_mqa_prefix_on": ("falcon_mqa", {}),
          "falcon_nd_prefix_off": ("falcon_nd1", dict(prefix=False))}


@pytest.mark.parametrize("case", sorted(SERVED))
def test_served_tokens_match_jax_engine(case, ckpts, loaded):
    """Greedy tokens of four streams served together, then the long prompt
    again behind its cached prefix, equal the JAX engine's (falcon's new
    decoder on the JAX engine's own parameters, carried over: C20)."""
    form, kw = SERVED[case]
    path = ckpts[form]
    tw, jw = loaded[form]
    if form == "falcon_nd1":
        tw = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    te, je = _port_engine(path, tw, **kw), _jax_engine(path, jw, **kw)
    for r in (REQS, REQS[:1]):
        assert _serve(te, r, GenerateConfig) == _serve(je, r, JGen)
    if kw.get("prefix", True):
        again = te.enqueue(LONG, GenerateConfig(**_greedy(2)))
        while not again.is_finished():
            te.step()
        assert again.reuse_len > 0


@pytest.mark.parametrize("feature", ["lora", "beams", "prompt_lookup"])
def test_engine_features_on_gpt_bigcode_match_jax(feature, ckpts, loaded, tmp_path):
    """The multi-query gpt_bigcode through LoRA adapters (mixed X / Y /
    none on q / k / v / o and the MLP), beam search (3 beams) and
    prompt-lookup speculation (K 3): tokens equal the JAX engine's, and
    each feature is in play."""
    path = ckpts["bigcode_mqa"]
    tw, jw = loaded["bigcode_mqa"]
    if feature == "lora":
        dims = {"q_proj": (144, 144), "k_proj": (144, 8), "v_proj": (144, 8),
                "o_proj": (144, 144), "up_proj": (144, 96), "down_proj": (96, 144)}
        te, je = _port_engine(path, tw), _jax_engine(path, jw)
        for engine, cls in ((te, LoraManager), (je, JLoraManager)):
            mgr = cls(2)
            for name, seed in (("X", 3), ("Y", 4)):
                mgr.add_adapter(write_fake_adapter(str(tmp_path / name), seed=seed, dims=dims,
                                                   targets=tuple(dims)), name=name)
            engine.set_lora_manager(mgr)
        reqs = [(LONG, _greedy(8, adapter_name="X")), (PROMPT[:5], _greedy(8)),
                (PROMPT, _greedy(6, adapter_name="Y"))]
        got = _serve(te, reqs, GenerateConfig)
        assert got == _serve(je, reqs, JGen)
        base = _serve(te, [(p, {k: v for k, v in kw.items() if k != "adapter_name"})
                           for p, kw in reqs], GenerateConfig)
        assert got[0] != base[0] and got[2] != base[2] and got[1] == base[1]
    elif feature == "beams":
        te, je = _port_engine(path, tw), _jax_engine(path, jw)
        stream = te.enqueue(PROMPT, GenerateConfig(**_greedy(8, num_beams=3)))
        while not stream.is_finished():
            te.step()
        assert [list(stream.output_token_ids)] == _serve(je, [(PROMPT, _greedy(8, num_beams=3))],
                                                         JGen)
        assert len({tuple(tokens) for tokens, _ in stream.beam_hypotheses}) == 3
    else:
        te = _port_engine(path, tw, spec="prompt_lookup")
        je = _jax_engine(path, jw, spec="prompt_lookup")
        rep = (PROMPT[:6] * 4)[:20]
        reqs = [(rep, _greedy(10)), (LONG[:12] * 2, _greedy(10))]
        assert _serve(te, reqs, GenerateConfig) == _serve(je, reqs, JGen)
        assert te.spec_stats["steps"] > 0
