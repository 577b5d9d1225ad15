"""The port's scaled RoPE tables against HF ``transformers`` (the oracle) and
the JAX package's, on the CPU in f32 (ROADMAP C25, C26).

Setup: HF ``LlamaForCausalLM`` and ``Qwen2ForCausalLM`` at H 64, 2 layers, 4
/ 2 heads of 16, ``max_position_embeddings`` 256, every parameter redrawn at
std 0.15 (norm weights 1 + N(0, 0.1^2)), written with ``save_pretrained`` and
read by each package's loader; one 100-token prompt.

* YaRN (factor 4, original 64; also without the original length, and with
  DeepSeek's ``mscale`` / ``mscale_all_dim``) and dynamic NTK (factor 2,
  original 64): the port's logits meet HF's within 1e-5, as the unscaled
  table's do (HF computes its frequencies and angles in f32, both packages
  in f64: at std 0.3 the logits of the same unscaled table sit 4e-5 apart).
* The JAX package's differ from HF's by more than 1.0 (C25: its ramp is
  inverted; C26: it raises the base for every position): pinned.
* The tables themselves against HF's ``ROPE_INIT_FUNCTIONS`` at several
  widths and factors (to 5e-5: HF forms its angles in f32, the port in
  f64).
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
from rtp_llm_tpu.ops import rope as jrope
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.ops import rope as trope

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

BS = 4
V = 128
PROMPT = [int(t) for t in np.random.default_rng(7).integers(3, V, 100)]
HF_TOL = 1e-5  # logits (of magnitude about 5), f32: HF's f32 frequencies and angles
# against the port's f64 ones; the unscaled table meets HF at the same level
JAX_GAP = 1.0  # the JAX package's logits sit farther than this from HF's

SCALINGS = {
    "yarn": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64},
    "yarn_no_original": {"rope_type": "yarn", "factor": 4.0},
    "yarn_mscale": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64,
                    "mscale": 1.0, "mscale_all_dim": 0.7},
    "dynamic": {"rope_type": "dynamic", "factor": 2.0, "original_max_position_embeddings": 64},
    "default": {"rope_type": "default"},
}


def _redraw(model, seed, std=0.15):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            norm = "norm" in name
            p.copy_(1.0 + 0.1 * draw if norm and name.endswith("weight") else std * draw)
    return model


def write_hf(path, arch, scaling, seed=0):
    import transformers

    cfg = getattr(transformers, arch + "Config")(
        vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_scaling=dict(scaling), tie_word_embeddings=False, eos_token_id=2,
        bos_token_id=1, pad_token_id=0)
    torch.manual_seed(0)
    model = getattr(transformers, arch + "ForCausalLM")(cfg)
    _redraw(model, seed).save_pretrained(path, safe_serialization=True)
    return path


def hf_logits(path, arch):
    import transformers

    model = getattr(transformers, arch + "ForCausalLM").from_pretrained(
        path, torch_dtype=torch.float32)
    model.eval()
    with torch.no_grad():
        return model(torch.tensor([PROMPT])).logits[0].numpy()


def _rows(prompt):
    t = len(prompt)
    return dict(tokens=np.asarray([prompt], np.int32),
                positions=np.arange(t, dtype=np.int32)[None],
                block_tables=np.arange(1, 1 + -(-t // BS), dtype=np.int32)[None],
                kv_lens=np.asarray([t], np.int32), q_offsets=np.asarray([0], np.int32))


def port_logits(path):
    cfg = TConfig.from_pretrained(path)
    cfg.dtype = "float32"
    model = LlamaFamilyModel(cfg, device="cpu")
    w = model.fuse_weights(TLoader(cfg, device="cpu").load(path))
    inputs = ModelInputs(**{k: torch.from_numpy(v) for k, v in _rows(PROMPT).items()})
    out, _ = model.forward(w, model.init_cache(-(-len(PROMPT) // BS) + 2, BS, torch.float32),
                           inputs, need_all_logits=True)
    return out.all_logits.numpy()


def jax_logits(path):
    cfg = JConfig.from_pretrained(path)
    cfg.dtype = "float32"
    model = create_model(cfg)
    inputs = JInputs(**{k: jnp.asarray(v) for k, v in _rows(PROMPT).items()})
    out, _ = model.forward(JLoader(cfg).load(path),
                           model.init_cache(-(-len(PROMPT) // BS) + 2, BS, jnp.float32),
                           inputs, need_all_logits=True)
    return np.asarray(out.all_logits).reshape(len(PROMPT), -1)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rope_scaling"))
    return {(arch, name): write_hf(os.path.join(root, f"{arch}_{name}"), arch, scaling)
            for arch in ("Llama", "Qwen2") for name, scaling in SCALINGS.items()}


@pytest.mark.parametrize("arch", ["Llama", "Qwen2"])
@pytest.mark.parametrize("name", list(SCALINGS))
def test_port_logits_meet_hf(ckpts, arch, name):
    path = ckpts[(arch, name)]
    want = hf_logits(path, arch)
    got = port_logits(path)
    assert np.abs(got - want).max() < HF_TOL


@pytest.mark.parametrize("name", ["yarn", "dynamic"])
def test_c25_c26_jax_tables_differ_from_hf(ckpts, name):
    """C25 / C26: the JAX package's logits sit more than ``JAX_GAP`` from
    HF's (about 6 for both, of 4.6, on this setup), the port's within
    ``HF_TOL``."""
    path = ckpts[("Llama", name)]
    want = hf_logits(path, "Llama")
    assert np.abs(jax_logits(path) - want).max() > JAX_GAP
    assert np.abs(port_logits(path) - want).max() < HF_TOL


def _hf_tables(scaling, dim, max_len, max_pos, theta=10000.0):
    """HF's (cos, sin) half tables: its init function's frequencies and
    attention factor, over positions 0 .. max_len - 1 in f32."""
    import transformers
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS

    cfg = transformers.LlamaConfig(hidden_size=dim * 4, num_attention_heads=4,
                                   max_position_embeddings=max_pos, rope_theta=theta,
                                   rope_scaling=dict(scaling))
    inv, attn = ROPE_INIT_FUNCTIONS[scaling["rope_type"]](cfg, "cpu")
    freqs = torch.arange(max_len, dtype=torch.float32)[:, None] * inv[None, :].float()
    return (freqs.cos() * attn).numpy(), (freqs.sin() * attn).numpy()


@pytest.mark.parametrize("dim,factor,orig", [(16, 4.0, 64), (32, 8.0, 128), (128, 4.0, 32768),
                                             (64, 2.0, None)])
@pytest.mark.parametrize("rtype", ["yarn", "dynamic"])
def test_tables_meet_hf(dim, factor, orig, rtype):
    scaling = {"rope_type": rtype, "factor": factor}
    if orig:
        scaling["original_max_position_embeddings"] = orig
    max_pos = 4 * (orig or 1024)
    cos_w, sin_w = _hf_tables(scaling, dim, 512, max_pos)
    cos, sin = trope.compute_rope_freqs(dim, 512, 10000.0, scaling, max_pos)
    # HF forms the angles (up to 511 rad) in f32: half an ulp there is 3e-5
    np.testing.assert_allclose(cos, cos_w, atol=5e-5, rtol=0)
    np.testing.assert_allclose(sin, sin_w, atol=5e-5, rtol=0)
    if rtype == "dynamic":  # within the table, HF's dynamic table is the unscaled one
        base = trope.compute_rope_freqs(dim, 512, 10000.0, None)
        np.testing.assert_array_equal(cos, base[0])
    if orig:  # the JAX package's table differs (C25 / C26)
        jc, _ = jrope.compute_rope_freqs(dim, 512, 10000.0, scaling)
        assert np.abs(np.asarray(jc) - cos_w).max() > 1e-2
