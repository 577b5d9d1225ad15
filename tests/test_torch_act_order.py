"""GPTQ act-order (``desc_act``) checkpoints in the port against the JAX
package, on the CPU.

The checkpoints are written by ``rtp_llm_tpu/loader/gptq_export.py`` from a
tiny mistral (f32, groups of 16) with ``act_order=True``: there every
linear's input order is its own (each member of q / k / v and gate / up
has a ``g_idx`` of its own), and the port keeps such members unfused. The
``shared`` checkpoint quantizes q / k / v together and gate / up together
(one input order each, ``quantize_gptq_tensor`` on the members' rows
stacked, then split on the out columns), as AutoGPTQ writes them: the port
fuses them and gathers x once. Both load to the JAX loader's tensors bit for
bit (``.act_perm`` included), and give the JAX model's logits within 1e-4
(f32, sums in different orders); each serves the JAX engine's greedy
tokens through ``server.build_engine``.
"""

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
from rtp_llm_tpu.loader.gptq_export import export_gptq_checkpoint, quantize_gptq_tensor
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.server.server import build_engine
from tests.test_torch_gptq_awq import assert_same_weights

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

GROUP, BS = 16, 4
PROMPT = [1, 5, 9, 42, 7, 3, 11, 60, 2]
# members that share an input, AutoGPTQ's fused groups
SHARED = (("q_proj", "k_proj", "v_proj"), ("gate_proj", "up_proj"))


def _share_orders(path: str, dense: str):
    """Rewrite the act-order checkpoint at ``path`` so that each group of
    ``SHARED`` members has one input order: the members' dense rows are
    quantized together and split on the out columns."""
    from safetensors.numpy import load_file, save_file

    st = load_file(os.path.join(path, "model.safetensors"))
    src = load_file(os.path.join(dense, "model.safetensors"))
    layers = {k.split(".")[2] for k in st if k.startswith("model.layers.")}
    for l in sorted(layers):
        for group in SHARED:
            part = "self_attn" if group[0] == "q_proj" else "mlp"
            names = [f"model.layers.{l}.{part}.{m}" for m in group]
            rows = [src[n + ".weight"] for n in names]
            t = quantize_gptq_tensor(np.concatenate(rows), GROUP, act_order=True)
            start = 0
            for n, w in zip(names, rows):
                out = w.shape[0]
                st[n + ".qweight"] = np.ascontiguousarray(t["qweight"][:, start: start + out])
                st[n + ".qzeros"] = np.ascontiguousarray(
                    t["qzeros"][:, start // 8: (start + out) // 8])
                st[n + ".scales"] = np.ascontiguousarray(t["scales"][:, start: start + out])
                st[n + ".g_idx"] = t["g_idx"]
                start += out
    save_file(st, os.path.join(path, "model.safetensors"))


@pytest.fixture(scope="module", params=["own", "shared"])
def act_order(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("act_order"))
    cfg = tiny_config("mistral", dtype="float32")
    dense = write_fake_checkpoint(os.path.join(root, "dense"), cfg)
    path = os.path.join(root, "gptq")
    export_gptq_checkpoint(dense, path, cfg, group_size=GROUP, act_order=True)
    if request.param == "shared":
        _share_orders(path, dense)
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["quantization_config"]["desc_act"] is True
    jcfg = JConfig.from_pretrained(path)
    jcfg.dtype = "float32"
    tcfg = TConfig.from_pretrained(path)
    tcfg.dtype = "float32"
    return request.param, path, jcfg, tcfg, JLoader(jcfg).load(path), TLoader(
        tcfg, device="cpu").load(path)


def test_loaded_weights_equal_jax(act_order):
    kind, _, _, tcfg, jw, tw = act_order
    assert_same_weights(tw, jw)
    h, i = tcfg.hidden_size, tcfg.intermediate_size
    for name, k in (("q_proj", h), ("k_proj", h), ("o_proj", h), ("gate_proj", h),
                    ("down_proj", i)):
        perm = tw[name + ".act_perm"]
        assert perm.dtype == torch.int32 and perm.shape == (tcfg.num_layers, k)
        assert not torch.equal(perm[0], torch.arange(k, dtype=torch.int32))
    same = torch.equal(tw["q_proj.act_perm"], tw["k_proj.act_perm"])
    assert same == (kind == "shared")


def test_fusion_follows_the_permutations(act_order):
    """Shared permutations fuse (one gather); different ones stay apart."""
    kind, _, _, tcfg, _, tw = act_order
    fused = LlamaFamilyModel(tcfg, device="cpu").fuse_weights(tw)
    if kind == "shared":
        assert "qkv_proj.act_perm" in fused and "gate_up_proj.act_perm" in fused
        assert "q_proj" not in fused and "q_proj.act_perm" not in fused
    else:
        assert "qkv_proj" not in fused and "gate_up_proj" not in fused
        assert {"q_proj.act_perm", "k_proj.act_perm", "up_proj.act_perm"} <= set(fused)
    assert "o_proj.zs" in fused and "o_proj.zero" not in fused


def _steps():
    t = len(PROMPT)
    bt = np.arange(1, 5, dtype=np.int32)[None]
    rows = [dict(tokens=np.asarray([PROMPT], np.int32),
                 positions=np.arange(t, dtype=np.int32)[None], block_tables=bt,
                 kv_lens=np.asarray([t], np.int32), q_offsets=np.asarray([0], np.int32)),
            dict(tokens=np.asarray([[17]], np.int32), positions=np.asarray([[t]], np.int32),
                 block_tables=bt, kv_lens=np.asarray([t + 1], np.int32),
                 q_offsets=np.asarray([t], np.int32))]
    return ([JInputs(**{k: jnp.asarray(v) for k, v in r.items()}) for r in rows],
            [ModelInputs(**{k: torch.from_numpy(v) for k, v in r.items()}) for r in rows])


def test_forward_logits_match_jax(act_order):
    _, _, jcfg, tcfg, jw, tw = act_order
    jmodel = create_model(jcfg)
    jcache = jmodel.init_cache(6, BS, jnp.float32)
    model = LlamaFamilyModel(tcfg, device="cpu")
    weights = model.fuse_weights(tw)
    cache = model.init_cache(6, BS, torch.float32)
    for jin, tin in zip(*_steps()):
        jout, jcache = jmodel.forward(jw, jcache, jin)
        out, cache = model.forward(weights, cache, tin)
        np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                                   rtol=1e-4, atol=1e-4)


def test_served_tokens_match_jax_engine(act_order):
    kind, path, jcfg, _, jw, _ = act_order
    econf = EngineConfig(cache=CacheConfig(block_size=BS, num_blocks=16),
                         scheduler=SchedulerConfig(max_batch_size=2, max_seq_len=48,
                                                   prefill_buckets=(16, 32)),
                         quant=QuantConfig(kv_cache_dtype="float32"))
    engine = build_engine(path, econf, device="cpu", dtype="float32")
    assert ("qkv_proj" in engine.weights) == (kind == "shared")
    jconf = JEngineConfig(cache=JCache(block_size=BS, test_num_blocks=16),
                          scheduler=JSched(max_batch_size=2, max_seq_len=48,
                                           prefill_buckets=(16, 32)))
    jconf.quant.kv_cache_dtype = "float32"
    jengine = JEngine(create_model(jcfg), jw, jconf)
    got = engine.generate(PROMPT, GenerateConfig(max_new_tokens=8, do_sample=False,
                                                 ignore_eos=True)).output_token_ids
    want = jengine.generate(PROMPT, JGen(max_new_tokens=8, do_sample=False,
                                         ignore_eos=True)).output_token_ids
    assert got == list(want)
