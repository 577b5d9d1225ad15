"""GPTQ / AWQ packed-checkpoint ingestion of the port against the JAX
package's, on the CPU: nibble unpacking, the canonical forms, the loaded
weight dicts (bit for bit), ``weights_from_jax`` of a packed dict, and the
logits of one forward (f32).
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.config.model_config import ModelConfig as JConfig
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.loader.weight_maps import get_weight_specs, hf_names_for
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu.quant import gptq_awq as jg
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.loader import CheckpointLoader as TLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.quant import gptq_awq as tg
from tests.test_gptq_awq import (
    _quantize_and_pack, pack_awq, pack_gptq_qweight, pack_gptq_qzeros,
)

GROUP = 16
PROMPT = [1, 5, 9, 42, 7]


def write_packed_checkpoint(root: str, method: str, act_order: bool = False):
    """A tiny qwen2 checkpoint whose linears are rewritten as GPTQ or AWQ
    tensors (group 16), built as tests/test_gptq_awq.py builds it, plus the
    dense checkpoint of the dequantized weights. Returns (packed, dense)."""
    from safetensors.numpy import load_file, save_file

    cfg = tiny_config("qwen2", intermediate_size=64)
    ckpt = write_fake_checkpoint(os.path.join(root, "packed"), cfg)
    st = {k: np.array(v) for k, v in
          load_file(os.path.join(ckpt, "model.safetensors")).items()}
    quant_names = set()
    for spec in get_weight_specs(cfg):
        if (spec.shard_axis in ("out", "in") and spec.name != "lm_head"
                and not spec.name.endswith("_bias")):
            quant_names.update(n for (_l, _e, n) in hf_names_for(spec, cfg.num_layers, 0))
    new_st, deq_st = {}, dict(st)
    for name, w in st.items():
        if name not in quant_names:
            new_st[name] = w
            continue
        packed, deq = _quantize_and_pack(w, GROUP, method, act_order=act_order)
        for suffix, v in packed.items():
            new_st[f"{name[: -len('.weight')]}.{suffix}"] = v
        deq_st[name] = np.ascontiguousarray(deq.T.astype(np.float32))
    save_file(new_st, os.path.join(ckpt, "model.safetensors"))
    with open(os.path.join(ckpt, "config.json")) as f:
        hf_cfg = json.load(f)
    dense = os.path.join(root, "dense")
    os.makedirs(dense)
    save_file(deq_st, os.path.join(dense, "model.safetensors"))
    with open(os.path.join(dense, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    hf_cfg["quantization_config"] = {"quant_method": method, "bits": 4,
                                     "group_size": GROUP, "desc_act": act_order}
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    return ckpt, dense


def jax_weights_as_numpy(jw: dict) -> dict:
    """np.asarray of each entry; a quantization marker becomes an object array."""
    return {k: np.asarray(v) for k, v in jw.items()}


def assert_same_weights(tw: dict, jw: dict):
    """Every entry of the port's dict equals the JAX dict's: same names,
    dtypes and bits; markers on the same names."""
    assert set(tw) == set(jw)
    ref = weights_from_jax(jax_weights_as_numpy(jw), device="cpu")
    for name, t in tw.items():
        if not isinstance(t, torch.Tensor):
            assert t is True and ref[name] is True, name
            continue
        assert t.dtype == ref[name].dtype and t.shape == ref[name].shape, name
        assert torch.equal(t, ref[name]), name


def port_config(ckpt: str) -> TConfig:
    cfg = TConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    return cfg


def jax_config(ckpt: str) -> JConfig:
    cfg = JConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    return cfg


@pytest.fixture(scope="module", params=["gptq", "awq"])
def packed(request, tmp_path_factory):
    method = request.param
    ckpt, dense = write_packed_checkpoint(str(tmp_path_factory.mktemp(method)), method)
    jw = JLoader(jax_config(ckpt)).load(ckpt)
    tw = TLoader(port_config(ckpt), device="cpu").load(ckpt)
    return method, ckpt, dense, jw, tw


# ---- nibble packing ----


def test_gptq_unpack_roundtrip_and_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 16, (64, 16)).astype(np.uint8)
    z = rng.integers(0, 16, (4, 16)).astype(np.uint8)
    qw, qz = pack_gptq_qweight(q), pack_gptq_qzeros(z)
    np.testing.assert_array_equal(tg.unpack_gptq_qweight(torch.from_numpy(qw)).numpy(), q)
    np.testing.assert_array_equal(tg.unpack_gptq_qzeros(torch.from_numpy(qz)).numpy(), z)
    # any bit pattern, the sign bit included (torch shifts int32 arithmetically)
    words = rng.integers(-2 ** 31, 2 ** 31, (8, 16)).astype(np.int32)
    for name in ("unpack_gptq_qweight", "unpack_gptq_qzeros"):
        np.testing.assert_array_equal(
            getattr(tg, name)(torch.from_numpy(words)).numpy(), getattr(jg, name)(words))


def test_awq_unpack_roundtrip_and_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 16, (8, 32)).astype(np.uint8)
    np.testing.assert_array_equal(
        tg.unpack_awq_qweight(torch.from_numpy(pack_awq(q))).numpy(), q)
    words = rng.integers(-2 ** 31, 2 ** 31, (8, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        tg.unpack_awq_qweight(torch.from_numpy(words)).numpy(), jg.unpack_awq_qweight(words))
    assert tuple(jg.AWQ_ORDER) == tg.AWQ_ORDER


@pytest.mark.parametrize("method", ["gptq", "awq"])
def test_canonical_forms_match_jax(method):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((24, 64)).astype(np.float32)  # HF [out, in]
    t, deq = _quantize_and_pack(w, GROUP, method)
    tt = {k: torch.from_numpy(v) for k, v in t.items()}
    if method == "gptq":
        g_idx = np.arange(64, dtype=np.int32) // GROUP  # monotonic: loads
        jv, js, jz, perm = jg.gptq_to_canonical(t["qweight"], t["qzeros"], t["scales"], g_idx)
        assert perm is None
        v, s, z, tperm = tg.gptq_to_canonical(tt["qweight"], tt["qzeros"], tt["scales"],
                                              torch.from_numpy(g_idx))
        assert tperm is None
    else:
        jv, js, jz = jg.awq_to_canonical(t["qweight"], t["qzeros"], t["scales"])
        v, s, z = tg.awq_to_canonical(tt["qweight"], tt["qzeros"], tt["scales"])
    for got, want in ((v, jv), (s, js), (z, jz)):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    got = tg.dequant_reference(v.to(torch.uint8), z, s, GROUP).numpy()
    np.testing.assert_array_equal(got, jg.dequant_reference(jv.astype(np.uint8), jz, js, GROUP))
    # the checkpoint stores f16 scales (2**-11 relative) where ``deq`` used f32 ones
    np.testing.assert_allclose(got, deq, rtol=1e-3, atol=1e-3)


# ---- the loaders ----


def test_config_reads_quantization(packed):
    method, ckpt, dense, _, _ = packed
    assert port_config(ckpt).quantization == jax_config(ckpt).quantization
    assert port_config(ckpt).quantization["method"] == method
    assert port_config(dense).quantization is None


def test_loader_tensors_equal_jax(packed):
    _, _, _, jw, tw = packed
    assert tw["q_proj"].dtype == torch.uint8 and tw["q_proj.int4p"] is True
    assert tw["q_proj.scale"].dtype == torch.float32 and "q_proj.zero" in tw
    assert tw["lm_head"].dtype == torch.float32 and "lm_head.scale" not in tw
    assert_same_weights(tw, jw)


def test_weights_from_jax_carries_a_packed_dict_whole(packed):
    _, _, _, jw, tw = packed
    carried = weights_from_jax(jax_weights_as_numpy(jw), device="cpu")
    assert set(carried) == set(tw)
    assert {carried[n].dtype for n in ("q_proj", "q_proj.scale", "q_proj.zero")} == {
        torch.uint8, torch.float32}
    for name, t in tw.items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(carried[name], t), name
        else:
            assert carried[name] is True, name


def _inputs():
    t = len(PROMPT)
    arrays = dict(tokens=np.asarray([PROMPT], np.int32), positions=np.arange(t, dtype=np.int32)[None],
                  block_tables=np.asarray([[1, 2]], np.int32), kv_lens=np.asarray([t], np.int32),
                  q_offsets=np.asarray([0], np.int32))
    return (JInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            ModelInputs(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def test_forward_logits_match_jax_and_dense(packed):
    """Port against JAX on the packed weights: 1e-4 (f32, the two sum in
    different orders; the JAX CPU route is its two-step form, the port's
    plain version dequantizes first). Against the dense model of the
    dequantized weights: 2e-3, the JAX test's own tolerance."""
    _, ckpt, dense, jw, tw = packed
    jin, tin = _inputs()
    jmodel = create_model(jax_config(ckpt))
    jout, _ = jmodel.forward(jw, jmodel.init_cache(4, 16, jnp.float32), jin)
    model = LlamaFamilyModel(port_config(ckpt), device="cpu")
    out, _ = model.forward(model.fuse_weights(tw), model.init_cache(4, 16, torch.float32), tin)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits), rtol=1e-4, atol=1e-4)
    dmodel = LlamaFamilyModel(port_config(dense), device="cpu")
    dw = dmodel.fuse_weights(TLoader(port_config(dense), device="cpu").load(dense))
    dout, _ = dmodel.forward(dw, dmodel.init_cache(4, 16, torch.float32), tin)
    np.testing.assert_allclose(out.logits.numpy(), dout.logits.numpy(), rtol=2e-3, atol=2e-3)


def test_act_order_checkpoint_raises(tmp_path):
    """An act-order (desc_act) checkpoint, which the port refused before it
    carried the permutation, now loads: the same tensors as the JAX loader's,
    ``.act_perm`` included (tests/test_torch_act_order.py runs it)."""
    ckpt, _ = write_packed_checkpoint(str(tmp_path), "gptq", act_order=True)
    cfg = port_config(ckpt)
    assert cfg.quantization["desc_act"] is True
    tw = TLoader(cfg, device="cpu").load(ckpt)
    assert tw["q_proj.act_perm"].dtype == torch.int32
    assert_same_weights(tw, JLoader(jax_config(ckpt)).load(ckpt))


def test_other_checkpoint_quantization_raises():
    with pytest.raises(NotImplementedError, match="bitsandbytes"):
        TConfig.from_hf_config({"model_type": "qwen2",
                                "quantization_config": {"quant_method": "bitsandbytes"}})
