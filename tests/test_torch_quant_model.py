"""The 4-bit slice as a whole, port against the JAX package on the CPU:
load-time int4 / fp4 transforms, fused quantized weights, the forward, and a
greedy engine run on packed GPTQ / AWQ checkpoints.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import QuantConfig as JQuant
from rtp_llm_tpu.config.engine_config import QuantMethod as JMethod
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.quant import make_quant_transform as j_transform
from rtp_llm_tpu.quant import weight_only as jwo
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, KernelConfig, QuantConfig, QuantMethod,
    SchedulerConfig,
)
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.loader.weight_maps import WeightSpec
from rtp_llm_tpu_torch.models import LlamaFamilyModel
from rtp_llm_tpu_torch.quant import make_quant_transform, weight_only
from rtp_llm_tpu_torch.server.server import build_engine
from tests.test_torch_gptq_awq import (
    _inputs, assert_same_weights, jax_config, jax_weights_as_numpy, port_config,
    write_packed_checkpoint,
)

GROUP = 16


@pytest.fixture(scope="module")
def float_ckpt(tmp_path_factory):
    cfg = tiny_config("qwen2", intermediate_size=64)
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("float")), cfg)


@pytest.fixture(scope="module", params=["gptq", "awq"])
def packed_ckpt(request, tmp_path_factory):
    return write_packed_checkpoint(str(tmp_path_factory.mktemp(request.param)), request.param)[0]


# ---- load-time transforms ----


@pytest.mark.parametrize("method", ["int4", "fp4"])
def test_quantizers_match_jax(method):
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((2, 128, 48)) * 0.05).astype(np.float32)
    if method == "int4":
        jq_, js = jwo.int4_quantize_groupwise(w, 32)
        q, s = weight_only.int4_quantize_groupwise(torch.from_numpy(w), 32)
    else:
        jq_, js = jwo.fp4_quantize_groupwise(w)
        q, s = weight_only.fp4_quantize_groupwise(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), jq_)
    np.testing.assert_array_equal(s.numpy(), js)
    assert tuple(jwo.E2M1_VALUES) == weight_only.E2M1_VALUES
    assert jwo.FP4_GROUP == weight_only.FP4_GROUP and jwo._NEVER == weight_only._NEVER


def test_fp4_e8m0_scales_are_powers_of_two():
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((64, 16)) * 0.05).astype(np.float32)
    jq_, js = jwo.fp4_quantize_groupwise(w, e8m0_scales=True)
    q, s = weight_only.fp4_quantize_groupwise(torch.from_numpy(w), e8m0_scales=True)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(q.numpy(), jq_)
    assert torch.equal(torch.exp2(torch.round(torch.log2(s))), s)


@pytest.mark.parametrize("method", ["int4", "fp4"])
def test_load_time_transform_tensors_equal_jax(float_ckpt, method):
    jcfg, tcfg = jax_config(float_ckpt), port_config(float_ckpt)
    jw = JLoader(jcfg, transform=j_transform(JQuant(method=method, group_size=GROUP))).load(float_ckpt)
    transform = make_quant_transform(QuantConfig(method=method, group_size=GROUP))
    tw = CheckpointLoader(tcfg, device="cpu", transform=transform).load(float_ckpt)
    marker = ".int4p" if method == "int4" else ".fp4"
    for name in ("q_proj", "o_proj", "gate_proj", "down_proj"):
        assert tw[name].dtype == torch.uint8 and tw[name + marker] is True
        assert name + ".zero" not in tw
    assert tw["lm_head"].dtype == torch.bfloat16 and "lm_head.scale" not in tw
    assert tw["embed_tokens"].dtype == torch.bfloat16 and tw["q_bias"].dtype == torch.bfloat16
    assert_same_weights(tw, jw)


# ---- fusion and the forward ----


def _fused_pair(ckpt):
    jcfg = jax_config(ckpt)
    jw = JLoader(jcfg).load(ckpt)
    jmodel = create_model(jcfg)
    model = LlamaFamilyModel(port_config(ckpt), device="cpu")
    tw = CheckpointLoader(port_config(ckpt), device="cpu").load(ckpt)
    return jmodel, jw, model, tw


def test_fused_layout_equals_jax_and_logits_agree(packed_ckpt):
    """The port's fused layout is JAX ``fuse_weights``' (packed bytes, scales
    and markers joined on the out dim), except that each ``.zero`` has
    become ``.zs = zero * scale``. JAX unfused, JAX fused and the port's
    fused forward give the same logits (1e-4, f32)."""
    jmodel, jw, model, tw = _fused_pair(packed_ckpt)
    jfused = jmodel.fuse_weights(jw)
    fused = model.fuse_weights(tw)
    assert "qkv_proj.int4p" in fused and "gate_up_proj.int4p" in fused
    assert not any(n.startswith(("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"))
                   for n in fused)
    assert set(fused) == {n[:-len(".zero")] + ".zs" if n.endswith(".zero") else n
                          for n in jfused}
    ref = weights_from_jax(jax_weights_as_numpy(jfused), device="cpu")
    for name, t in fused.items():
        if name.endswith(".zs"):
            base = name[:-len(".zs")]
            assert torch.equal(t, ref[base + ".zero"] * ref[base + ".scale"]), name
        elif isinstance(t, torch.Tensor):
            assert torch.equal(t, ref[name]), name
        else:
            assert ref[name] is True, name
    assert model.fuse_weights(fused).keys() == fused.keys()  # fusing twice is a no-op

    jin, tin = _inputs()
    cache = lambda: jmodel.init_cache(4, 16, jnp.float32)
    j_unfused, _ = jmodel.forward(jw, cache(), jin)
    j_fused, _ = jmodel.forward(jfused, cache(), jin)
    out, _ = model.forward(fused, model.init_cache(4, 16, torch.float32), tin)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(j_fused.logits), np.asarray(j_unfused.logits), **tol)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(j_unfused.logits), **tol)


@pytest.mark.parametrize("method", ["int4", "fp4"])
def test_load_time_quantized_forward_matches_jax(float_ckpt, method):
    """Both packages quantize at load and run in bf16 (the transform hands
    every float tensor back as bf16). Logits are compared as f32 at 5e-2 of
    their spread: bf16 carries 8 bits and the two packages round
    intermediates at different places; a wrong scale row or nibble moves the
    logits by the spread itself."""
    jcfg, tcfg = jax_config(float_ckpt), port_config(float_ckpt)
    jw = JLoader(jcfg, transform=j_transform(JQuant(method=method, group_size=GROUP))).load(float_ckpt)
    tw = CheckpointLoader(tcfg, device="cpu", transform=make_quant_transform(
        QuantConfig(method=method, group_size=GROUP))).load(float_ckpt)
    jmodel, model = create_model(jcfg), LlamaFamilyModel(tcfg, device="cpu")
    jin, tin = _inputs()
    jout, _ = jmodel.forward(jw, jmodel.init_cache(4, 16, jnp.bfloat16), jin)
    out, _ = model.forward(model.fuse_weights(tw), model.init_cache(4, 16, torch.bfloat16), tin)
    want = np.asarray(jout.logits, np.float32)
    assert np.abs(out.logits.numpy() - want).max() <= 5e-2 * want.std()


def test_mixed_schemes_do_not_fuse(packed_ckpt):
    _, _, model, tw = _fused_pair(packed_ckpt)
    del tw["k_proj.int4p"]
    with pytest.raises(ValueError, match="mixed quantization"):
        model.fuse_weights(tw)


# ---- the engine ----


def _engines(ckpt):
    jcfg = jax_config(ckpt)
    jconf = JEngineConfig(
        cache=JCache(block_size=4, test_num_blocks=64),
        scheduler=JSched(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 64)))
    jconf.quant.kv_cache_dtype = "float32"
    je = JEngine(create_model(jcfg), JLoader(jcfg).load(ckpt), jconf)
    conf = EngineConfig(
        cache=CacheConfig(block_size=4, num_blocks=64),
        scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 64)),
        quant=QuantConfig(kv_cache_dtype="float32"))
    return je, build_engine(ckpt, conf, device="cpu", dtype="float32")


def test_engine_greedy_tokens_match_jax_on_packed_checkpoint(packed_ckpt):
    """Two requests, greedy, f32; the second extends the first's prompt and
    must reuse its prefix blocks."""
    je, te = _engines(packed_ckpt)
    greedy = lambda cls, n: cls(max_new_tokens=n, do_sample=False, ignore_eos=True)
    prompt = [1, 5, 9, 42, 7]
    want = je.generate(prompt, greedy(JGen, 10))
    got = te.generate(prompt, greedy(GenerateConfig, 10))
    assert got.output_token_ids == want.output_token_ids
    want2 = je.generate(prompt + [100, 3], greedy(JGen, 6))
    got2 = te.generate(prompt + [100, 3], greedy(GenerateConfig, 6))
    assert got2.output_token_ids == want2.output_token_ids
    assert got2.reuse_len > 0 and got2.reuse_len == want2.reuse_len
    assert "qkv_proj.int4p" in te.weights and "qkv_proj.zs" in te.weights


def test_build_engine_quantizes_at_load_and_passes_the_pipeline_flag(float_ckpt):
    conf = EngineConfig(
        quant=QuantConfig(method="fp4"), kernel=KernelConfig(int4_pipeline=True),
        cache=CacheConfig(block_size=4, num_blocks=32),
        scheduler=SchedulerConfig(max_batch_size=2, max_seq_len=64, prefill_buckets=(16,)))
    eng = build_engine(float_ckpt, conf, device="cpu")
    assert eng.model.gemm_variant == "pipe"
    assert eng.weights["qkv_proj"].dtype == torch.uint8 and "gate_up_proj.fp4" in eng.weights
    out = eng.generate([1, 5, 9], GenerateConfig(max_new_tokens=4, do_sample=False,
                                                 ignore_eos=True))
    assert len(out.output_token_ids) == 4
    assert LlmEngine(LlamaFamilyModel(eng.model.cfg, device="cpu"), dict(eng.weights),
                     EngineConfig(cache=conf.cache, scheduler=conf.scheduler),
                     device="cpu").model.gemm_variant == "base"


# ---- the config, and what is not ported raises ----


def test_quant_config_matches_jax():
    assert {m.name: m.value for m in QuantMethod} == {m.name: m.value for m in JMethod}
    assert QuantConfig().group_size == JQuant().group_size
    assert QuantConfig().method.value == JQuant().method.value == "none"
    assert QuantConfig(method="int4").is_quantized and not QuantConfig().is_quantized
    assert make_quant_transform(QuantConfig()) is None
    assert KernelConfig().int4_pipeline is False


def test_expert_stacks_raise():
    transform = make_quant_transform(QuantConfig(method="int4", group_size=16))
    spec = WeightSpec("experts_up", "x", per_layer=True, shard_axis="expert")
    with pytest.raises(NotImplementedError, match="expert"):
        transform(spec, torch.zeros((1, 2, 64, 8)))
