"""The 8-bit slice as a whole, port against the JAX package on the CPU:
weights quantized at load (int8 with and without the int8 LM head, fp8 at
blocks 16 / -1 / 0, W8A8, W4A8), a SmoothQuant / OmniQuant checkpoint and a
GPTQ checkpoint whose in dim does not pack; the fused layout, one forward
and a greedy engine run against the JAX engine. And the JAX package's
per-tensor fp8 fusion fault, pinned, with the port's fused linear equal to
the JAX unfused one.

Both packages quantize the same float checkpoint at load (the dicts are
compared bit for bit); the forwards and engines then run in f32 (every bf16
tensor of the quantized dict upcast on both sides), so that logits agree to
1e-4 of the largest |value| and greedy tokens are equal.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import QuantConfig as JQuant
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
from rtp_llm_tpu.config.model_config import ModelConfig as JConfig
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.loader.weight_maps import get_weight_specs, hf_names_for
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.quant import make_quant_transform as j_transform
from rtp_llm_tpu.quant import weight_only as jwo
from rtp_llm_tpu_torch.config import (
    CacheConfig, EngineConfig, GenerateConfig, QuantConfig, SchedulerConfig,
)
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.config.model_config import qwen2_1_5b_config
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel, llama_family
from rtp_llm_tpu_torch.quant import make_quant_transform
from rtp_llm_tpu_torch.server.server import build_engine
from tests.test_gptq_awq import _quantize_and_pack
from tests.test_torch_gptq_awq import (
    _inputs, assert_same_weights, jax_config, jax_weights_as_numpy, port_config,
)

LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# (method, extra QuantConfig fields) of every load-time route the engines run
ROUTES = {
    "int8": ("int8", {}),
    "int8_head": ("int8", {"quantize_lm_head": True}),
    "fp8_block16": ("fp8", {"fp8_block_size": 16}),
    "fp8_channel": ("fp8", {"fp8_block_size": -1}),
    "w8a8": ("w8a8", {}),
    "w4a8": ("w4a8", {"group_size": 32}),
}


@pytest.fixture(scope="module")
def float_ckpt(tmp_path_factory):
    cfg = tiny_config("qwen2", intermediate_size=64)
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("float8")), cfg)


def _f32(np_weights: dict) -> dict:
    """Every bf16 array upcast to f32: the forwards compare in f32."""
    return {k: (v.astype(np.float32) if v.dtype.name == "bfloat16" else v)
            for k, v in np_weights.items()}


def _loaded(ckpt, method, kw):
    """(JAX dict, port dict) of the same checkpoint quantized at load."""
    jw = JLoader(jax_config(ckpt), transform=j_transform(JQuant(method=method, **kw))).load(ckpt)
    tw = CheckpointLoader(port_config(ckpt), device="cpu",
                          transform=make_quant_transform(QuantConfig(method=method, **kw))
                          ).load(ckpt)
    return jw, tw


def _forward_both(ckpt, jw_np, fuse_jax=True, inputs=None):
    """Logits of the JAX forward (fused as its engine does, or not) and of
    the port's fused forward, on the same f32 weights."""
    jin, tin = inputs or _inputs()
    jmodel = create_model(jax_config(ckpt))
    jw = {k: (jnp.asarray(v) if v.dtype != object else v.item()) for k, v in jw_np.items()}
    if fuse_jax:
        jw = jmodel.fuse_weights(jw)
    jout, _ = jmodel.forward(jw, jmodel.init_cache(4, 16, jnp.float32), jin)
    model = LlamaFamilyModel(port_config(ckpt), device="cpu")
    out, _ = model.forward(model.fuse_weights(weights_from_jax(jw_np, device="cpu")),
                           model.init_cache(4, 16, torch.float32), tin)
    return np.asarray(jout.logits), out.logits.numpy()


def _close(got, want, rel=1e-4):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ---- load-time routes through the loader, the forward ---------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_load_time_dicts_equal_jax_and_logits_agree(float_ckpt, route):
    """The loader's dict equals the JAX loader's bit for bit (codes, scales,
    markers); one f32 forward of those weights agrees with JAX's fused one."""
    method, kw = ROUTES[route]
    jw, tw = _loaded(float_ckpt, method, kw)
    assert_same_weights(tw, jw)
    if route == "int8_head":
        assert tw["lm_head"].dtype == torch.int8 and tw["lm_head.scale"].shape == (128,)
    else:
        assert tw["lm_head"].dtype == torch.bfloat16 and "lm_head.scale" not in tw
    want, got = _forward_both(float_ckpt, _f32(jax_weights_as_numpy(jw)))
    _close(got, want)


def _fp8_per_layer(ckpt, block=0):
    """The float checkpoint's linears quantized to fp8 one layer at a time by
    the JAX package's ``fp8_quantize`` (per-tensor: ``[L]`` scales, the
    layout the JAX forward can index), everything else f32."""
    jw = jax_weights_as_numpy(JLoader(jax_config(ckpt)).load(ckpt))
    out = dict(jw)
    for name in LINEARS:
        qs = [jwo.fp8_quantize(np.asarray(m, np.float32), block) for m in jw[name]]
        out[name] = np.stack([np.asarray(q) for q, _ in qs])
        out[name + ".scale"] = np.stack([np.asarray(s, np.float32) for _, s in qs])
    return out


def test_fp8_per_tensor_loader_scales_are_one_a_layer(float_ckpt):
    """fp8 at block 0 through the loader: the port's codes and ``[L]``
    scales equal the JAX package's quantizer run on each layer; the JAX
    loader's own dict has one 0-d scale a stack (ROADMAP.md, section C)."""
    jw, tw = _loaded(float_ckpt, "fp8", {"fp8_block_size": 0})
    per_layer = _fp8_per_layer(float_ckpt)
    for name in LINEARS:
        assert np.asarray(jw[name + ".scale"]).shape == ()
        assert tw[name + ".scale"].shape == (2,)
        want = weights_from_jax({"q": per_layer[name], "s": per_layer[name + ".scale"]},
                                device="cpu")
        assert torch.equal(tw[name].view(torch.uint8), want["q"].view(torch.uint8))
        assert torch.equal(tw[name + ".scale"], want["s"])


def test_reference_indexes_a_0d_per_tensor_scale_and_fails(float_ckpt):
    """Pinned: the JAX loader's per-tensor fp8 dict (one 0-d scale a stack)
    cannot run through the JAX forward, fused (0-d scales do not
    concatenate) or unfused (``s[i]`` on a 0-d array)."""
    jw, _ = _loaded(float_ckpt, "fp8", {"fp8_block_size": 0})
    jmodel = create_model(jax_config(float_ckpt))
    jin, _ = _inputs()
    with pytest.raises(ValueError, match="Zero-dimensional"):
        jmodel.fuse_weights(jw)
    with pytest.raises(IndexError):
        jmodel.forward(jw, jmodel.init_cache(4, 16, jnp.float32), jin)


# ---- the reference's per-tensor fusion fault, not copied -----------------------


def _distinct_qkv_scales(ckpt):
    """Per-layer fp8 weights whose q, k and v differ in size by 10x (per-tensor
    scales about 1 / 10 / 0.1 of each other)."""
    jw = jax_weights_as_numpy(JLoader(jax_config(ckpt)).load(ckpt))
    jw = dict(jw, k_proj=jw["k_proj"] * 10.0, v_proj=jw["v_proj"] * 0.1)
    out = dict(jw)
    for name in LINEARS:
        qs = [jwo.fp8_quantize(np.asarray(m, np.float32), 0) for m in jw[name]]
        out[name] = np.stack([np.asarray(q) for q, _ in qs])
        out[name + ".scale"] = np.stack([np.asarray(s, np.float32) for _, s in qs])
    return out


def test_reference_per_tensor_fp8_fusion_fault_is_pinned_and_not_copied(float_ckpt):
    """JAX ``fuse_weights`` joins the ``[L]`` per-tensor scales of q, k and v
    into ``[3L]`` and its ``_linear`` takes ``s[i]``: q's scale for all three.
    Its fused logits then differ from its unfused ones by about their own
    size. The port repeats each scale over its columns before the join: its
    fused forward equals the JAX unfused one."""
    jw = _distinct_qkv_scales(float_ckpt)
    s = jw["q_proj.scale"], jw["k_proj.scale"], jw["v_proj.scale"]
    assert s[0].shape == (2,) and np.all(s[1] > 5 * s[0]) and np.all(s[2] < s[0] / 5)
    j_unfused, port = _forward_both(float_ckpt, jw, fuse_jax=False)
    j_fused, _ = _forward_both(float_ckpt, jw, fuse_jax=True)
    _close(port, j_unfused)
    assert np.abs(j_fused - j_unfused).max() > 0.1 * np.abs(j_unfused).max()
    jfused = create_model(jax_config(float_ckpt)).fuse_weights(
        {k: (jnp.asarray(v) if v.dtype != object else v.item()) for k, v in jw.items()})
    assert np.asarray(jfused["qkv_proj.scale"]).shape == (6,)  # [3L]: the fault
    model = LlamaFamilyModel(port_config(float_ckpt), device="cpu")
    fused = model.fuse_weights(weights_from_jax(jw, device="cpu"))
    assert fused["qkv_proj.scale"].shape == (2, 128)  # per channel: q 64, k 32, v 32
    assert torch.equal(fused["qkv_proj.scale"][:, 64:96],
                       torch.from_numpy(s[1])[:, None].expand(2, 32))


def test_fused_per_tensor_linear_equals_unfused_members(float_ckpt):
    """Each member's columns of the fused qkv / gate-up product equal that
    member's own product (per-tensor scales repeated over their columns)."""
    jw = weights_from_jax(_distinct_qkv_scales(float_ckpt), device="cpu")
    model = LlamaFamilyModel(port_config(float_ckpt), device="cpu")
    fused = model.fuse_weights(dict(jw))
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    for names, out_name in ((("q_proj", "k_proj", "v_proj"), "qkv_proj"),
                            (("gate_proj", "up_proj"), "gate_up_proj")):
        for i in range(2):
            got = model._linear(fused, out_name, i, x)
            want = torch.cat([model._linear(jw, n, i, x) for n in names], dim=-1)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---- fusion rules -------------------------------------------------------------


def test_fusion_carries_markers_and_per_input_vectors(float_ckpt):
    jw, tw = _loaded(float_ckpt, "w8a8", {})
    model = LlamaFamilyModel(port_config(float_ckpt), device="cpu")
    tw = dict(tw)
    for n in ("q_proj", "k_proj", "v_proj"):
        tw[n + ".smoother"] = torch.full((2, 64), 2.0)
    fused = model.fuse_weights(tw)
    assert fused["qkv_proj.w8a8"] is True and fused["gate_up_proj.w8a8"] is True
    assert torch.equal(fused["qkv_proj.smoother"], torch.full((2, 64), 2.0))
    assert not any(n.startswith(("q_proj", "k_proj", "v_proj")) for n in fused)


@pytest.mark.parametrize("case", ["smoother_differs", "smoother_missing", "marker_missing",
                                  "scale_layouts"])
def test_fusion_refuses_members_that_differ(float_ckpt, case):
    _, tw = _loaded(float_ckpt, "w8a8", {})
    model = LlamaFamilyModel(port_config(float_ckpt), device="cpu")
    tw = dict(tw)
    if case.startswith("smoother"):
        for n in ("q_proj", "k_proj", "v_proj"):
            tw[n + ".smoother"] = torch.ones((2, 64))
        if case == "smoother_differs":
            tw["v_proj.smoother"] = torch.full((2, 64), 3.0)
        else:
            del tw["k_proj.smoother"]
    elif case == "marker_missing":
        del tw["up_proj.w8a8"]
    else:
        tw["k_proj.scale"] = torch.ones((2, 2, 32))  # groupwise beside per channel
    with pytest.raises(ValueError, match="cannot fuse"):
        model.fuse_weights(tw)


# ---- W8A8 routes: integer at prefill, weight-only at decode ---------------------


class _routes:
    """Records the ``decode`` flag of every W8A8 linear call of the forward."""

    def __init__(self):
        self.flags = []

    def __enter__(self):
        orig = self.orig = llama_family.w8a8_matmul

        def spy(x, w, scale, decode=False):
            self.flags.append(decode)
            return orig(x, w, scale, decode=decode)

        llama_family.w8a8_matmul = spy
        return self

    def __exit__(self, *exc):
        llama_family.w8a8_matmul = self.orig


def test_w8a8_decode_takes_the_weight_only_route(float_ckpt):
    """A packed prefill (even of one token) and a padded forward of T > 1
    contract in integers; a decode step (padded, T = 1) takes the
    weight-only product, as the JAX package keys it on T = 1. Logits of
    both agree with JAX's."""
    jw, _ = _loaded(float_ckpt, "w8a8", {})
    w = weights_from_jax(_f32(jax_weights_as_numpy(jw)), device="cpu")
    model = LlamaFamilyModel(port_config(float_ckpt), device="cpu")
    fused = model.fuse_weights(w)
    _, tin = _inputs()
    cache = model.init_cache(4, 16, torch.float32)
    with _routes() as r:
        model.forward(fused, cache, tin)
    assert r.flags == [False] * 8
    one = tin.__class__(tokens=tin.tokens[:, :1], positions=tin.positions[:, :1],
                        block_tables=tin.block_tables, kv_lens=torch.tensor([1]),
                        q_offsets=torch.tensor([0]), row_lens=(1,))
    with _routes() as r:
        model.forward(fused, cache, one)  # a packed 1-token prompt: prefill
    assert r.flags == [False] * 8
    step = tin.__class__(tokens=torch.tensor([[3]]), positions=torch.tensor([[5]]),
                         block_tables=tin.block_tables, kv_lens=torch.tensor([6]),
                         q_offsets=torch.tensor([5]))
    with _routes() as r:
        out, _ = model.forward(fused, cache, step)
    assert r.flags == [True] * 8
    # JAX: the same prefill then the same decode step
    from rtp_llm_tpu.models.batch import ModelInputs as JInputs

    jmodel = create_model(jax_config(float_ckpt))
    jws = jmodel.fuse_weights({k: (jnp.asarray(v) if v.dtype != object else v.item())
                               for k, v in _f32(jax_weights_as_numpy(jw)).items()})
    jin, _ = _inputs()
    jcache = jmodel.init_cache(4, 16, jnp.float32)
    _, jcache = jmodel.forward(jws, jcache, jin)
    jstep = JInputs(**{k: jnp.asarray(getattr(step, k).numpy()) for k in
                       ("tokens", "positions", "block_tables", "kv_lens", "q_offsets")})
    jout, _ = jmodel.forward(jws, jcache, jstep)
    _close(out.logits.numpy(), np.asarray(jout.logits))


# ---- the engines --------------------------------------------------------------


def _jax_engine(ckpt, weights, fusion=True):
    jconf = JEngineConfig(
        cache=JCache(block_size=4, test_num_blocks=64),
        scheduler=JSched(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 64)))
    jconf.quant.kv_cache_dtype = "float32"
    jconf.kernel.disable_weight_fusion = not fusion
    return JEngine(create_model(jax_config(ckpt)), weights, jconf)


def _port_engine(ckpt, weights, cfg=None):
    conf = EngineConfig(
        cache=CacheConfig(block_size=4, num_blocks=64),
        scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 64)),
        quant=QuantConfig(kv_cache_dtype="float32"))
    return LlmEngine(LlamaFamilyModel(cfg or port_config(ckpt), device="cpu"), weights, conf,
                     device="cpu")


def _same_greedy_tokens(je, te):
    """Two requests, greedy; the second extends the first's prompt and must
    reuse its prefix blocks; then three at once."""
    greedy = lambda cls, n: cls(max_new_tokens=n, do_sample=False, ignore_eos=True)
    prompt = [1, 5, 9, 42, 7]
    for p, n in ((prompt, 10), (prompt + [100, 3], 6)):
        want = je.generate(p, greedy(JGen, n))
        got = te.generate(p, greedy(GenerateConfig, n))
        assert got.output_token_ids == want.output_token_ids
    assert got.reuse_len > 0 and got.reuse_len == want.reuse_len
    prompts = [[7, 8, 9], [11, 3, 4, 90, 2, 6, 1], [60]]
    want = [je.enqueue(p, greedy(JGen, 5)) for p in prompts]
    got = [te.enqueue(p, greedy(GenerateConfig, 5)) for p in prompts]
    while je.has_work():
        je.step()
    while te.has_work():
        te.step()
    assert [s.output_token_ids for s in got] == [s.output_token_ids for s in want]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_greedy_tokens_match_jax(float_ckpt, route):
    method, kw = ROUTES[route]
    jw, _ = _loaded(float_ckpt, method, kw)
    np_w = _f32(jax_weights_as_numpy(jw))
    je = _jax_engine(float_ckpt, {k: (jnp.asarray(v) if v.dtype != object else v.item())
                                  for k, v in np_w.items()})
    te = _port_engine(float_ckpt, weights_from_jax(np_w, device="cpu"))
    _same_greedy_tokens(je, te)


def test_engine_fp8_per_tensor_matches_jax_unfused(float_ckpt):
    """fp8 at block 0 (one scale a layer): against the JAX engine with weight
    fusion off, since its fused path gives k and v the scale of q."""
    np_w = _fp8_per_layer(float_ckpt)
    je = _jax_engine(float_ckpt, {k: (jnp.asarray(v) if v.dtype != object else v.item())
                                  for k, v in np_w.items()}, fusion=False)
    assert "q_proj" in je.weights and "qkv_proj" not in je.weights
    te = _port_engine(float_ckpt, weights_from_jax(np_w, device="cpu"))
    assert "qkv_proj" in te.weights
    try:
        _same_greedy_tokens(je, te)
    finally:  # the JAX engine pushed the switch into its process-wide flags
        _jax_engine(float_ckpt, {k: (jnp.asarray(v) if v.dtype != object else v.item())
                                 for k, v in np_w.items()}, fusion=True)


def test_build_engine_quantizes_at_load(float_ckpt):
    """``build_engine`` with int8 and the int8 head: the served layout (one
    byte a code, f32 scales, bf16 embedding, norms and biases), a generate."""
    conf = EngineConfig(
        quant=QuantConfig(method="int8", quantize_lm_head=True),
        cache=CacheConfig(block_size=4, num_blocks=32),
        scheduler=SchedulerConfig(max_batch_size=2, max_seq_len=64, prefill_buckets=(16,)))
    eng = build_engine(float_ckpt, conf, device="cpu")
    w = eng.weights
    assert w["qkv_proj"].dtype == torch.int8 and w["qkv_proj.scale"].shape == (2, 128)
    assert w["lm_head"].dtype == torch.int8 and w["embed_tokens"].dtype == torch.bfloat16
    out = eng.generate([1, 5, 9], GenerateConfig(max_new_tokens=4, do_sample=False,
                                                 ignore_eos=True))
    assert len(out.output_token_ids) == 4
    want = sum(t.numel() * t.element_size() for t in w.values() if isinstance(t, torch.Tensor))
    l, h, i, v = 2, 64, 64, 128
    codes = l * (h * 128 + 64 * h + 2 * h * i + i * h) + h * v
    assert want - codes == (l * (128 + 64 + 2 * i + h) + v) * 4 + (v * h + 2 * l * h + h
                                                                    + l * 128) * 2


# ---- pre-quantized checkpoints --------------------------------------------------


def _write_sq_checkpoint(root, with_shift):
    """A tiny SmoothQuant (or, with shifts, OmniQuant) checkpoint built as
    tests/test_quant.py builds it: int8 ``.qweight`` of the smoothed
    weights, per-out ``.scales``, ``.smoother`` shared by the linears of
    one input, ``.shift``."""
    from safetensors.numpy import load_file, save_file

    cfg = tiny_config("qwen2", hidden_size=64, intermediate_size=128)
    base = write_fake_checkpoint(os.path.join(root, "base"), cfg)
    tensors = load_file(os.path.join(base, "model.safetensors"))
    rng = np.random.default_rng(7)
    out, smoothers = {}, {}
    for name, arr in tensors.items():
        if not (name.endswith(".weight") and arr.ndim == 2 and "norm" not in name
                and "embed" not in name and "lm_head" not in name):
            out[name] = arr
            continue
        stem = name[: -len(".weight")]
        layer, kind = stem.rsplit(".", 1)
        key = (layer + {"q_proj": "qkv", "k_proj": "qkv", "v_proj": "qkv",
                        "gate_proj": "gu", "up_proj": "gu"}.get(kind, kind), arr.shape[1])
        sm = smoothers.setdefault(key, rng.uniform(0.5, 2.0, arr.shape[1]).astype(np.float32))
        ws = arr.astype(np.float32) * sm[None, :]
        scales = (np.maximum(np.abs(ws).max(axis=1, keepdims=True), 1e-8) / 127.0
                  ).astype(np.float32)
        out[stem + ".qweight"] = np.clip(np.round(ws / scales), -127, 127).astype(np.int8)
        out[stem + ".scales"] = scales.reshape(-1)
        out[stem + ".smoother"] = sm
        if with_shift:
            out[stem + ".shift"] = (rng.standard_normal(arr.shape[1]) * 0.01).astype(np.float32)
    sq = os.path.join(root, "sq")
    os.makedirs(sq)
    save_file(out, os.path.join(sq, "model.safetensors"))
    with open(os.path.join(base, "config.json")) as f:
        hf = json.load(f)
    hf["quantization_config"] = {"quant_method": "omni_quant" if with_shift else "smooth_quant"}
    with open(os.path.join(sq, "config.json"), "w") as f:
        json.dump(hf, f)
    return sq


@pytest.mark.parametrize("with_shift", [False, True])
def test_smoothquant_checkpoint_matches_jax(tmp_path, with_shift):
    """The loaded dicts equal the JAX loader's; one forward agrees; the
    engines' greedy tokens are equal. With OmniQuant shifts each linear has
    its own shift, so q/k/v and gate/up do not fuse: the JAX engine then
    serves them unfused, and the port refuses to fuse them."""
    ckpt = _write_sq_checkpoint(str(tmp_path), with_shift)
    jw = JLoader(jax_config(ckpt)).load(ckpt)
    tw = CheckpointLoader(port_config(ckpt), device="cpu").load(ckpt)
    assert port_config(ckpt).quantization == {"method": "omni_quant" if with_shift
                                               else "smooth_quant"}
    assert_same_weights(tw, jw)
    assert tw["q_proj.w8a8"] is True and tw["q_proj"].dtype == torch.int8
    assert tw["q_proj.smoother"].shape == (2, 64) and ("q_proj.shift" in tw) == with_shift
    if with_shift:
        with pytest.raises(ValueError, match="differ"):
            LlamaFamilyModel(port_config(ckpt), device="cpu").fuse_weights(tw)
        return
    want, got = _forward_both(ckpt, jax_weights_as_numpy(jw))
    _close(got, want)
    je = _jax_engine(ckpt, jw)
    assert "qkv_proj.smoother" in je.weights
    _same_greedy_tokens(je, _port_engine(ckpt, tw))


def test_shared_shift_checkpoint_fuses_and_matches_jax(tmp_path):
    """OmniQuant with the shift shared per input (what calibration gives
    linears of one input): it fuses on both sides; tokens equal."""
    from safetensors.numpy import load_file, save_file

    ckpt = _write_sq_checkpoint(str(tmp_path), True)
    st = load_file(os.path.join(ckpt, "model.safetensors"))
    for name in list(st):
        for member, lead in (("k_proj", "q_proj"), ("v_proj", "q_proj"), ("up_proj", "gate_proj")):
            if name.endswith(f"{member}.shift"):
                st[name] = st[name.replace(member, lead)]
    save_file(st, os.path.join(ckpt, "model.safetensors"))
    jw = JLoader(jax_config(ckpt)).load(ckpt)
    tw = CheckpointLoader(port_config(ckpt), device="cpu").load(ckpt)
    assert_same_weights(tw, jw)
    want, got = _forward_both(ckpt, jax_weights_as_numpy(jw))
    _close(got, want)
    je = _jax_engine(ckpt, jw)
    assert "qkv_proj.shift" in je.weights
    _same_greedy_tokens(je, _port_engine(ckpt, tw))


def _write_unpackable_gptq(root):
    """A tiny GPTQ checkpoint (group 16) whose down projection has an in dim
    of 48: three groups, which split-half packing cannot take."""
    from safetensors.numpy import load_file, save_file

    cfg = tiny_config("qwen2", intermediate_size=48)
    ckpt = write_fake_checkpoint(os.path.join(root, "gptq"), cfg)
    st = {k: np.array(v) for k, v in load_file(os.path.join(ckpt, "model.safetensors")).items()}
    quant = set()
    for spec in get_weight_specs(cfg):
        if (spec.shard_axis in ("out", "in") and spec.name != "lm_head"
                and not spec.name.endswith("_bias")):
            quant.update(n for (_l, _e, n) in hf_names_for(spec, cfg.num_layers, 0))
    out = {}
    for name, w in st.items():
        if name not in quant:
            out[name] = w
            continue
        packed, _ = _quantize_and_pack(w, 16, "gptq")
        for suffix, v in packed.items():
            out[f"{name[: -len('.weight')]}.{suffix}"] = v
    save_file(out, os.path.join(ckpt, "model.safetensors"))
    with open(os.path.join(ckpt, "config.json")) as f:
        hf = json.load(f)
    hf["quantization_config"] = {"quant_method": "gptq", "bits": 4, "group_size": 16,
                                 "desc_act": False}
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(hf, f)
    return ckpt


def test_unpackable_gptq_checkpoint_matches_jax(tmp_path):
    """The down projection loads as int8 values with scale and zero (no
    marker) and runs the 8-bit groupwise product; the rest stays packed.
    Dicts equal, logits agree, greedy tokens equal."""
    ckpt = _write_unpackable_gptq(str(tmp_path))
    jw = JLoader(jax_config(ckpt)).load(ckpt)
    tw = CheckpointLoader(port_config(ckpt), device="cpu").load(ckpt)
    assert_same_weights(tw, jw)
    assert tw["down_proj"].dtype == torch.int8 and tw["down_proj"].shape == (2, 48, 64)
    assert tw["down_proj.scale"].shape == (2, 3, 64) and "down_proj.int4p" not in tw
    assert tw["gate_proj.int4p"] is True
    want, got = _forward_both(ckpt, jax_weights_as_numpy(jw))
    _close(got, want)
    _same_greedy_tokens(_jax_engine(ckpt, jw), _port_engine(ckpt, tw))


def test_qwen2_1_5b_config_is_the_published_one():
    c = qwen2_1_5b_config()
    assert (c.hidden_size, c.intermediate_size, c.num_layers) == (1536, 8960, 28)
    assert (c.num_attention_heads, c.num_kv_heads, c.head_dim) == (12, 2, 128)
    assert c.vocab_size == 151936 and c.tie_word_embeddings and c.attention_bias
    assert c.rope_theta == 1e6 and c.rms_norm_eps == 1e-6
    hf = {"model_type": "qwen2", "vocab_size": 151936, "hidden_size": 1536,
          "intermediate_size": 8960, "num_hidden_layers": 28, "num_attention_heads": 12,
          "num_key_value_heads": 2, "max_position_embeddings": 131072, "rms_norm_eps": 1e-6,
          "rope_theta": 1000000.0, "tie_word_embeddings": True, "eos_token_id": 151643}
    t = TConfig.from_hf_config(hf)
    j = JConfig.from_hf_config(hf)
    for f in ("hidden_size", "intermediate_size", "num_layers", "num_attention_heads",
              "num_kv_heads", "head_dim", "vocab_size", "tie_word_embeddings", "rope_theta"):
        assert getattr(t, f) == getattr(c, f) == getattr(j, f), f
