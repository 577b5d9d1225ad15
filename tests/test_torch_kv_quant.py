"""Quantized KV cache of the port vs the JAX package, on the CPU.

int8 pool with per-(slot, kv-head) bf16 scales and fp8 (e4m3) pool: the
quantizer, the quantized writes, the plain attention with scales (also against
the JAX Pallas quant kernel in interpret mode), the model forward on both
pools and the deferred-write forward. Inputs come from numpy seeds and go to
both sides. Tolerances: quantized bytes and bf16 scale bits equal; f32
attention within 1e-5; model logits within 1e-4 (f32, summation order
differs). The CUDA kernels run only on the GPU: ``chip_smoke.py`` holds them
against the plain version tested here.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.models.batch import ModelInputs as JInputs
from rtp_llm_tpu.ops import kv_cache as jkv
from rtp_llm_tpu.ops.attention import _expand_kv_scales
from rtp_llm_tpu.ops.attention import paged_attention_ref as j_ref
from rtp_llm_tpu_torch.config.model_config import ModelConfig as TConfig
from rtp_llm_tpu_torch.convert import cache_from_jax, weights_from_jax
from rtp_llm_tpu_torch.models import LlamaFamilyModel, ModelInputs
from rtp_llm_tpu_torch.models.llama_family import torch_dtype
from rtp_llm_tpu_torch.ops import attention as tattn
from rtp_llm_tpu_torch.ops import kv_cache as tkv
from rtp_llm_tpu_torch.ops.attention import decode as tdecode
from rtp_llm_tpu_torch.ops.attention import prefill as tprefill

BS = 16
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
FP8 = torch.float8_e4m3fn


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _bf16_bits(a):
    """A bf16 array (torch or numpy/ml_dtypes) as its 16-bit words."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _fp8_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


# ---- quantize_kv / write_kv_quant ----


def _kv_rows(seed, t=9, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((t, hkv, d)).astype(np.float32) * 3.0
    v = rng.standard_normal((t, hkv, d)).astype(np.float32) * 0.2
    k[1] = 0.0  # all-zero rows: the 1e-8 floor of the scale
    v[2, 0] = 0.0
    k[3, 0] = np.arange(d, dtype=np.float32) * 0.5  # exact .5 ties in x / scale
    k[3, 0, -1] = 63.5
    v[4, 1, 0] = 1000.0  # one outlier sets the head's scale
    return k, v


@pytest.mark.parametrize("seed,d", [(0, 16), (1, 128), (2, 64)])
def test_quantize_kv_matches_jax(seed, d):
    k, v = _kv_rows(seed, d=d)
    want = jkv.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = tkv.quantize_kv(_t(k), _t(v))
    for g, w, is_scale in zip(got, want, (False, True, False, True)):
        if is_scale:
            assert g.dtype == torch.bfloat16 and g.shape == (k.shape[0], k.shape[1])
            np.testing.assert_array_equal(_bf16_bits(g), _bf16_bits(w))
        else:
            assert g.dtype == torch.int8 and g.shape == (k.shape[0], k.shape[1] * d)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].abs().max()) <= 127


@pytest.mark.parametrize("slots", [[5, 0 + 17, 33, 2, 40, 9, 21, 63, 12],
                                   [5, 2**30, 33, 2**30, 40, 64, 21, 63, -1]],
                         ids=["all_valid", "out_of_range"])
def test_write_kv_quant_matches_jax(slots):
    """Out-of-range slots (the 2**30 sentinel, one past the end) are dropped
    on both sides, for data and for scales; -1 is out of range for the port
    and is left out of the JAX side (numpy-style it would wrap there)."""
    rng = np.random.default_rng(3)
    ns, hkv, d = 64, 2, 16
    k, v = _kv_rows(4)
    pools = [rng.integers(-127, 128, (ns, hkv * d)).astype(np.int8) for _ in range(2)]
    scales = [rng.random((ns, hkv)).astype(np.float32).astype(ml_dtypes.bfloat16)
              for _ in range(2)]
    slots = np.asarray(slots, np.int64)
    jslots = np.where(slots < 0, 2**30, slots).astype(np.int32)
    want = jkv.write_kv_quant(*(jnp.asarray(p) for p in pools),
                              *(jnp.asarray(s) for s in scales),
                              jnp.asarray(k), jnp.asarray(v), jnp.asarray(jslots))
    tp = [_t(p).clone() for p in pools]
    ts = [torch.from_numpy(s.view(np.uint16).copy()).view(torch.bfloat16) for s in scales]
    tkv.write_kv_quant(tp[0], tp[1], ts[0], ts[1], _t(k), _t(v), _t(slots))
    for g, w in zip(tp, want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(ts, want[2:]):
        np.testing.assert_array_equal(_bf16_bits(g), _bf16_bits(w))


def test_write_kv_quant_all_invalid_leaves_pool_untouched():
    rng = np.random.default_rng(5)
    k, v = (a[:4] for a in _kv_rows(6))
    pool = _t(rng.integers(-127, 128, (2, 32, 32)).astype(np.int8))
    scale = torch.rand(2, 32, 2).to(torch.bfloat16)
    before = pool.clone(), scale.clone()
    tkv.write_kv_quant(pool[0], pool[1], scale[0], scale[1], _t(k), _t(v),
                       torch.full((4,), tkv.INVALID_SLOT))
    assert torch.equal(pool, before[0]) and torch.equal(scale, before[1])


# ---- plain attention with scales ----


def _quant_pool(rng, nb, hkv, d):
    """A float pool quantized per (slot, head) as the engine does; returns
    (int8 k, int8 v, bf16 k scales, bf16 v scales) as numpy."""
    out = []
    for _ in range(2):
        f = rng.standard_normal((nb * BS, hkv, d)).astype(np.float32)
        s = np.maximum(np.abs(f).max(-1) / 127.0, 1e-8)
        q = np.clip(np.round(f / s[..., None]), -127, 127).astype(np.int8)
        out.append((q.reshape(nb * BS, hkv * d), s.astype(ml_dtypes.bfloat16)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _scale_t(s):
    return torch.from_numpy(s.view(np.uint16).copy()).view(torch.bfloat16)


def _tables(rng, kv_lens, nb, mb):
    bt = np.zeros((len(kv_lens), mb), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    i = 0
    for r, n in enumerate(kv_lens):
        nblk = -(-int(n) // BS)
        bt[r, :nblk] = perm[i: i + nblk]
        i += nblk
    return bt


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("cur", [False, True], ids=["in_pool", "cur_token"])
def test_decode_ref_with_scales_matches_jax(cur, window):
    """int8 pool + scales, T = 1, one zero-length row; with ``cur`` the
    current token arrives unquantized beside a pool of kv_len - 1 tokens."""
    rng = np.random.default_rng(11)
    b, hq, hkv, d, nb, mb = 4, 8, 2, 32, 32, 8
    lens = np.asarray([1, 17, 100, 0], np.int32)
    kq, vq, ks, vs = _quant_pool(rng, nb, hkv, d)
    bt = _tables(rng, lens, nb, mb)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    ck = rng.standard_normal((b, hkv * d)).astype(np.float32)
    cv = rng.standard_normal((b, hkv * d)).astype(np.float32)
    jkw = dict(cur_k=jnp.asarray(ck), cur_v=jnp.asarray(cv)) if cur else {}
    tkw = dict(cur_k=_t(ck), cur_v=_t(cv)) if cur else {}
    offs = np.maximum(lens - 1, 0)
    want = j_ref(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
                 jnp.asarray(lens), jnp.asarray(offs), 0.17, block_size=BS,
                 sliding_window=window, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                 **jkw)
    got = tattn.paged_attention(_t(q), _t(kq), _t(vq), _t(bt), _t(lens), _t(offs), 0.17, BS,
                                sliding_window=window, k_scale=_scale_t(ks),
                                v_scale=_scale_t(vs), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert np.all(got.numpy()[3] == 0)
    # the decode wrapper's CPU route is the same plain version
    got2 = tdecode.paged_decode_attention(
        _t(q[:, 0]), _t(kq), _t(vq), _t(bt), _t(lens), 0.17, BS, sliding_window=window,
        k_scale=_scale_t(ks), v_scale=_scale_t(vs), **tkw)
    np.testing.assert_array_equal(got2.numpy(), got.numpy()[:, 0])


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_ref_with_scales_matches_jax(window):
    """T > 1 with a reused prefix (q_offset > 0): the prefix is read back
    quantized. Padded tail rows of the wrapper are zero."""
    rng = np.random.default_rng(12)
    b, t, hq, hkv, d, nb, mb = 2, 24, 4, 2, 16, 40, 6
    kq, vq, ks, vs = _quant_pool(rng, nb, hkv, d)
    bt = rng.permutation(np.arange(1, nb))[: b * mb].reshape(b, mb).astype(np.int32)
    offs, lens = np.array([0, 30], np.int32), np.array([20, 54], np.int32)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    want = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
                            jnp.asarray(lens), jnp.asarray(offs), 0.25, block_size=BS,
                            sliding_window=window, k_scale=jnp.asarray(ks),
                            v_scale=jnp.asarray(vs)))
    got = tprefill.paged_prefill_attention(
        _t(q), _t(kq), _t(vq), _t(bt), _t(offs), _t(lens), 0.25, BS,
        sliding_window=window, k_scale=_scale_t(ks), v_scale=_scale_t(vs)).numpy()
    np.testing.assert_allclose(got[1], want[1], **F32_TOL)
    np.testing.assert_allclose(got[0, :20], want[0, :20], **F32_TOL)
    assert np.all(got[0, 20:] == 0)


@pytest.mark.parametrize("cur", [False, True], ids=["in_pool", "cur_token"])
def test_pallas_quant_kernel_matches_port_decode(monkeypatch, cur):
    """The JAX Pallas quant kernel, in interpret mode as
    tests/test_pallas_decode.py runs it, against the port's decode wrapper on
    the CPU. 2e-2: that kernel's dots run in bf16."""
    import rtp_llm_tpu.ops.attention.pallas_decode as pd

    monkeypatch.setattr(pd, "fullrow_max_tokens", lambda: 2048)
    rng = np.random.default_rng(7)
    b, hq, hkv, d, nb, mb = 4, 8, 2, 128, 32, 6
    lens = np.asarray([3, 17, 64, 96], np.int32)
    kq, vq, ks, vs = _quant_pool(rng, nb, hkv, d)
    bt = _tables(rng, lens, nb, mb)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    ck = rng.standard_normal((b, hkv * d)).astype(np.float32)
    cv = rng.standard_normal((b, hkv * d)).astype(np.float32)
    sm = 1.0 / np.sqrt(d)
    ks_e, vs_e = _expand_kv_scales(jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(bt),
                                   BS, hq, hkv)
    jkw = dict(cur_k=jnp.asarray(ck), cur_v=jnp.asarray(cv)) if cur else {}
    want = pd.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt), jnp.asarray(lens),
        sm, block_size=BS, interpret=True, k_scale_e=ks_e, v_scale_e=vs_e, **jkw)
    tkw = dict(cur_k=_t(ck), cur_v=_t(cv)) if cur else {}
    got = tdecode.paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(bt), _t(lens), sm, BS,
        k_scale=_scale_t(ks), v_scale=_scale_t(vs), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def test_cpu_dispatch_with_scales_launches_no_kernel():
    for k in (*tdecode.KERNELS.values(), *tprefill.KERNELS.values()):
        k.launches.n = 0
    before = tattn.PLAIN_CALLS.n
    rng = np.random.default_rng(2)
    kq, vq, ks, vs = _quant_pool(rng, 8, 2, 16)
    bt = _tables(rng, [20], 8, 4)
    q = rng.standard_normal((1, 1, 4, 16)).astype(np.float32)
    tattn.paged_attention(_t(q), _t(kq), _t(vq), _t(bt), torch.tensor([20]),
                          torch.tensor([19]), 0.2, BS, k_scale=_scale_t(ks),
                          v_scale=_scale_t(vs))
    assert tattn.PLAIN_CALLS.n == before + 1
    assert all(k.launches.n == 0 for k in (*tdecode.KERNELS.values(),
                                           *tprefill.KERNELS.values()))
    assert sorted(k.name for k in tdecode.KERNELS.values()) == [
        "paged_decode", "paged_decode_e4m3", "paged_decode_i8"]
    assert sorted(k.name for k in tprefill.KERNELS.values()) == [
        "paged_prefill", "paged_prefill_e4m3", "paged_prefill_i8"]


# ---- what the CUDA wrappers refuse (the checks are plain Python) ----


def _pools(dtype, ns=64, hd=256, row=None):
    row = row or hd
    base = torch.zeros((ns, row), dtype=dtype)
    return base[:, :hd], base.clone()[:, :hd]


def test_check_pools_accepts_the_three_pool_types():
    for dtype in (torch.bfloat16, FP8):
        tdecode.check_pools(*_pools(dtype), None, None, 256, 2)
    sc = torch.zeros((64, 2), dtype=torch.bfloat16)
    tdecode.check_pools(*_pools(torch.int8), sc, sc.clone(), 256, 2)
    # a [NS, Hkv] view of a wider scale tensor: any row stride, both alike
    wide = torch.zeros((2, 64, 2), dtype=torch.bfloat16)
    tdecode.check_pools(*_pools(torch.int8), wide[0], wide[1], 256, 2)


@pytest.mark.parametrize("case", ["f32_pool", "mixed_pools", "int8_without_scales",
                                  "scales_on_bf16", "f32_scales", "scale_shape",
                                  "row_not_16_bytes", "k_scale_alone"])
def test_check_pools_raises(case):
    sc = lambda hkv=2, dt=torch.bfloat16: torch.zeros((64, hkv), dtype=dt)
    k8, v8 = _pools(torch.int8)
    kb, vb = _pools(torch.bfloat16)
    args = {
        "f32_pool": (*_pools(torch.float32), None, None),
        "mixed_pools": (k8, vb, sc(), sc()),
        "int8_without_scales": (k8, v8, None, None),
        "scales_on_bf16": (kb, vb, sc(), sc()),
        "f32_scales": (k8, v8, sc(dt=torch.float32), sc(dt=torch.float32)),
        "scale_shape": (k8, v8, sc(4), sc(4)),
        # int8 rows of 264 bytes: a multiple of 8 elements, not of 16 bytes
        "row_not_16_bytes": (*_pools(torch.int8, row=264), sc(), sc()),
        "k_scale_alone": (k8, v8, sc(), None),
    }[case]
    with pytest.raises((NotImplementedError, ValueError)):
        tdecode.check_pools(*args, 256, 2)


# ---- fp8 pool ----


def test_fp8_downcast_bits_match_jax():
    """Inside +-448 the two frameworks round to the same e4m3 bits."""
    rng = np.random.default_rng(21)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * s
                        for s in (1e-3, 0.1, 1.0, 20.0, 150.0)])
    x = np.clip(x, -448.0, 448.0)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    got = _t(x).to(FP8)
    np.testing.assert_array_equal(_fp8_bits(got), _fp8_bits(want))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_fp8_overflow_is_a_known_divergence():
    """Past +-448 torch saturates where JAX gives NaN: K/V of a sane model
    stay far below, and the tests keep their inputs inside."""
    x = np.asarray([1000.0, -1000.0], np.float32)
    assert _t(x).to(FP8).float().tolist() == [448.0, -448.0]
    assert np.isnan(np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).astype(np.float32)).all()


def test_fp8_pool_write_and_attention_match_jax():
    rng = np.random.default_rng(22)
    ns, hkv, d, b = 8 * BS, 2, 16, 3
    lens = np.asarray([5, 40, 0], np.int32)
    bt = _tables(rng, lens, 8, 4)
    pool = (rng.standard_normal((2, ns, hkv * d)).astype(np.float32) * 2).astype(
        ml_dtypes.float8_e4m3fn)
    k_new = rng.standard_normal((4, hkv, d)).astype(np.float32) * 3
    v_new = rng.standard_normal((4, hkv, d)).astype(np.float32)
    slots = np.asarray([bt[0, 0] * BS + 3, 2**30, bt[1, 1] * BS, bt[1, 2] * BS + 1])
    jk, jv = jkv.write_kv(jnp.asarray(pool[0]), jnp.asarray(pool[1]), jnp.asarray(k_new),
                          jnp.asarray(v_new), jnp.asarray(slots, jnp.int32))
    tpool = cache_from_jax(pool, device="cpu")
    assert tpool.dtype == FP8
    tkv.write_kv(tpool[0], tpool[1], _t(k_new), _t(v_new), _t(slots))
    np.testing.assert_array_equal(_fp8_bits(tpool[0]), _fp8_bits(jk))
    np.testing.assert_array_equal(_fp8_bits(tpool[1]), _fp8_bits(jv))
    q = rng.standard_normal((b, 1, 4, d)).astype(np.float32)
    offs = np.maximum(lens - 1, 0)
    want = j_ref(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
                 jnp.asarray(offs), 0.3, block_size=BS)
    got = tattn.paged_attention(_t(q), tpool[0], tpool[1], _t(bt), _t(lens), _t(offs), 0.3, BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ---- cache_from_jax, init_cache, dtype names ----


def _port_config(jcfg) -> TConfig:
    names = {f.name for f in dataclasses.fields(TConfig)}
    return TConfig(**{n: getattr(jcfg, n) for n in names})


@pytest.mark.parametrize("name,tdt,jdt", [("int8", torch.int8, jnp.int8),
                                          ("fp8", FP8, jnp.float8_e4m3fn),
                                          ("float8_e4m3", FP8, jnp.float8_e4m3fn),
                                          ("bfloat16", torch.bfloat16, jnp.bfloat16)])
def test_init_cache_layout_matches_jax(name, tdt, jdt):
    jcfg = tiny_config("llama")
    assert torch_dtype(name) == tdt
    jc = create_model(jcfg).init_cache(6, 4, jdt)
    tc = LlamaFamilyModel(_port_config(jcfg), device="cpu").init_cache(6, 4, tdt)
    if name == "int8":
        assert set(tc) == set(jc) == {"data", "scale"}
        assert tc["data"].dtype == torch.int8 and tc["scale"].dtype == torch.bfloat16
        assert tuple(tc["data"].shape) == jc["data"].shape
        assert tuple(tc["scale"].shape) == jc["scale"].shape
        assert not tc["scale"].any()
    else:
        assert tc.dtype == tdt and tuple(tc.shape) == jc.shape


def test_unknown_kv_dtype_raises():
    with pytest.raises(NotImplementedError):
        torch_dtype("int4")


@pytest.mark.parametrize("kind", ["bf16", "fp8", "int8"])
def test_cache_from_jax_is_bit_exact(kind):
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 2, 8, 32)).astype(np.float32)
    if kind == "int8":
        jc = {"data": jnp.asarray((x * 40).astype(np.int8)),
              "scale": jnp.asarray(np.abs(x[..., :2]), jnp.bfloat16)}
        tc = cache_from_jax({k: np.asarray(v) for k, v in jc.items()}, device="cpu")
        np.testing.assert_array_equal(tc["data"].numpy(), np.asarray(jc["data"]))
        np.testing.assert_array_equal(_bf16_bits(tc["scale"]), _bf16_bits(jc["scale"]))
        return
    jdt = jnp.bfloat16 if kind == "bf16" else jnp.float8_e4m3fn
    jc = jnp.asarray(x).astype(jdt)
    tc = cache_from_jax(np.asarray(jc), device="cpu")
    np.testing.assert_array_equal(tc.float().numpy(), np.asarray(jc).astype(np.float32))


# ---- the model forward on quantized pools ----

NB, MBS = 24, 4


def _steps():
    """(tokens, positions, block_tables, kv_lens, q_offsets): a two-row
    prefill, a second chunk at q_offset > 0 (reads the first back from the
    pool) and two decode steps, the second with an inactive row."""
    rng = np.random.default_rng(0)
    bt = np.zeros((2, 6), np.int32)
    bt[0, :5] = [3, 7, 1, 9, 12]
    bt[1, :5] = [2, 5, 11, 4, 6]
    t = 12
    toks = rng.integers(1, 128, size=(2, t))
    pos = np.tile(np.arange(t), (2, 1))
    lens = np.array([10, 7])
    toks[1, 7:] = 0
    pos[1, 7:] = 0
    toks[0, 10:] = 0
    pos[0, 10:] = 0
    yield toks, pos, bt, lens, np.array([0, 0])
    t2 = 8
    toks2 = rng.integers(1, 128, size=(2, t2))
    offs = np.array([10, 7])
    lens2 = np.array([15, 10])
    pos2 = offs[:, None] + np.arange(t2)[None, :]
    for r in range(2):
        n = lens2[r] - offs[r]
        toks2[r, n:] = 0
        pos2[r, n:] = 0
    yield toks2, pos2, bt, lens2, offs
    yield rng.integers(1, 128, size=(2, 1)), lens2[:, None], bt, lens2 + 1, lens2
    lens3 = np.array([16, 0])
    yield (rng.integers(1, 128, size=(2, 1)), np.array([[16], [0]]), bt,
           np.array([17, 0]), lens3)


def _inputs(step):
    toks, pos, bt, lens, offs = step
    jin = JInputs(tokens=jnp.asarray(toks, jnp.int32), positions=jnp.asarray(pos, jnp.int32),
                  block_tables=jnp.asarray(bt), kv_lens=jnp.asarray(lens, jnp.int32),
                  q_offsets=jnp.asarray(offs, jnp.int32))
    tin = ModelInputs(*(torch.from_numpy(np.asarray(a)) for a in (toks, pos, bt, lens, offs)))
    return jin, tin


@pytest.fixture(scope="module", params=["qwen2", "llama"])
def family(request, tmp_path_factory):
    jcfg = tiny_config(request.param)
    jcfg.dtype = "float32"
    ckpt = write_fake_checkpoint(str(tmp_path_factory.mktemp(request.param)), jcfg)
    jw = JLoader(jcfg).load(ckpt)
    jmodel = create_model(jcfg)
    tmodel = LlamaFamilyModel(_port_config(jcfg), device="cpu")
    tw = tmodel.fuse_weights(
        weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu"))
    return jmodel, jw, tmodel, tw


def _np_cache(jcache):
    if isinstance(jcache, dict):
        return {k: np.asarray(v) for k, v in jcache.items()}
    return np.asarray(jcache)


def _assert_pools_close(tcache, jcache, kind):
    """The port's pool against the JAX pool carried over by
    ``cache_from_jax``. The inputs of the quantizer agree to ~1e-6 only, so a
    value on a rounding boundary may land one step apart: int8 codes within
    1 (and at most 0.5% of them off), e4m3 values within one step (12.5%)."""
    want = cache_from_jax(_np_cache(jcache), device="cpu")
    if kind == "int8":
        diff = (tcache["data"].int() - want["data"].int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 5e-3
        np.testing.assert_allclose(tcache["scale"].float().numpy(),
                                   want["scale"].float().numpy(), rtol=1e-2, atol=1e-9)
    else:
        np.testing.assert_allclose(tcache.float().numpy(), want.float().numpy(),
                                   rtol=0.13, atol=2e-3)
        assert float((tcache.view(torch.uint8) != want.view(torch.uint8)).float().mean()) < 5e-3


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_forward_on_quantized_cache_matches_jax(family, kind):
    """In-layer writes: each step both sides start from the same pool (the
    JAX pool carried over), so the logits compare at the f32 tolerance; the
    pools after the step agree as ``_assert_pools_close`` says."""
    jmodel, jw, tmodel, tw = family
    jdt, tdt = (jnp.int8, torch.int8) if kind == "int8" else (jnp.float8_e4m3fn, FP8)
    jcache = jmodel.init_cache(NB, MBS, jdt)
    tmodel.init_cache(NB, MBS, tdt)
    for step in _steps():
        jin, tin = _inputs(step)
        tcache = cache_from_jax(_np_cache(jcache), device="cpu")
        jout, jcache = jmodel.forward(jw, jcache, jin)
        tout, tcache = tmodel.forward(tw, tcache, tin)
        assert tout.kv_writes is None
        np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits), **MODEL_TOL)
        _assert_pools_close(tcache, jcache, kind)


@pytest.mark.parametrize("kind", ["float32", "int8", "fp8"])
def test_deferred_forward_matches_jax_and_in_layer(family, kind):
    """A decode step with deferred writes: logits and the returned rows
    against the JAX deferred forward; the pool is left untouched. With an f32
    pool the logits equal the in-layer forward's; with a quantized pool they
    differ by the current token's quantization only."""
    jmodel, jw, tmodel, tw = family
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8),
                "fp8": (jnp.float8_e4m3fn, FP8)}[kind]
    jcache = jmodel.init_cache(NB, MBS, jdt)
    tmodel.init_cache(NB, MBS, tdt)
    steps = list(_steps())
    for step in steps[:2]:  # prefill chunks, written in-layer
        jout, jcache = jmodel.forward(jw, jcache, _inputs(step)[0])
    for step in steps[2:]:
        jin, tin = _inputs(step)
        pool = _np_cache(jcache)
        tcache = cache_from_jax(pool, device="cpu")
        jout, _ = jmodel.forward(jw, jcache, jin, defer_kv_writes=True)
        tout, tcache = tmodel.forward(tw, tcache, tin, defer_kv_writes=True)
        np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits), **MODEL_TOL)
        for got, want in zip(tout.kv_writes, jout.kv_writes):
            assert tuple(got.shape) == want.shape  # [L, B, Hkv*D]
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        same = cache_from_jax(pool, device="cpu")  # untouched by the deferred forward
        for a, b in zip(*(([c["data"], c["scale"]] if isinstance(c, dict) else [c])
                          for c in (tcache, same))):
            assert torch.equal(tkv.storage_view(a), tkv.storage_view(b))
        inl, _ = tmodel.forward(tw, cache_from_jax(pool, device="cpu"), tin)
        tol = MODEL_TOL if kind == "float32" else dict(rtol=0.1, atol=0.1)
        np.testing.assert_allclose(tout.logits.numpy(), inl.logits.numpy(), **tol)
        _, jcache = jmodel.forward(jw, jcache, jin)  # advance the pool in-layer


def test_deferred_forward_refuses_prefill(family):
    _, _, tmodel, tw = family
    cache = tmodel.init_cache(NB, MBS, torch.float32)
    with pytest.raises(ValueError):
        tmodel.forward(tw, cache, _inputs(next(_steps()))[1], defer_kv_writes=True)
