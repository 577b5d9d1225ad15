"""The 8-bit weight routes of the port against the JAX package, on the CPU:
the load-time quantizers (int8, fp8 at every block layout), the transform's
routes, the plain versions of the three 8-bit kernels (``w8_gemm``,
``act_quant``, ``i8_gemm``) against the JAX functions, and blocked
emulations of each kernel's tile, byte-dealing and group arithmetic against
the plain versions. The CUDA kernels themselves are held against the plain
versions on the card by ``chip_smoke.py``.

The same seeded numpy arrays go through both packages. Codes and scales
must be equal; products within 1e-4 of the largest |value|; activation
codes equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.config.engine_config import QuantConfig as JQuant
from rtp_llm_tpu.loader.weight_maps import WeightSpec as JSpec
from rtp_llm_tpu.quant import make_quant_transform as j_transform
from rtp_llm_tpu.quant import weight_only as jwo
from rtp_llm_tpu_torch import cli
from rtp_llm_tpu_torch.config import QuantConfig
from rtp_llm_tpu_torch.convert import weights_from_jax
from rtp_llm_tpu_torch.loader.weight_maps import WeightSpec
from rtp_llm_tpu_torch.ops import quant_gemm8 as q8
from rtp_llm_tpu_torch.quant import make_quant_transform
from rtp_llm_tpu_torch.quant import weight_only as wo


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    """A port tensor as numpy (fp8 as ml_dtypes e4m3, the JAX package's type)."""
    if t.dtype == torch.float8_e4m3fn:
        import ml_dtypes

        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def _assert_bits(got: torch.Tensor, want):
    want = np.asarray(want)
    g = _np(got)
    assert g.shape == want.shape and g.dtype == want.dtype, (g.shape, want.shape, g.dtype)
    if g.dtype.itemsize == 1 and g.dtype.kind not in "iu":
        g, want = g.view(np.uint8), want.view(np.uint8)
    np.testing.assert_array_equal(g, want)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _weights(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    if len(shape) > 1 and shape[-2] > 3:
        w[..., 3, :] *= 40.0  # an outlier row: amax far from the typical value
    if dtype == "bfloat16":
        import ml_dtypes

        return w.astype(ml_dtypes.bfloat16)
    return w


def _port_in(w):
    return weights_from_jax({"w": w}, device="cpu")["w"]


# ---- the quantizers ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float16, "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48), (2, 128, 96)])
def test_int8_quantize_bit_equal(shape, dtype):
    w = _weights(shape, 1, dtype)
    jq_, js = jwo.int8_quantize(w)
    q, s = wo.int8_quantize(_port_in(w))
    _assert_bits(q, jq_)
    _assert_bits(s, js)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("block", [0, -1, 16, 32])
def test_fp8_quantize_bit_equal(block, dtype):
    """One matrix, each layout: codes (e4m3 bits) and scales equal."""
    w = _weights((96, 64), 2, dtype)
    jq_, js = jwo.fp8_quantize(np.asarray(w, np.float32), block)
    q, s = wo.fp8_quantize(_port_in(w), block)
    _assert_bits(q, jq_)
    _assert_bits(s, np.asarray(js, np.float32))


def test_fp8_quantize_subnormals_and_zero():
    """Codes near e4m3's smallest values round to nearest even as JAX's
    convert does; an all-zero tensor takes the 1e-8 floor."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((32, 16)) * 1e-3).astype(np.float32)
    w[0, 0] = 1.0  # the amax: the rest of the tensor falls to subnormal codes
    for block in (0, -1, 16):
        jq_, js = jwo.fp8_quantize(w, block)
        q, s = wo.fp8_quantize(_t(w), block)
        _assert_bits(q, jq_)
        _assert_bits(s, np.asarray(js, np.float32))
    zeros = np.zeros((16, 16), np.float32)
    jq_, js = jwo.fp8_quantize(zeros, 0)
    q, s = wo.fp8_quantize(_t(zeros), 0)
    _assert_bits(q, jq_)
    _assert_bits(s, np.asarray(js, np.float32))


@pytest.mark.parametrize("block", [-1, 16])
def test_fp8_quantize_stack_is_per_layer(block):
    """A stacked ``[L, in, out]`` linear quantizes like its layers one by one
    (the JAX package's result at these layouts)."""
    w = _weights((3, 64, 32), 4)
    jq_, js = jwo.fp8_quantize(w, block)
    q, s = wo.fp8_quantize(_t(w), block)
    _assert_bits(q, jq_)
    _assert_bits(s, js)


def test_fp8_per_tensor_scale_is_one_a_layer():
    """Block 0 on a stack: one scale a layer, each the JAX package's scale of
    that layer alone. (The JAX package takes one scale over the whole
    stack, which its forward cannot index: see the model tests.)"""
    w = _weights((3, 64, 32), 5)
    w[1] *= 10.0
    q, s = wo.fp8_quantize(_t(w), 0)
    assert s.shape == (3,)
    for i in range(3):
        jq_, js = jwo.fp8_quantize(w[i], 0)
        _assert_bits(q[i], jq_)
        _assert_bits(s[i], np.asarray(js, np.float32))
    _, j_stack = jwo.fp8_quantize(w, 0)
    assert np.asarray(j_stack).shape == ()


# ---- the transform's routes ----------------------------------------------------


SPECS = [("o_proj", "in", (2, 96, 64)), ("gate_proj", "out", (2, 64, 96)),
         ("down_proj", "in", (2, 192, 64)), ("lm_head", "out", (64, 160)),
         ("embed_tokens", None, (160, 64)), ("q_bias", "out", (2, 64))]


def _route(method, name, axis, shape, **kw):
    w = _weights(shape, sum(map(ord, name)))
    jspec = JSpec(name, "x", per_layer=len(shape) == 3, transpose=True, shard_axis=axis)
    spec = WeightSpec(name, "x", per_layer=len(shape) == 3, transpose=True, shard_axis=axis)
    jout = j_transform(JQuant(method=method, group_size=32, **kw))(jspec, w)
    out = make_quant_transform(QuantConfig(method=method, group_size=32, **kw))(spec, _t(w))
    return out, jout


@pytest.mark.parametrize("method,kw", [
    ("int8", {}), ("w8a8", {}), ("w4a8", {}), ("int4", {}), ("fp4", {}),
    ("fp8", {"fp8_block_size": 32}), ("fp8", {"fp8_block_size": -1}),
    ("int8", {"quantize_lm_head": True}), ("w4a8", {"quantize_lm_head": True}),
])
@pytest.mark.parametrize("name,axis,shape", SPECS)
def test_transform_routes_equal_jax(method, kw, name, axis, shape):
    """Keys, dtypes and values of every route equal the JAX transform's,
    among them the int8 LM head, W4A8's unpacked values, and int8 for the
    in dims that do not pack (96 % 64 at group 32 for int4 / w4a8, and for
    fp4's group of 32)."""
    out, jout = _route(method, name, axis, shape, **kw)
    assert set(out) == set(jout)
    ref = weights_from_jax({k: np.asarray(v) for k, v in jout.items()}, device="cpu")
    for k, v in out.items():
        if not isinstance(v, torch.Tensor):
            assert v is True and ref[k] is True, k
            continue
        assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
        if v.dtype == torch.float8_e4m3fn:
            v, ref[k] = v.view(torch.uint8), ref[k].view(torch.uint8)
        assert torch.equal(v, ref[k]), k


def test_fp8_irregular_in_dim_falls_back_to_per_tensor():
    """An in dim that is not a multiple of the block takes per-tensor scales
    (one a layer here; see test_fp8_per_tensor_scale_is_one_a_layer)."""
    w = _weights((2, 96, 64), 6)
    spec = WeightSpec("o_proj", "x", per_layer=True, transpose=True, shard_axis="in")
    out = make_quant_transform(QuantConfig(method="fp8", fp8_block_size=64))(spec, _t(w))
    assert out[""].dtype == torch.float8_e4m3fn and out[".scale"].shape == (2,)
    for i in range(2):
        jq_, js = jwo.fp8_quantize(w[i], 0)
        _assert_bits(out[""][i], jq_)
        _assert_bits(out[".scale"][i], np.asarray(js, np.float32))


def test_quant_config_and_cli_flags():
    assert QuantConfig().fp8_block_size == JQuant().fp8_block_size == 128
    assert QuantConfig().quantize_lm_head is JQuant().quantize_lm_head is False
    args = cli.parse_args(["serve", "/m", "--quant", "fp8", "--fp8-block-size", "-1",
                           "--quantize-lm-head"])
    conf = cli.config_from_args(args)
    assert conf.quant.method.value == "fp8" and conf.quant.fp8_block_size == -1
    assert conf.quant.quantize_lm_head is True
    for method in ("none", "int8", "int4", "fp8", "fp4", "w8a8", "w4a8"):
        conf = cli.config_from_args(cli.parse_args(["serve", "/m", "--quant", method]))
        assert conf.quant.method.value == method
        assert conf.quant.fp8_block_size == 128 and conf.quant.quantize_lm_head is False
    with pytest.raises(SystemExit):
        cli.parse_args(["serve", "/m", "--quant", "int3"])


def test_convert_carries_8bit_weights_and_0d_scales():
    """``weights_from_jax`` carries i8 codes, e4m3 codes, 0-d and stacked
    per-tensor scales and the new markers bit for bit."""
    import ml_dtypes

    from rtp_llm_tpu.quant.marker import MARKER as JMARKER

    w = _weights((64, 32), 7)
    q8_, s8_ = jwo.int8_quantize(w)
    qf, sf = jwo.fp8_quantize(w, 0)
    jw = {"a": q8_, "a.scale": s8_, "a.w8a8": JMARKER, "b": qf, "b.scale": sf,
          "c.scale": np.stack([sf, sf * 2]), "d.w4a8": JMARKER}
    tw = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    assert tw["a"].dtype == torch.int8 and torch.equal(tw["a"], _t(q8_))
    assert tw["b"].dtype == torch.float8_e4m3fn
    assert np.array_equal(tw["b"].view(torch.uint8).numpy(), np.asarray(qf).view(np.uint8))
    assert tw["b.scale"].shape == () and float(tw["b.scale"]) == float(sf)
    assert tw["c.scale"].shape == (2,)
    assert tw["a.w8a8"] is True and tw["d.w4a8"] is True
    assert np.asarray(qf).dtype == ml_dtypes.float8_e4m3fn


# ---- the plain versions against the JAX functions ------------------------------


@pytest.mark.parametrize("code", ["int8", "fp8"])
@pytest.mark.parametrize("layout", ["tensor", "channel", "group"])
def test_w8_plain_matches_quantized_matmul(code, layout):
    rng = np.random.default_rng(8)
    w = _weights((128, 96), 8)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    if code == "int8":
        q, s = jwo.int8_quantize(w)
        if layout == "tensor":
            s = np.float32(s.max())
        elif layout == "group":
            s = (rng.random((4, 96)) * 0.01 + 0.001).astype(np.float32)
    else:
        q, s = jwo.fp8_quantize(w, {"tensor": 0, "channel": -1, "group": 32}[layout])
    want = jwo.quantized_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s))
    tw = weights_from_jax({"q": np.asarray(q), "s": np.asarray(s)}, device="cpu")
    assert q8.scale_mode(tw["s"]) == layout
    _close(q8.w8_matmul(_t(x), tw["q"], tw["s"]).numpy(), want)
    _close(q8.w8_matmul_ref(_t(x), tw["q"], tw["s"]).numpy(), want)


def test_w8_plain_groupwise_with_zero_matches_jax():
    """GPTQ values that do not pack: raw 0..15 codes, group scales and zero
    points; the zero's share comes off afterwards (``zero_scale``)."""
    rng = np.random.default_rng(9)
    q = rng.integers(0, 16, (96, 64)).astype(np.int8)
    s = (rng.random((3, 64)) * 0.01 + 0.001).astype(np.float32)
    z = rng.integers(0, 16, (3, 64)).astype(np.float32)
    x = rng.standard_normal((2, 3, 96)).astype(np.float32)
    want = jwo.quantized_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(z))
    got = q8.w8_matmul(_t(x), _t(q), _t(s), zero_scale=_t(z) * _t(s))
    _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_activation_codes_equal_jax(dtype):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 7, 96)).astype(np.float32) * 3
    x[0, 0] = 0.0  # a zero row: the 1e-8 floor
    x[1, 2, 5] = 50.0
    if dtype == "bfloat16":
        import ml_dtypes

        x = x.astype(ml_dtypes.bfloat16)
    jq_, js = jwo.quantize_activations_per_token(jnp.asarray(x))
    q, s = q8.act_quant(_port_in(x))
    _assert_bits(q, jq_)
    _assert_bits(s, js)


def test_w8a8_plain_matches_jax():
    rng = np.random.default_rng(11)
    q, s = jwo.int8_quantize(_weights((128, 64), 11))
    x = rng.standard_normal((3, 4, 128)).astype(np.float32)
    want = jwo.w8a8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s))
    _close(q8.w8a8_matmul(_t(x), _t(q), _t(s)).numpy(), want)
    # T = 1 in JAX is the port's decode: the weight-only product
    want1 = jwo.w8a8_matmul(jnp.asarray(x[:, :1]), jnp.asarray(q), jnp.asarray(s))
    got1 = q8.w8a8_matmul(_t(x[:, :1]), _t(q), _t(s), decode=True)
    _close(got1.numpy(), want1)
    _close(got1.numpy(), jwo.quantized_matmul(jnp.asarray(x[:, :1]), jnp.asarray(q),
                                              jnp.asarray(s)))
    assert not np.allclose(want1, q8.w8a8_matmul(_t(x[:, :1]), _t(q), _t(s)).numpy(),
                           rtol=1e-6, atol=0)  # the two routes differ: the key matters


def test_w4a8_plain_matches_jax():
    rng = np.random.default_rng(12)
    q, s = jwo.int4_quantize_groupwise(_weights((128, 64), 12), 32)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    want = jwo.w4a8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s))
    _close(q8.w4a8_matmul(_t(x), _t(q), _t(s)).numpy(), want)


def test_integer_contraction_is_exact_at_full_range():
    """|sum| up to 127 * 127 * K: the f64 contraction of the plain version
    gives the integers exactly (f32 would not above 2**24)."""
    k = 2048
    xq = torch.full((2, k), 127, dtype=torch.int8)
    w = torch.full((k, 16), -127, dtype=torch.int8)
    w[0, 0] = 126
    one = torch.ones(16)
    y = q8.i8_matmul_ref(xq, torch.ones((2, 1)), w, one, torch.float64)
    want = -127 * 127 * k + 127 * (126 + 127)
    assert float(y[0, 0]) == float(np.float32(want)) and want < -2**24


def test_plain_calls_are_counted():
    before = q8.PLAIN_CALLS.n
    x = torch.randn(2, 64)
    q, s = wo.int8_quantize(torch.randn(64, 32))
    q8.w8_matmul(x, q, s)
    q8.w8a8_matmul(x, q, s)  # act_quant + i8 on the CPU: two plain calls
    assert q8.PLAIN_CALLS.n == before + 3


# ---- the launch plan and what the kernels refuse -------------------------------

# every linear of Qwen2-7B, Qwen2-1.5B and Llama-3-8B, and the LM heads, as (K, N)
LINEARS = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584), (3584, 152064),
           (1536, 2048), (1536, 1536), (1536, 17920), (8960, 1536), (1536, 151936),
           (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("k,n", LINEARS)
@pytest.mark.parametrize("m", [1, 8, 64, 65, 127, 128, 130, 256, 776, 1000, 2048])
@pytest.mark.parametrize("unit", [32, 64, 128])
@pytest.mark.parametrize("kernel", ["w8", "i8"])
def test_plan_covers_k_in_whole_units(kernel, m, k, n, unit):
    """Every served shape passes the kernels' checks; the plan's splits
    tile K exactly in whole units (a scale group never straddles two
    splits), none empty; K is split only while blocks leave SMs idle.
    Both kernels run their tile kernel from 128 rows, 128-row tiles for
    groups, and the ring kernel below (unit 64: one group or per channel;
    32, 128: groups). Groups that do not fill a tile kernel's k-tile (w8: 64
    rows, i8: 128) take the ring at every row count; the tile kernel's
    k-tiles are 64 rows (w8) or 128 (i8), the rings' 64."""
    if k % unit:
        pytest.skip(f"K={k} has no whole {unit}-row groups")
    assert k % q8.W8_K_TILE == 0 and k % q8.K_TILE == 0 and n % 16 == 0
    grouped = unit != 64
    if kernel == "i8":
        tile_k = q8.I8_TILE_K
        bm, splits, tiles = q8.plan(m, k, n, unit, 132, grouped=grouped)
    else:
        tile_k = q8.W8_K_TILE
        bm, splits, tiles = q8.w8_plan(m, k, n, unit, 132, grouped=grouped)
    tile = m >= 128 and not (grouped and unit % tile_k)
    assert (bm >= 128) == tile
    if not tile:
        assert bm == next(b for b in (16, 32, 64) if m <= b or b == 64)
    elif grouped:
        assert bm == 128
    else:
        assert bm in (128, 256)
    kt = tile_k if tile else (q8.K_TILE if kernel == "i8" else q8.W8_K_TILE)
    assert k % kt == 0 and (tiles * kt) % unit == 0
    ranges = [(s * tiles, min((s + 1) * tiles, k // kt)) for s in range(splits)]
    assert ranges[-1][1] == k // kt and all(a < b for a, b in ranges)
    blocks = -(-m // bm) * -(-n // q8.N_TILE)
    if bm >= 128:
        assert splits <= max(1, min(4, 132 // blocks))
    else:
        assert splits == 1 or (blocks < 132 and blocks * splits <= 2 * 132 + blocks)
    assert splits <= q8.MAX_SPLITS


@pytest.mark.parametrize("k,n", [(3584, 37888), (1536, 17920), (3584, 152064), (4096, 28672),
                                 (4096, 128256)])
@pytest.mark.parametrize("m", [1, 8, 16, 32, 64])
def test_w8_plan_decode_rounds_stay_within_one_split(m, k, n):
    """With more ring blocks than SMs the product stays whole, and no SM
    streams more than the even share of the k-tiles plus one split's worth
    (132 SMs, blocks dealt in turn): Qwen2-7B gate-up at 64 rows streams
    3 x 56 k-tiles on its busiest SMs against an even share of 126."""
    bm, splits, tiles = q8.w8_plan(m, k, n, q8.W8_K_TILE, 132)
    blocks = -(-m // bm) * -(-n // q8.N_TILE)
    assert blocks >= 132
    assert splits == 1 and tiles == k // q8.W8_K_TILE
    work = blocks * tiles
    busiest = -(-blocks // 132) * tiles
    assert busiest <= -(-work // 132) + tiles
    if (m, k, n) == (64, 3584, 37888):
        assert (busiest, -(-work // 132)) == (168, 126)


@pytest.mark.parametrize("case", ["f32_x", "k_not_32", "n_not_16", "group_16", "copy",
                                  "w_dtype", "scale_dtype"])
def test_w8_launch_refuses_what_the_kernel_does_not_take(case):
    """The checks in front of the launch raise on a CPU tensor (``_launch_w8``
    is what a CUDA tensor reaches); nothing falls back to the plain version."""
    k, n = {"k_not_32": (48, 32), "n_not_16": (64, 24)}.get(case, (64, 32))
    x = torch.zeros((4, k), dtype=torch.float32 if case == "f32_x" else torch.bfloat16)
    w = torch.zeros((k, n), dtype=torch.int16 if case == "w_dtype" else torch.int8)
    if case == "copy":
        w = torch.zeros((n, k), dtype=torch.int8).T
    s = torch.ones((n,), dtype=torch.float16 if case == "scale_dtype" else torch.float32)
    if case == "group_16":
        s = torch.ones((k // 16, n))
    before = q8.PLAIN_CALLS.n
    with pytest.raises((NotImplementedError, ValueError, TypeError)):
        q8._launch_w8(x, w, s)
    assert q8.PLAIN_CALLS.n == before


@pytest.mark.parametrize("case", ["x_dtype", "group_16", "k_not_32"])
def test_i8_launch_refuses_what_the_kernel_does_not_take(case):
    k = 48 if case == "k_not_32" else 64
    xq = torch.zeros((4, k), dtype=torch.float32 if case == "x_dtype" else torch.int8)
    w = torch.zeros((k, 32), dtype=torch.int8)
    s = torch.ones((k // 16, 32)) if case == "group_16" else torch.ones((32,))
    with pytest.raises(NotImplementedError):
        q8._launch_i8(xq, torch.ones((4,)), w, s)


# ---- blocked emulations of the kernels' arithmetic -----------------------------


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte n of the result is byte s[n] of {y, x}."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _bf16_halves(bits: int) -> tuple:
    """The two bf16 halves of a 32-bit word, as float values (low first)."""
    f = np.array([(bits & 0xFFFF) << 16, (bits >> 16) << 16], np.uint32).view(np.float32)
    return float(f[0]), float(f[1])


def _w8_pair(a: int, b: int, i: int, j: int, code: int, two_pow: int = 0x7B80) -> tuple:
    """csrc/w8_gemm.cu pair, bit for bit: the bf16x2 of the code in byte i of
    word a (low) and in byte j of word b (high), as two values. s8: prmt
    into the mantissa of 2^23, an f32 subtract, prmt of the high halves.
    e4m3: the fields shifted into a bf16 (value x 2^-120), then one bf16
    multiply by ``two_pow`` (2^120; exact, a power of two)."""
    if code == 0:
        f = np.array([_byte_perm(a ^ 0x80808080, 0x4B000000, 0x7440 | i),
                      _byte_perm(b ^ 0x80808080, 0x4B000000, 0x7440 | j)],
                     np.uint32).view(np.float32) - np.float32(8388736.0)
        u = f.view(np.uint32)
        return _bf16_halves(_byte_perm(int(u[0]), int(u[1]), 0x7632))
    p = _byte_perm(a, b, i | (i << 4) | ((4 + j) << 8) | ((4 + j) << 12))
    r = ((p << 4) & 0x07F007F0) | (p & 0x80008000)
    scale = _bf16_halves(two_pow)[0]
    return tuple(v * scale for v in _bf16_halves(r))


@pytest.mark.parametrize("code", [0, 1])
def test_e4m3_decode_of_the_kernel_is_exact(code):
    """Every s8 code (code 0) and every e4m3 code but NaN (code 1) decodes
    by the kernels' pair formula, at every byte position, as the ring
    kernel pairs two words (k rows) and the tile kernel one word (two
    columns), to the value torch gives it; the planted exponent fault
    (-DW8_FAULT=3, 2^121) doubles every e4m3 value, subnormals too."""
    rng = np.random.default_rng(12)
    codes = [b for b in range(256) if code == 0 or b & 0x7F != 0x7F]
    dtype = torch.int8 if code == 0 else torch.float8_e4m3fn
    want = torch.tensor(codes, dtype=torch.uint8).view(dtype).double().tolist()
    for c, v in zip(codes, want):
        for pos in range(4):
            other = int(rng.integers(0, 2**32, dtype=np.uint64))
            word = (other & ~(0xFF << (8 * pos))) | (c << (8 * pos))
            assert _w8_pair(word, other, pos, 0, code)[0] == v  # ring: low half
            assert _w8_pair(other, word, 1, pos, code)[1] == v  # ring: high half
            lo = pos & 2  # tile: bytes 2 q, 2 q + 1 of one word
            assert _w8_pair(word, word, lo, lo + 1, code)[pos & 1] == v
    if code:
        fault = [_w8_pair(c, c, 0, 0, 1, two_pow=0x7C00)[0] for c in codes]
        assert fault == [2 * v for v in want]


def _transpose4(w):
    """csrc/i8_gemm.cu transpose4 (six prmt), on ints or numpy arrays."""
    t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
    t2, t3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def test_byte_transpose_of_i8_gemm():
    """csrc/i8_gemm.cu transpose4: four row words (four columns each) become
    one word a column holding the four rows' bytes, row 0 lowest."""
    rng = np.random.default_rng(13)
    rows = [int(v) for v in rng.integers(0, 2**32, 4, dtype=np.uint64)]
    out = _transpose4(rows)
    for j in range(4):
        assert out[j] == sum(((rows[r] >> (8 * j)) & 0xFF) << (8 * r) for r in range(4))


def _emulate_w8(x, w, scale, splits, tiles):
    """The arithmetic of csrc/w8_gemm.cu's ring kernel, block by block: per
    K split the 64-row k-tiles in order, 32 rows (two k16 steps) at a time;
    a warp's 32-column slab dealt to four n8 tiles (tile j, position p =
    slab column 4p + j) and gathered back as a thread's 8 consecutive
    columns; groupwise partials scaled after the 32 rows that end a group;
    the per-tensor / per-channel scale in the epilogue, or after the sum
    over splits."""
    m, k = x.shape
    n = w.shape[1]
    kt = q8.W8_K_TILE
    mode = q8.scale_mode(scale)
    group = k // scale.shape[0] if mode == "group" else k
    wf, xf = w.float(), x.float()
    parts = []
    for sp in range(splits):
        acc = torch.zeros((m, n))
        part = torch.zeros((m, n))
        for t in range(sp * tiles, min((sp + 1) * tiles, k // kt)):
            for r0 in range(t * kt, (t + 1) * kt, 32):
                rows = slice(r0, r0 + 32)
                for n0 in range(0, n, 32):  # one warp slab
                    slab = wf[rows, n0:n0 + 32]
                    dealt = torch.stack([slab[:, j::4] for j in range(4)])  # [tile j, k, p]
                    prod = torch.einsum("mk,jkp->mjp", xf[:, rows], dealt)
                    # tile j position p -> slab column 4p + j
                    cols = prod.permute(0, 2, 1).reshape(m, 32)
                    (part if mode == "group" else acc)[:, n0:n0 + 32] += cols
                if mode == "group" and (r0 + 32) % group == 0:
                    acc += part * scale[r0 // group].float()
                    part.zero_()
        parts.append(acc)
    y = torch.stack(parts).sum(0) if splits > 1 else parts[0]
    if mode != "group":
        y = y * scale.float().reshape(-1 if mode == "channel" else ())
    return y.to(x.dtype)


@pytest.mark.parametrize("layout", ["tensor", "channel", "group"])
@pytest.mark.parametrize("m,k,n", [(3, 256, 64), (20, 128, 96)])
def test_w8_blocked_emulation_matches_plain(layout, m, k, n):
    rng = np.random.default_rng(14)
    x = _t(rng.standard_normal((m, k)).astype(np.float32))
    w = _t(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = {"tensor": torch.tensor(0.01), "channel": torch.rand(n) * 0.01 + 1e-3,
             "group": torch.rand(k // 64, n) * 0.01 + 1e-3}[layout]
    want = q8.w8_matmul_ref(x, w, scale)
    bm, splits, tiles = q8.w8_plan(m, k, n, 64, 132, grouped=layout == "group")
    assert bm < 128 and splits > 1  # the ring kernel, and few blocks: the split path runs
    for sp, t in ((splits, tiles), (1, k // q8.W8_K_TILE)):
        got = _emulate_w8(x, w, scale, sp, t)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def _swizzle(off):
    """The 128-byte swizzle of a byte offset from a 1024-byte aligned base:
    16-byte chunk c of 128-byte row r lies at chunk c ^ (r & 7)."""
    return off ^ (((off >> 7) & 7) << 4)


def _emulate_w8_tile(x, w, scale, bm, splits, tiles):
    """csrc/w8_gemm.cu's tile kernel, address by address in its shared
    memory: per block (bm rows, 128 columns, one K split) and 64-row k-tile,
    the copies lay x [bm][64] and the codes [64][128] in the 128-byte
    swizzle; the decode warpgroup's 128 threads (code row dr = tid % 64,
    16-code chunks c = tid / 64 + 2 i) write the values into the slot's two
    [64 k][64 n] halves, two 8-column chunks each; MMA warpgroup h reads its
    half through the M-major descriptor (16 B an 8-column chunk, 128 B a k
    row, 8-row groups 1024 B apart) and the x tile through the K-major one
    (32 B further a k16 step), D[column][token] += A B; a tile that ends a
    group adds partial x scale row to the sum. Values, not bits: the decode
    is checked apart (test_e4m3_decode_of_the_kernel_is_exact)."""
    m, k = x.shape
    n = w.shape[1]
    kt = q8.W8_K_TILE
    mode = q8.scale_mode(scale)
    group = k // scale.shape[0] if mode == "group" else k
    xf, wf, sf = x.double().numpy(), w.double().numpy(), scale.double().numpy()
    # the descriptors' reads, in 2-byte elements from the half's / x tile's base
    mn, kk = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    a_read = [_swizzle(ks * 2048 + 2 * (mn % 8) + 16 * (mn // 8) + 128 * (kk % 8)
                       + 1024 * (kk // 8)) // 2 for ks in range(4)]
    tok, kb = np.meshgrid(np.arange(bm), np.arange(16), indexing="ij")
    b_read = [_swizzle(ks * 32 + tok * 128 + 2 * kb) // 2 for ks in range(4)]
    rows, chunks = np.meshgrid(np.arange(bm), np.arange(8), indexing="ij")
    x_dst = _swizzle(rows * 128 + chunks * 16) // 2  # 8 elements from each
    crow, cchunk = np.meshgrid(np.arange(kt), np.arange(8), indexing="ij")
    c_dst = _swizzle(crow * 128 + cchunk * 16)  # 16 codes from each
    y = np.zeros((splits, m, n))
    for m0 in range(0, m, bm):
        for n0 in range(0, n, 128):
            for sp in range(splits):
                acc, tot = np.zeros((2, 64, bm)), np.zeros((2, 64, bm))
                for t in range(sp * tiles, min((sp + 1) * tiles, k // kt)):
                    xpad = np.zeros((bm, 64))
                    xpad[:min(bm, m - m0)] = xf[m0:m0 + bm, t * kt:(t + 1) * kt]
                    xs = np.zeros(bm * 64)
                    for e in range(8):
                        xs[x_dst + e] = xpad.reshape(bm, 8, 8)[:, :, e]
                    wpad = np.zeros((kt, 128))
                    wpad[:, :min(128, n - n0)] = wf[t * kt:(t + 1) * kt, n0:n0 + 128]
                    codes = np.zeros(kt * 128)
                    for e in range(16):
                        codes[c_dst + e] = wpad.reshape(kt, 8, 16)[:, :, e]
                    slot = np.zeros(2 * 64 * 64)
                    for tid in range(128):
                        dr, dc = tid & 63, tid >> 6
                        for i in range(4):
                            c = dc + 2 * i
                            src = dr * 128 + ((c ^ (dr & 7)) << 4)
                            half, ch = c >> 2, 2 * (c & 3)
                            for q in range(2):
                                dst = (half * 8192 + dr * 128 + (((ch + q) ^ (dr & 7)) << 4)) // 2
                                slot[dst:dst + 8] = codes[src + 8 * q:src + 8 * q + 8]
                    for h in range(2):
                        for ks in range(4):
                            acc[h] += slot[h * 4096 + a_read[ks]] @ xs[b_read[ks]].T
                    if mode == "group" and ((t + 1) * kt) % group == 0:
                        srow = np.zeros(128)
                        srow[:min(128, n - n0)] = sf[t * kt // group, n0:n0 + 128]
                        tot += acc * srow.reshape(2, 64, 1)
                        acc[:] = 0
                res = tot if mode == "group" else acc
                live = min(bm, m - m0)
                for h in range(2):
                    cols = n0 + 64 * h + np.arange(64)
                    ok = cols < n
                    y[sp][m0:m0 + live, cols[ok]] = res[h][ok][:, :live].T
    out = torch.from_numpy(y.sum(0))
    if mode != "group":
        out = out * scale.double().reshape(-1 if mode == "channel" else ())
    return out.to(x.dtype)


@pytest.mark.parametrize("layout", ["tensor", "channel", "group"])
def test_w8_tile_emulation_matches_plain(layout):
    """The tile kernel's layouts (copies, decode stores, the two wgmma
    descriptors) and its group flush give the plain product: 200 rows (a
    ragged 128- or 256-row block), 160 columns (a ragged column block), in
    the plan's K splits and unsplit; products and sums in f64, 1e-5
    relative."""
    rng = np.random.default_rng(17)
    m, k, n = 200, 256, 160
    x = _t(rng.standard_normal((m, k)).astype(np.float32))
    w = _t(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = {"tensor": torch.tensor(0.01), "channel": torch.rand(n) * 0.01 + 1e-3,
             "group": torch.rand(k // 128, n) * 0.01 + 1e-3}[layout]
    want = q8.w8_matmul_ref(x, w, scale)
    grouped = layout == "group"
    bm, splits, tiles = q8.w8_plan(m, k, n, 128 if grouped else 64, 132, grouped=grouped)
    assert bm == 128 and splits > 1
    for b, sp, t in ((bm, splits, tiles), (128, 1, 4), (256, 1, 4))[:2 if grouped else 3]:
        got = _emulate_w8_tile(x, w, scale, b, sp, t)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def _ring_codes_from_fragments(codes):
    """csrc/i8_gemm.cu's ring, one 64-row k-tile of one block: the copies
    place chunk c_c of code row k at c_c ^ 2 ((k >> 2) & 3) (thread tid: c_c
    = tid & 7, rows tid / 8 + 16 j); warp w's thread (g, tig) reads, per k32
    step kk, the words at slab column 4 g of rows kk + 4 tig + r and kk + 16 +
    4 tig + r (r < 4) and transposes them into the B fragments of n8 tiles
    j = 0..3 (column g of tile j is slab column 4 g + j). Returns the [64,
    128] codes the fragments hold, to be multiplied as the mma does."""
    stage = np.zeros(64 * 128, np.uint8)
    tid = np.arange(128)
    c_c, c_r = tid & 7, tid >> 3
    for j in range(4):
        row = c_r + 16 * j
        dst = row * 128 + ((c_c ^ (((row >> 2) & 3) << 1)) << 4)
        for e in range(16):
            stage[dst + e] = codes[row, 16 * c_c + e]
    words = stage.view("<u4").astype(np.uint64)
    got = np.zeros((64, 128), np.uint8)
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    for warp in range(4):
        slab = 32 * warp
        b_off = 4 * tig * 128 + ((((slab >> 4) + (g >> 2)) ^ (tig << 1)) << 4) + (g & 3) * 4
        for kk in (0, 32):
            for half in (0, 16):
                frag = _transpose4([words[(kk * 128 + b_off + (half + r) * 128) // 4]
                                    for r in range(4)])
                for j in range(4):
                    for byte in range(4):
                        got[kk + half + 4 * tig + byte, slab + 4 * g + j] = (
                            frag[j] >> (8 * byte)) & 0xFF
    return got.view(np.int8)


def _emulate_i8(xq, xs, w, scale, splits, tiles):
    """The arithmetic of csrc/i8_gemm.cu's ring kernel: per K split the
    64-row k-tiles in order, their codes as the fragments hold them
    (``_ring_codes_from_fragments``, per 128-column block), 32 rows (one k32
    step) at a time into int32 partials; a group's partial to f32 times its
    scale row where the group ends (groups), or the split's int32 sum times
    the column scale at its end (one group); the splits' f32 sums added,
    times the token's scale."""
    m, k = xq.shape
    n = w.shape[1]
    kt = q8.K_TILE
    s = scale.double().reshape(-1, n).numpy()
    groups = s.shape[0]
    group = k // groups
    wn = w.numpy()
    xqn = xq.numpy().astype(np.int64)
    parts = []
    for sp in range(splits):
        acc = np.zeros((m, n))
        part = np.zeros((m, n), np.int64)
        for t in range(sp * tiles, min((sp + 1) * tiles, k // kt)):
            codes = np.zeros((kt, n), np.int8)
            for n0 in range(0, n, 128):
                pad = np.zeros((kt, 128), np.int8)
                pad[:, :min(128, n - n0)] = wn[t * kt:(t + 1) * kt, n0:n0 + 128]
                codes[:, n0:n0 + 128] = _ring_codes_from_fragments(
                    pad.view(np.uint8))[:, :min(128, n - n0)]
            for kk in (0, 32):
                r0 = t * kt + kk
                part += xqn[:, r0:r0 + 32] @ codes[kk:kk + 32].astype(np.int64)
                if groups > 1 and (r0 + 32) % group == 0:
                    acc += part.astype(np.float64) * s[r0 // group]
                    part[:] = 0
        parts.append(acc if groups > 1 else part.astype(np.float64) * s[0])
    y = np.sum(parts, axis=0) * xs.double().numpy().reshape(-1, 1)
    return torch.from_numpy(y).float()


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_i8_blocked_emulation_matches_plain(groups):
    """The ring's copies, swizzled word reads, byte transposes and group
    flushes (groups of 256, 64 and 32 rows) give the plain product, in the
    plan's K splits and unsplit."""
    rng = np.random.default_rng(15)
    m, k, n = 6, 256, 160
    x = _t(rng.standard_normal((m, k)).astype(np.float32))
    xq, xs = q8.quantize_activations_ref(x)
    lo = -7 if groups > 1 else -127
    w = _t(rng.integers(lo, -lo + 1, (k, n)).astype(np.int8))
    scale = torch.rand(n) * 0.01 if groups == 1 else torch.rand(groups, n) * 0.01
    want = q8.i8_matmul_ref(xq, xs, w, scale, torch.float32)
    unit = q8.K_TILE if groups == 1 else k // groups
    bm, splits, tiles = q8.plan(m, k, n, unit, 132, grouped=groups > 1)
    assert bm == 16 and splits > 1
    for sp, t in ((splits, tiles), (1, k // q8.K_TILE)):
        got = _emulate_i8(xq, xs, w, scale, sp, t)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def _emulate_i8_tile(xq, xs, w, scale, bm, splits, tiles, fault=0):
    """csrc/i8_gemm.cu's tile kernel, address by address in its shared
    memory: per block (bm rows, 128 columns, one K split) and 128-row k-tile,
    the copies lay xq [bm][128] in the 128-byte swizzle and the codes [128
    k][128 n] with chunk c of row k at c ^ ((k >> 4) & 7); the producer's
    128 threads (k-chunk c = tid & 7, word qo = (tid >> 3) & 3 of word quad
    Q = 2 (tid >> 5) + u) read a word from 16 code rows, transpose them four
    rows at a time and store four 16-byte chunks (16 k of one column) into
    the slot's [64 n][128 k] halves in the 128-byte swizzle; MMA warpgroup h
    reads its half and the xq tile through K-major descriptors (rows 128 B
    apart, 8-row groups 1024 B apart, 32 B further a k32 step),
    D[column][token] += A B in integers; a tile that ends a group adds
    partial x scale row to the f32 sum, the next tile starts the partial
    anew; one group: the int32 sum times the column scale at the end. Then
    the splits' sum, times the token's scale. ``fault`` 3 stores the chunks'
    k-quads rotated by one (-DI8_FAULT=3), 1 keeps the partial after a flush
    (-DI8_FAULT=1)."""
    m, k = xq.shape
    n = w.shape[1]
    kt = q8.I8_TILE_K
    s = scale.double().reshape(-1, n).numpy()
    groups = s.shape[0]
    group = k // groups
    xqn, wn = xq.numpy().view(np.uint8), w.numpy().view(np.uint8)
    # the descriptors' reads, bytes from the half's / xq tile's base
    mn, kb = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
    a_read = [_swizzle(ks * 32 + mn * 128 + kb) for ks in range(4)]
    tok, kb = np.meshgrid(np.arange(bm), np.arange(32), indexing="ij")
    b_read = [_swizzle(ks * 32 + tok * 128 + kb) for ks in range(4)]
    rows, chunks = np.meshgrid(np.arange(bm), np.arange(8), indexing="ij")
    x_dst = _swizzle(rows * 128 + chunks * 16)
    krow, kch = np.meshgrid(np.arange(kt), np.arange(8), indexing="ij")
    c_dst = krow * 128 + ((kch ^ ((krow >> 4) & 7)) << 4)
    tid = np.arange(128)
    c, qo, wq = tid & 7, (tid >> 3) & 3, tid >> 5
    y = np.zeros((splits, m, n))
    for m0 in range(0, m, bm):
        for n0 in range(0, n, 128):
            live_m, live_n = min(bm, m - m0), min(128, n - n0)
            for sp in range(splits):
                part = np.zeros((2, 64, bm), np.int64)
                tot = np.zeros((2, 64, bm))
                for t in range(sp * tiles, min((sp + 1) * tiles, k // kt)):
                    xpad = np.zeros((bm, kt), np.uint8)
                    xpad[:live_m] = xqn[m0:m0 + bm, t * kt:(t + 1) * kt]
                    xtile = np.zeros(bm * kt, np.uint8)
                    wpad = np.zeros((kt, 128), np.uint8)
                    wpad[:, :live_n] = wn[t * kt:(t + 1) * kt, n0:n0 + 128]
                    codes = np.zeros(kt * 128, np.uint8)
                    for e in range(16):
                        xtile[x_dst + e] = xpad.reshape(bm, 8, 16)[:, :, e]
                        codes[c_dst + e] = wpad.reshape(kt, 8, 16)[:, :, e]
                    words = codes.view("<u4").astype(np.uint64)
                    slot = np.zeros(2 * 64 * kt // 4, np.uint64)  # as 32-bit words
                    for u in range(2):
                        q_hi = 2 * wq + u
                        src = 16 * c * 128 + ((q_hi ^ c) << 4) + qo * 4
                        o = [_transpose4([words[(src + (4 * i4 + r) * 128) // 4]
                                          for r in range(4)]) for i4 in range(4)]
                        for j in range(4):
                            col = 16 * q_hi + 4 * qo + j
                            r = col & 63
                            dst = (col >> 6) * 8192 + r * 128 + ((c ^ (r & 7)) << 4)
                            for i4 in range(4):
                                pos = (i4 + 1) % 4 if fault == 3 else i4
                                slot[(dst + 4 * pos) // 4] = o[i4][j]
                    slot_b = slot.astype("<u4").view(np.int8).astype(np.int64)
                    xt = xtile.view(np.int8).astype(np.int64)
                    for h in range(2):
                        half = slot_b[h * 8192:(h + 1) * 8192]
                        for ks in range(4):
                            part[h] += half[a_read[ks]] @ xt[b_read[ks]].T
                    if groups > 1 and ((t + 1) * kt) % group == 0:
                        srow = np.zeros(128)
                        srow[:live_n] = s[t * kt // group, n0:n0 + 128]
                        tot += part * srow.reshape(2, 64, 1)
                        if fault != 1:
                            part[:] = 0
                if groups > 1:
                    res = tot
                else:
                    srow = np.zeros(128)
                    srow[:live_n] = s[0, n0:n0 + 128]
                    res = part * srow.reshape(2, 64, 1)
                for h in range(2):
                    cols = n0 + 64 * h + np.arange(64)
                    ok = cols < n
                    y[sp][m0:m0 + live_m, cols[ok]] = res[h][ok][:, :live_m].T
    out = y.sum(0) * xs.double().numpy().reshape(-1, 1)
    return torch.from_numpy(out).float()


@pytest.mark.parametrize("groups", [1, 2])
def test_i8_tile_emulation_matches_plain(groups):
    """The tile kernel's layouts (copies, the producer's byte transpose into
    the K-major swizzled slot, the two wgmma descriptors) and its group
    flush at tile ends give the plain product: 200 rows (a ragged 128- or
    256-row block), 160 columns (a ragged column block), K = 512 in the
    plan's K splits and unsplit; sums in f64, 1e-5 relative. The planted
    faults the emulation can express (a k-quad off in the slot; a partial
    kept after its flush) change the product."""
    rng = np.random.default_rng(18)
    m, k, n = 200, 512, 160
    x = _t(rng.standard_normal((m, k)).astype(np.float32))
    xq, xs = q8.quantize_activations_ref(x)
    lo = -7 if groups > 1 else -127
    w = _t(rng.integers(lo, -lo + 1, (k, n)).astype(np.int8))
    scale = torch.rand(n) * 0.01 + 1e-3 if groups == 1 else torch.rand(groups, n) * 0.01 + 1e-3
    want = q8.i8_matmul_ref(xq, xs, w, scale, torch.float32)
    grouped = groups > 1
    unit = k // groups if grouped else q8.K_TILE
    bm, splits, tiles = q8.plan(m, k, n, unit, 132, grouped=grouped)
    assert bm == 128 and splits > 1
    tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    for b, sp, t in ((bm, splits, tiles), (128, 1, 4), (256, 1, 4))[:2 if grouped else 3]:
        torch.testing.assert_close(_emulate_i8_tile(xq, xs, w, scale, b, sp, t), want, **tol)
    for fault in (3, 1) if grouped else (3,):
        bad = _emulate_i8_tile(xq, xs, w, scale, 128, 1, 4, fault=fault)
        assert not torch.allclose(bad, want, **tol)


def test_fma_f32_rounds_once():
    """``fma_f32``, the fused multiply-add of i8_gemm's group sums, rounds
    ``a * b + c`` once: against exact rationals on random triples; on a
    sum whose f64 rounding lands on an f32 midpoint (1 + 2**-24 + 2**-60:
    rounding the f64 sum, or the f32 product then the sum, gives 1.0; once,
    1 + 2**-23); and on a sum just above the f64 value one step below an
    f32 midpoint, the midpoint's tie rounding up (2**11 + 2**-12 + 2**-13 -
    2**-41 + 2**-48: a step toward the exact sum would land on the midpoint
    and round up; once, 2**11 + 2**-12)."""
    from fractions import Fraction

    rng = np.random.default_rng(21)
    n = 400
    a = rng.integers(-2 ** 20, 2 ** 20, n).astype(np.float32)
    b = (rng.random(n) * 1e-3).astype(np.float32)
    c = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 8, n))).astype(np.float32)
    got = q8.fma_f32(_t(a), _t(b), _t(c)).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        assert abs(Fraction(float(got[i])) - exact) == min(dist)
    a1 = torch.tensor([1 + 2 ** -18], dtype=torch.float32)
    b1 = torch.tensor([-(1 - 2 ** -18) * 2 ** -24], dtype=torch.float32)
    c1 = torch.tensor([1 + 2 ** -23], dtype=torch.float32)
    assert q8.fma_f32(a1, b1, c1).item() == 1 + 2 ** -23
    assert (a1.double() * b1.double() + c1.double()).float().item() == 1.0
    assert (a1 * b1 + c1).item() == 1.0
    a2 = torch.tensor([48229 * 2 ** -16], dtype=torch.float32)  # a2 * b2 = 2**-13 - 2**-41 + 2**-48
    b2 = torch.tensor([712429 * 2 ** -32], dtype=torch.float32)
    c2 = torch.tensor([2 ** 11 + 2 ** -12], dtype=torch.float32)  # an odd f32
    exact = Fraction(float(a2)) * Fraction(float(b2)) + Fraction(float(c2))
    mid = Fraction(2 ** 11 + 2 ** -12) + Fraction(2 ** -13)
    assert mid - Fraction(2 ** -41) < exact < mid - Fraction(2 ** -42)
    assert (a2.double() * b2.double() + c2.double()).item() == float(mid) - 2 ** -41
    assert q8.fma_f32(a2, b2, c2).item() == 2 ** 11 + 2 ** -12


_ROUNDER = np.float32(12582912.0)  # 1.5 * 2**23 (csrc/act_quant.cu ROUNDER)
_NEAR_HALF = np.float32(0.5 - 2.0 ** -10)


def _act_fast(x, s):
    """csrc/act_quant.cu ``fast_code`` in numpy float32: (codes of ``t = x *
    rn(1 / s)`` rounded half to even by adding 1.5 * 2**23, the low byte of
    the sum's bits; where t lies within 2**-10 of a half-integer). No clip:
    |x| <= amax keeps |t| below 127.5."""
    t = x * (np.float32(1) / s)
    u = t + _ROUNDER
    codes = (u.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    return codes, np.abs(t - (u - _ROUNDER)) > _NEAR_HALF


def _act_exact(x, s):
    """``exact_codes``: the true quotient rounded half to even."""
    return (((x / s) + _ROUNDER).view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def _bf16_from_bits(bits):
    return (np.asarray(bits, np.uint32) << np.uint32(16)).view(np.float32)


# the 24 bf16 amaxes in [1, 2) whose half the reciprocal product alone
# rounds the other way (test_act_fast_quantize_is_exact_over_every_bf16_pair)
def _act_near_half_amaxes():
    a = _bf16_from_bits(0x3F80 + np.arange(128))
    s = a / np.float32(127)
    fast, _ = _act_fast(a / np.float32(2), s)
    return a[fast != _act_exact(a / np.float32(2), s)]


def test_act_fast_quantize_is_exact_over_every_bf16_pair():
    """Every bf16 amax in [1, 2) against every bf16 x in (0, amax]: the
    reciprocal product with its near-half escape gives the true division's
    code bit for bit; 466 pairs take the escape; without it (ACT_FAULT=2)
    24 codes differ, each at x = amax / 2 (quotient 63.5)."""
    pairs = near_n = wrong = 0
    halves = []
    for i in range(128):
        x = _bf16_from_bits(np.arange(1, 0x3F80 + i + 1))
        s = x[-1] / np.float32(127)
        want = np.rint(np.clip(x / s, -127, 127)).astype(np.int8)  # the plain version
        fast, near = _act_fast(x, s)
        np.testing.assert_array_equal(np.where(near, want, fast), want)
        bad = fast != want
        pairs, near_n, wrong = pairs + x.size, near_n + int(near.sum()), wrong + int(bad.sum())
        assert not (bad & ~near).any()
        halves += [float(v / x[-1]) for v in x[bad]]
    assert (pairs, near_n, wrong) == (2088896, 466, 24)
    assert halves == [0.5] * 24


def test_act_fast_quantize_on_rows_with_an_element_at_half_the_amax():
    """Rows [amax, amax / 2, ...] through the plain version: the emulated
    kernel's codes equal them with the escape, and differ without it in
    the rows of the 24 amaxes found above."""
    a = _bf16_from_bits(0x3F80 + np.arange(128))
    rng = np.random.default_rng(19)
    x = np.clip(rng.standard_normal((128, 64)).astype(np.float32) * a[:, None] * 0.2,
                -0.99 * a[:, None], 0.99 * a[:, None])
    x[:, 5], x[:, 9] = a, -a / 2
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want_q, want_s = q8.quantize_activations_ref(xt)
    xf = xt.float().numpy()
    s = want_s.numpy()
    fast, near = _act_fast(xf, s)
    chunk_near = np.repeat(near.reshape(128, 8, 8).any(-1), 8, axis=1)
    np.testing.assert_array_equal(np.where(chunk_near, _act_exact(xf, s), fast), want_q.numpy())
    rows_wrong = np.flatnonzero((fast != want_q.numpy()).any(-1))
    np.testing.assert_array_equal(a[rows_wrong], _act_near_half_amaxes())


def _act_rows(m, k, lda, shift, seed):
    """A bf16 [m, k] view of [m, lda] from element ``shift`` on, as
    chip_smoke.py's ``_act_input``: row 0 zero, row r's amax (a
    near-half amax times a power of two, sign alternating) at column
    (131 r + 7) % k, half of it at the next column, normal values below.
    Returns (x, the amax column of each row)."""
    rng = np.random.default_rng(seed)
    amaxes = _act_near_half_amaxes()
    r = np.arange(m)
    a = (amaxes[r % len(amaxes)] * np.exp2(r % 17 - 8)).astype(np.float32)[:, None]
    sign = (1.0 - 2.0 * (r % 2)).astype(np.float32)
    body = np.clip(rng.standard_normal((m, k)).astype(np.float32) * a * np.float32(3 / 16),
                   -0.99 * a, 0.99 * a)
    col = (r * 131 + 7) % k
    body[r, (col + 1) % k] = sign * a[:, 0] / 2
    body[r, col] = sign * a[:, 0]
    body[0] = 0.0
    buf = torch.zeros((m, lda), dtype=torch.bfloat16)
    x = buf[:, shift:shift + k]
    x.copy_(torch.from_numpy(body))
    return x, col


def _emulate_act_quant(x, fault=0, sm_count=132):
    """csrc/act_quant.cu in numpy, thread by thread: act_plan's rows a
    block, warps a row and chunks a thread (8 values, 16 bytes; as built:
    1-8 or 16 on the 16-byte path, 2, 8 or 16 on the scalar path, the
    chunks past the row masked); each thread's amax over its chunks, each
    warp's, the row's over its warps (fault 1: without the last warp, or
    each thread's first chunk where a row is one warp); the scale by true
    division; the fast quantize a chunk
    at a time, the chunk by true division where an element is near a
    half-integer (fault 2: never). The scalar path (K, the row stride or
    the pointer off 8 values) masks at K (fault 3: at K - 1). Asserts that
    every element of a row is held by exactly one (thread, chunk, lane) and
    every row by one block slot. Returns (codes, scales, dropped), dropped
    marking the columns fault 1 leaves out of the amax."""
    m, k = x.shape
    vec = k % 8 == 0 and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0
    vpt, warps, rows = q8.act_plan(m, k, sm_count)
    assert 1 <= vpt <= q8.ACT_VPT_MAX and 32 * warps * rows <= q8.ACT_THREADS
    vpt = 16 if vpt > 8 else vpt if vec else 8 if vpt > 2 else 2
    blocks = -(-m // rows)
    slots = (np.arange(blocks)[:, None] * rows + np.arange(rows)).ravel()
    np.testing.assert_array_equal(slots[slots < m], np.arange(m))
    nt, chunks = 32 * warps, -(-k // 8)
    stride = nt * vpt
    rounds = -(-chunks // stride)
    c = (np.arange(rounds)[:, None, None] * stride + np.arange(vpt)[None, :, None] * nt
         + np.arange(nt)[None, None, :])  # [round, j, thread]
    idx = 8 * c[..., None] + np.arange(8)  # [round, j, thread, lane]
    held = (c[..., None] < chunks) & (idx < k)
    np.testing.assert_array_equal(np.bincount(idx[held], minlength=k), np.ones(k))
    if fault == 3 and not vec:
        held &= idx < k - 1
    xf = x.float().numpy()
    vals = np.where(held, xf[:, np.minimum(idx, k - 1)], np.float32(0))  # [m, round, j, t, 8]
    drop = np.zeros(held.shape, bool)
    if warps == 1:
        drop[:, 0] = True
    else:
        drop[:, :, nt - 32:] = True
    dropped = np.zeros(k, bool)
    dropped[idx[held & drop]] = True
    part = np.abs(vals)
    if fault == 1 and warps == 1:
        part = np.where(drop, np.float32(0), part)
    per_warp = part.max(axis=(1, 2, 4)).reshape(m, warps, 32).max(-1)
    if fault == 1 and warps > 1:
        per_warp = per_warp[:, :-1]
    s = np.maximum(per_warp.max(-1), np.float32(1e-8)).astype(np.float32)[:, None] / np.float32(127)
    s5 = s[:, :, None, None, None]
    fast, near = _act_fast(vals, s5)
    codes = fast if fault == 2 else np.where(near.any(-1, keepdims=True), _act_exact(vals, s5), fast)
    q = np.zeros((m, k), np.int8)
    q[:, idx[held]] = codes[:, held]
    return torch.from_numpy(q), torch.from_numpy(s), dropped


@pytest.mark.parametrize("m,k,lda,shift", [
    (5, 1, 1, 0), (5, 7, 7, 0), (530, 1000, 1000, 0), (530, 1536, 1536, 0), (64, 3584, 3584, 0),
    (530, 3584, 3584, 0), (64, 3585, 3585, 0), (270, 8960, 8960, 0), (64, 18944, 18944, 0),
    (270, 18944, 18944, 0), (40, 3584, 3648, 0), (40, 3584, 3592, 1), (3, 40000, 40000, 0),
    (300, 1001, 1001, 0), (3, 70000, 70000, 0)])
def test_act_quant_warp_reduction_emulation(m, k, lda, shift):
    """csrc/act_quant.cu's layout and arithmetic (``_emulate_act_quant``)
    give the plain version's codes and scales bit for bit at the served K
    (1536, 3584, 8960, 18944), at 1000, ragged ones (1, 7, 1001, 3585), a
    row stride above K, a pointer one value off, masked chunks a thread
    (1001, 40000), and a row taken in two rounds. The
    planted faults change the codes: fault 1 exactly in the rows whose
    amax it left out, fault 2 wherever a row holds a near-half pair,
    fault 3 on the scalar path."""
    x, col = _act_rows(m, k, lda, shift, seed=20 + k)
    want_q, want_s = q8.quantize_activations_ref(x)
    q, s, dropped = _emulate_act_quant(x)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    fq, fs, _ = _emulate_act_quant(x, fault=1)
    wrong = (fs != want_s)[:, 0].numpy()
    lost = dropped[col] & (np.arange(m) > 0)
    np.testing.assert_array_equal(wrong, lost)
    if k > 1:  # K = 1: a row's one value is its amax, quotient 127
        assert not torch.equal(_emulate_act_quant(x, fault=2)[0], want_q)
    assert lost.any() or m < 8
    vec = k % 8 == 0 and lda % 8 == 0 and x.data_ptr() % 16 == 0
    assert torch.equal(_emulate_act_quant(x, fault=3)[0], want_q) == vec


def test_act_plan_fits_the_kernel():
    """act_plan at every row count and K a model serves, and at the edges:
    at most 512 threads and 16 chunks a thread; a row fits one round up to
    K = 65536; 2 chunks a thread aimed at below 264 rows, 8 from 264; rows
    share a block only up to 128 threads and while 264 blocks remain."""
    for m in (1, 8, 64, 263, 264, 527, 528, 1000, 2076, 8192):
        for k in (1, 8, 896, 1536, 3584, 4096, 8960, 14336, 18944, 65536, 65544):
            vpt, warps, rows = q8.act_plan(m, k)
            assert 1 <= vpt <= 16 and 32 * warps * rows <= 512
            chunks = -(-k // 8)
            assert (32 * warps * vpt >= chunks) == (k <= 65536)
            assert vpt <= (2 if m < 264 else 8) or warps == 16
            assert rows == 1 or (-(-m // rows) >= 264 and 32 * warps * rows <= 128)
    assert q8.act_plan(2048, 18944) == (8, 10, 1)
    assert q8.act_plan(64, 3584) == (2, 7, 1)
    assert q8.act_plan(64, 18944) == (5, 16, 1)
    assert q8.act_plan(2048, 3584) == (7, 2, 2)
