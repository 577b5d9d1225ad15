"""The port's groupwise dequant-GEMM (``rtp_llm_tpu_torch/ops/quant_gemm.py``)
against the JAX package's, on the CPU.

Mirrors tests/test_quant_gemm.py: the same numpy arrays go through both.
The JAX side runs its two routes, the Pallas kernel in interpret mode and
the XLA two-step form ``_xla_matmul``. The port runs its plain versions (on
a CPU tensor the wrapper takes them); the CUDA kernels are held against
those plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.ops import quant_gemm as jq
from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch.ops import quant_gemm as tq

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

# f32: the JAX tests' own tolerance against the dequantized product
TOL = dict(rtol=5e-5, atol=5e-5)
SHAPES = [("s4", 256, 384, 64), ("s4", 1024, 512, 128), ("e2m1", 512, 640, 32)]


def _mk(code, k, n, g, rows, seed=0):
    rng = np.random.default_rng(seed)
    if code == "s4":
        q = rng.integers(-8, 8, (k, n)).astype(np.int8)
    else:
        q = rng.integers(0, 16, (k, n)).astype(np.uint8)
    s = ((rng.random((k // g, n)) + 0.5) * 0.01).astype(np.float32)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    return q, s, x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("code", ["s4", "e2m1"])
def test_pack_split_half_bit_equal(code):
    rng = np.random.default_rng(3)
    lo, hi = (-8, 8) if code == "s4" else (0, 16)
    q = rng.integers(lo, hi, (3, 16, 10)).astype(np.int8)
    want = jq.pack_split_half(q, code=code)
    got = tq.pack_split_half(_t(q), code=code)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_split_half_rejects_bad_input():
    with pytest.raises(ValueError):
        tq.pack_split_half(torch.zeros((3, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        tq.pack_split_half(torch.full((2, 4), 8, dtype=torch.int8))


@pytest.mark.parametrize("code", ["s4", "e2m1"])
def test_decode_nibble_all_codes(code):
    c = np.arange(16, dtype=np.uint8)
    want = np.asarray(jq._decode_nibble(jnp.asarray(c), code, jnp.float32))
    got = tq.decode_nibble(_t(c), code, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code,k,n,g", SHAPES)
@pytest.mark.parametrize("ref", ["dequant", "partial"])
def test_plain_versions_match_both_jax_routes(code, k, n, g, ref):
    q, s, x = _mk(code, k, n, g, rows=8)
    packed = jq.pack_split_half(q, code=code)
    j_kernel = np.asarray(jq.groupwise_matmul_packed(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s), code=code, interpret=True))
    j_xla = np.asarray(jq._xla_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s), code))
    fn = tq.groupwise_matmul_ref if ref == "dequant" else tq.groupwise_matmul_partial_ref
    got = fn(_t(x), _t(packed), _t(s), code).numpy()
    np.testing.assert_allclose(got, j_kernel, **TOL)
    np.testing.assert_allclose(got, j_xla, **TOL)


@pytest.fixture
def jax_int4_pipeline():
    """The JAX package's pipelined kernel ``_gw_kernel_pipe`` for the test's
    duration: the flag is process-wide, and a worker runs other files after."""
    from rtp_llm_tpu.config import runtime_flags

    runtime_flags.set_flag("int4_pipeline", True)
    yield
    runtime_flags.reset()


@pytest.mark.parametrize("code,k,n,g", SHAPES)
def test_pipe_matches_the_jax_pipelined_kernel(code, k, n, g, jax_int4_pipeline):
    """``variant="pipe"`` (gw_gemm_pipe's plain version on the CPU) against
    the interpreted ``_gw_kernel_pipe`` it replaces."""
    q, s, x = _mk(code, k, n, g, rows=8)
    packed = jq.pack_split_half(q, code=code)
    want = np.asarray(jq._kernel_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s),
                                        code, interpret=True))
    got = tq.groupwise_matmul_packed(_t(x), _t(packed), _t(s), code=code, variant="pipe")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _sweep_module():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "int4_kernel_sweep.py"
    spec = importlib.util.spec_from_file_location("int4_kernel_sweep", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("body", ["_gw_kernel_partial", "_gw_kernel_i16dec", "_gw_kernel_i8dec"])
def test_sweep_kernels_decode_twos_complement(body):
    """The sweep kernels gw_gemm_partial replaces decode a nibble as two's
    complement, ``(c ^ 8) - 8``, where the package stores offset codes
    (``c - 8``, ``pack_split_half``): on the same bytes they compute another
    function. The port keeps the offset decode. Flipping both nibbles' top
    bit (``packed ^ 0x88``) turns one code into the other, so on those bytes
    the port's partial plain version equals the sweep kernel; on the bytes
    themselves it equals ``_kernel_matmul`` and differs from the sweep."""
    sweep = _sweep_module()
    code, k, n, g, m = "s4", 1024, 512, 128, 8
    q, s, x = _mk(code, k, n, g, rows=m)
    packed = jq.pack_split_half(q, code=code)
    # scales as the sweep's main() lays them out: [n_k, 2, ng_pad, N]
    kpt, nt = 256, 512
    ng, n_k = kpt // g, k // 2 // kpt
    ng_pad = -(-ng // 8) * 8
    sr = jnp.asarray(s).reshape(2, n_k, ng, n)
    s3 = jnp.pad(jnp.stack([sr[0], sr[1]], axis=1),
                 ((0, 0), (0, 0), (0, ng_pad - ng), (0, 0)))
    run = sweep.make_variant(getattr(sweep, body), m, k, n, g, kpt, nt, interpret=True)
    swept = np.asarray(run(jnp.asarray(x), jnp.asarray(packed), s3))
    flipped = tq.groupwise_matmul_partial_ref(_t(x), _t(packed ^ 0x88), _t(s), code).numpy()
    np.testing.assert_allclose(swept, flipped, **TOL)
    ours = tq.groupwise_matmul_partial_ref(_t(x), _t(packed), _t(s), code).numpy()
    served = np.asarray(jq._kernel_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s),
                                          code, interpret=True))
    np.testing.assert_allclose(ours, served, **TOL)
    assert np.abs(swept - ours).max() > 1.0


@pytest.mark.parametrize("ref", ["dequant", "partial"])
def test_plain_versions_bf16(ref):
    """bf16 x. The port's dequant version rounds the scaled weight to bf16
    and multiplies with f32 sums; the partial version keeps exact codes and
    f32 partials. The JAX CPU route sums its bf16 dots in bf16. All three
    round a result of magnitude ~0.5 to bf16 (ulp 2**-8 relative), and the
    weight rounding adds a relative 2**-9 per term that averages out over
    K = 1024 terms, so they agree within 2 bf16 ulps of the row's scale:
    atol 2e-2 * rms + rtol 2**-6. Both are held to the f32 product too."""
    code, k, n, g = "s4", 1024, 512, 128
    q, s, x = _mk(code, k, n, g, rows=8)
    packed = jq.pack_split_half(q, code=code)
    exact = x.astype(np.float32) @ (q.astype(np.float32) * np.repeat(s, g, axis=0))
    xb = _t(x).to(torch.bfloat16)
    exact_b = xb.float().numpy() @ (q.astype(np.float32) * np.repeat(s, g, axis=0))
    fn = tq.groupwise_matmul_ref if ref == "dequant" else tq.groupwise_matmul_partial_ref
    got = fn(xb, _t(packed), _t(s), code)
    assert got.dtype == torch.bfloat16
    rms = float(np.sqrt((exact ** 2).mean()))
    np.testing.assert_allclose(got.float().numpy(), exact_b, rtol=2 ** -6, atol=2e-2 * rms)
    j = jq._xla_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed), jnp.asarray(s), code)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(j.astype(jnp.float32)),
                               rtol=2 ** -6, atol=2e-2 * rms)


def test_zero_point_correction():
    k, n, g, rows = 256, 384, 64, 8
    q, s, x = _mk("s4", k, n, g, rows)
    z = np.random.default_rng(1).integers(-8, 8, (k // g, n)).astype(np.float32)
    packed = jq.pack_split_half(q)
    want = np.asarray(jq.groupwise_matmul_packed(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s), code="s4",
        zero=jnp.asarray(z), interpret=True))
    for kw in (dict(zero=_t(z)), dict(zero_scale=_t(z * s))):
        got = tq.groupwise_matmul_packed(_t(x), _t(packed), _t(s), code="s4", **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and against the dequantized asymmetric weight itself
    ref = x @ ((q.astype(np.float32) - np.repeat(z, g, axis=0)) * np.repeat(s, g, axis=0))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_3d_x_ragged_m_and_narrow_n():
    """x of rank 3 with 2 * 5 rows; N = 96 (the JAX wrapper falls back to
    XLA there, the port's plain version takes any N)."""
    k, n, g = 256, 96, 64
    q, s, _ = _mk("s4", k, n, g, rows=1)
    x3 = np.random.default_rng(2).standard_normal((2, 5, k)).astype(np.float32)
    packed = jq.pack_split_half(q)
    want = np.asarray(jq.groupwise_matmul_packed(
        jnp.asarray(x3), jnp.asarray(packed), jnp.asarray(s), code="s4", interpret=True))
    got = tq.groupwise_matmul_packed(_t(x3), _t(packed), _t(s), code="s4")
    assert got.shape == (2, 5, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_stacked_layer_index_is_a_view():
    rng = np.random.default_rng(0)
    layers, m, k, n, g = 3, 8, 512, 256, 128
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = rng.integers(0, 256, (layers, k // 2, n)).astype(np.uint8)
    scale = rng.uniform(1e-3, 5e-3, (layers, k // g, n)).astype(np.float32)
    tp = _t(packed)
    assert tp[1].is_contiguous() and tp[1].data_ptr() == tp.data_ptr() + tp[0].numel()
    for li in range(layers):
        want = np.asarray(jq.groupwise_matmul_packed(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale[li]),
            layer=jnp.int32(li), interpret=True))
        got = tq.groupwise_matmul_packed(_t(x), tp, _t(scale[li]), layer=li)
        sliced = tq.groupwise_matmul_packed(_t(x), tp[li], _t(scale[li]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, sliced)
    with pytest.raises(ValueError):
        tq.groupwise_matmul_packed(_t(x), tp, _t(scale[0]))  # a stack without a layer


def test_variants_on_cpu():
    """pipe is base's function (one plain version); partial is the two-step
    form; an unknown variant or code raises."""
    q, s, x = _mk("s4", 256, 384, 64, rows=4)
    packed = _t(jq.pack_split_half(q))
    base = tq.groupwise_matmul_packed(_t(x), packed, _t(s), variant="base")
    assert torch.equal(tq.groupwise_matmul_packed(_t(x), packed, _t(s), variant="pipe"), base)
    part = tq.groupwise_matmul_packed(_t(x), packed, _t(s), variant="partial")
    np.testing.assert_allclose(part.numpy(), base.numpy(), **TOL)
    with pytest.raises(ValueError):
        tq.groupwise_matmul_packed(_t(x), packed, _t(s), variant="fast")
    with pytest.raises(ValueError):
        tq.groupwise_matmul_packed(_t(x), packed, _t(s), code="nf4")


def test_plain_calls_are_counted():
    q, s, x = _mk("s4", 256, 64, 64, rows=2)
    before = tq.PLAIN_CALLS.n
    tq.groupwise_matmul_packed(_t(x), _t(jq.pack_split_half(q)), _t(s))
    assert tq.PLAIN_CALLS.n == before + 1
    assert all(k.launches.n == 0 for k in tq.KERNELS.values())


@pytest.mark.parametrize("m,k,n,variant,want", [
    (64, 3584, 37888, "base", (64, 128, 1)),   # wide tiles alone fill the card
    (64, 3584, 3584, "base", (64, 64, 7)),     # o_proj at decode: narrow tiles + K splits
    (64, 18944, 3584, "pipe", (64, 64, 7)),     # below 128 rows all three share the ring's plan
    (1, 3584, 4608, "base", (16, 64, 5)),
    (2048, 3584, 4608, "base", (128, 128, 1)),  # 128-row blocks from 128 rows on
    (512, 3584, 3584, "base", (128, 128, 2)),   # 112 blocks for 264 slots: K split in two
    (8, 3584, 37888, "base", (16, 128, 4)),     # 296 blocks on 132 SMs: split to even the rounds
    (64, 3584, 3584, "partial", (64, 64, 7)),
    (2048, 3584, 37888, "partial", (64, 128, 1)),  # partial stays on the ring at every row count
    (2048, 3584, 37888, "pipe", (256, 128, 1)),    # 256-row blocks when they fill the SMs
    (512, 3584, 4608, "pipe", (256, 128, 1)),      # one round of 72 blocks beats two of 144
    (512, 18944, 3584, "pipe", (128, 128, 1)),     # one round either way: 128 rows
    (130, 3584, 3600, "pipe", (128, 128, 2)),
    (8, 128, 64, "base", (16, 64, 2)),         # never more splits than k-tiles
    (8, 128, 64, "pipe", (16, 64, 2)),
])
def test_launch_plan(m, k, n, variant, want):
    assert tq.plan(m, k, n, 132, variant) == want
    bm, bn, splits = want
    # the splits tile the packed rows exactly, none empty
    rows = [tq.split_rows(k, splits, i) for i in range(splits)]
    assert rows[0][0] == 0 and rows[-1][1] == k // 2
    assert all(a < b for a, b in rows) and all(rows[i][1] == rows[i + 1][0]
                                               for i in range(splits - 1))


# every 4-bit linear of Qwen2-7B and Llama-3-8B as (K, N)
LINEARS = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584),
           (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]


@pytest.mark.parametrize("k,n", LINEARS)
@pytest.mark.parametrize("m", [1, 64, 65, 128, 512, 2048])
def test_base_plan_row_tiles_and_ring(m, k, n):
    """gw_gemm's plan at every served linear: 128-row blocks from 128 rows
    on, no empty split, whole k-tiles per split, a ring of at least three
    stages that fits a block's shared memory, and a k-tile that either lies
    inside one scale group per plane or carries a scale row per 32-row half
    (groups of 32 and 128)."""
    bm, bn, splits = tq.plan(m, k, n, 132, "base")
    assert bm == (128 if m >= 128 else next(b for b in (16, 32, 64) if m <= b or b == 64))
    assert bn in ((128,) if bm == 128 else (64, 128))
    assert 1 <= splits <= (4 if bm == 128 else tq.MAX_SPLITS)
    rows = [tq.split_rows(k, splits, i) for i in range(splits)]
    assert rows[0][0] == 0 and rows[-1][1] == k // 2
    assert all(a < b for a, b in rows)
    assert all(rows[i][1] == rows[i + 1][0] for i in range(splits - 1))
    assert all(a % tq.K_TILE == 0 for a, _ in rows)
    ring = tq.ring_plan(bm, bn)
    assert ring["stages"] >= 3
    assert ring["smem_bytes"] < tq.SMEM_LIMIT
    assert ring["weight_bytes_in_flight"] >= 4096
    # three blocks of the small row tiles fit one SM's 227 KB beside 1 KB each of system use
    assert bm >= 128 or 3 * (ring["smem_bytes"] + 1024) <= tq.SMEM_LIMIT
    for group in (32, 128):
        halves = ring["k_tile"] // 32
        assert ring["scale_rows"] == 2 * halves  # one per plane and 32-row half
        assert group % 32 == 0  # so a 32-row half never straddles a group
        for r0, r1 in rows:
            assert r0 % 32 == 0 and r1 % 32 == 0


def _check_splits(k, splits):
    """No empty split, whole k-tiles per split, the packed rows tiled exactly."""
    rows = [tq.split_rows(k, splits, i) for i in range(splits)]
    assert rows[0][0] == 0 and rows[-1][1] == k // 2
    assert all(a < b for a, b in rows)
    assert all(rows[i][1] == rows[i + 1][0] for i in range(splits - 1))
    assert all(a % tq.K_TILE == 0 and b % tq.K_TILE == 0 for a, b in rows)


@pytest.mark.parametrize("k,n", LINEARS)
@pytest.mark.parametrize("m", [1, 64, 65, 128, 512, 2048])
def test_pipe_plan_row_tiles_and_ring(m, k, n):
    """gw_gemm_pipe's plan at every served linear: the shared ring below 128
    rows (gw_gemm's plan there), from 128 rows the warp-specialised tile
    kernel with 256- or 128-row blocks, whichever takes fewer rounds over the
    SMs (a 256-row round counted 1.4x); its four
    x / packed stages and two decoded slots fit one block's shared memory
    and hold the bf16 output tile."""
    bm, bn, splits = tq.plan(m, k, n, 132, "pipe")
    if m < 128:
        assert (bm, bn, splits) == tq.plan(m, k, n, 132, "base")
    else:
        assert bn == 128 and bm in (128, 256) and 1 <= splits <= 4
        rounds = {b: -(-(-(-m // b) * -(-n // 128)) // 132) for b in (128, 256)}
        assert rounds[bm] * (1.4 if bm == 256 else 1) <= min(
            rounds[128], 1.4 * rounds[256])  # the block shape with fewer weighted rounds
        if m >= 1024:
            assert bm == 256  # wide prefill: each weight decoded once per 256 rows
    _check_splits(k, splits)
    ring = tq.ring_plan(bm, bn, "pipe")
    assert ring["stages"] >= 3
    assert ring["smem_bytes"] < tq.SMEM_LIMIT
    assert ring["weight_bytes_in_flight"] >= 4096
    if bm >= 128:
        assert ring["decoded_slots"] == 2 and ring["slot_bytes"] == bn * 2 * tq.K_TILE * 2
        assert bm * bn * 2 <= ring["stages"] * ring["stage_bytes"]  # the output tile reuses the ring
    else:
        assert ring["decoded_slots"] == 0 and 3 * (ring["smem_bytes"] + 1024) <= tq.SMEM_LIMIT


@pytest.mark.parametrize("k,n", LINEARS)
@pytest.mark.parametrize("m", [1, 64, 65, 128, 512, 2048])
def test_partial_plan_row_tiles_and_ring(m, k, n):
    """gw_gemm_partial's plan at every served linear: the shared ring at
    every row count, row tiles of 16 / 32 / 64 (its two accumulator sets
    allow no more), a ring of at least three stages of which three blocks
    fit an SM."""
    bm, bn, splits = tq.plan(m, k, n, 132, "partial")
    assert bm == next(b for b in (16, 32, 64) if m <= b or b == 64)
    assert bn in (64, 128) and 1 <= splits <= tq.MAX_SPLITS
    if m < 128:
        assert (bm, bn, splits) == tq.plan(m, k, n, 132, "base")
    _check_splits(k, splits)
    ring = tq.ring_plan(bm, bn, "partial")
    assert ring["stages"] >= 3 and ring["decoded_slots"] == 0
    assert ring["smem_bytes"] < tq.SMEM_LIMIT
    assert 3 * (ring["smem_bytes"] + 1024) <= tq.SMEM_LIMIT
    assert ring["weight_bytes_in_flight"] >= 4096


def test_kernels_share_one_library_per_source():
    """One library per source and defines: gw_gemm, gw_gemm_pipe and
    gw_gemm_partial have a source each (built in parallel); a second kernel of
    the same source shares its library, and the same source built with a
    define is another library. The library's name hashes the source, every
    shared header and the flags."""
    base, pipe, partial = (tq.KERNELS[v] for v in ("base", "pipe", "partial"))
    assert len({id(base.lib), id(pipe.lib), id(partial.lib)}) == 3
    paths = {k.lib._lib_path() for k in (base, pipe, partial)}
    assert len(paths) == 3
    twin = _kernels.Kernel("twin", "gw_gemm_pipe.cu", "gw_gemm_pipe", tq._ARGTYPES)
    assert twin.lib is pipe.lib and twin.launches is not pipe.launches
    fault = _kernels.Kernel("fault", "gw_gemm_pipe.cu", "gw_gemm_pipe", tq._ARGTYPES,
                            defines=("GW_FAULT=1",))
    assert fault.lib is not pipe.lib and fault.lib._lib_path() != pipe.lib._lib_path()
    assert "-DGW_FAULT=1" in fault.lib.flags


def test_library_rebuilds_when_a_header_changes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_kernels, "CSRC", str(csrc))
    lib = _kernels.Library("a.cu")
    first = lib._lib_path()
    assert lib._lib_path() == first
    (csrc / "common.cuh").write_text("// v2\n")
    assert lib._lib_path() != first


@pytest.mark.parametrize("k,n,g,dtype,contiguous,exc", [
    (256, 64, 64, torch.float32, True, NotImplementedError),   # f32 x
    (192, 64, 64, torch.bfloat16, True, NotImplementedError),  # K % (2 * group) != 0
    (128, 64, 16, torch.bfloat16, True, NotImplementedError),  # group % 32 != 0
    (256, 24, 64, torch.bfloat16, True, NotImplementedError),  # N % 16 != 0
    (256, 64, 64, torch.bfloat16, False, ValueError),          # a weight that would need a copy
])
def test_kernel_launch_refuses_what_the_kernels_do_not_take(k, n, g, dtype, contiguous, exc):
    """The checks in front of the launch raise; nothing falls back to the
    plain version (``_launch`` is what a CUDA tensor reaches)."""
    x = torch.zeros((4, k), dtype=dtype)
    packed = torch.zeros((k // 2, n), dtype=torch.uint8)
    if not contiguous:
        packed = torch.zeros((n, k // 2), dtype=torch.uint8).T
    scale = torch.ones((k // g, n), dtype=torch.float32)
    before = tq.PLAIN_CALLS.n
    with pytest.raises(exc):
        tq._launch(x, packed, scale, "s4", "base", None)
    assert tq.PLAIN_CALLS.n == before
