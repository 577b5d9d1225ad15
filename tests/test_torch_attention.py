"""Port attention (plain version, CPU dispatch) vs the JAX package.

Mirrors the cases of tests/test_pallas_decode.py and tests/test_pallas_prefill.py:
the port's plain attention is held against JAX ``paged_attention_ref`` and
against the Pallas kernels run in interpret mode. Tolerance 2e-5, as those
tests use. The CUDA kernels themselves run only on the GPU (chip_smoke.py
holds them against this plain version there).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.ops.attention import paged_attention_ref as j_ref
from rtp_llm_tpu.ops.attention.pallas_decode import paged_decode_attention as j_decode
from rtp_llm_tpu.ops.attention.pallas_prefill import paged_prefill_attention as j_prefill
from rtp_llm_tpu_torch.ops import attention as tattn
from rtp_llm_tpu_torch.ops.attention import decode as tdecode
from rtp_llm_tpu_torch.ops.attention import prefill as tprefill

BS = 16
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _decode_setup(b=4, hq=8, hkv=2, d=128, nb=32, max_blocks=8, seed=0, kv_lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((nb * BS, hkv * d)).astype(np.float32)
    v = rng.standard_normal((nb * BS, hkv * d)).astype(np.float32)
    if kv_lens is None:
        kv_lens = rng.integers(1, max_blocks * BS, size=(b,))
    kv_lens = np.asarray(kv_lens, np.int32)
    bt = np.zeros((b, max_blocks), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    i = 0
    for r in range(b):
        n = -(-int(kv_lens[r]) // BS)
        bt[r, :n] = perm[i: i + n]
        i += n
    return q, k, v, bt, kv_lens


def _port_decode(q, k, v, bt, lens, sm, **kw):
    return tdecode.paged_decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(bt), _t(lens),
                                          sm, BS, **kw).numpy()


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (8, 1)])
def test_decode_matches_reference(hq, hkv):
    q, k, v, bt, lens = _decode_setup(hq=hq, hkv=hkv)
    sm = 1.0 / np.sqrt(q.shape[-1])
    expect = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                   jnp.asarray(lens), jnp.asarray(lens - 1), sm, block_size=BS)
    np.testing.assert_allclose(_port_decode(q, k, v, bt, lens, sm),
                               np.asarray(expect[:, 0]), **TOL)


def _ref_decode(q, k, v, bt, lens, sm, **kw):
    return np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                            jnp.asarray(lens), jnp.asarray(np.maximum(lens - 1, 0)), sm,
                            block_size=BS, **kw)[:, 0])


def test_decode_inactive_rows_zero():
    q, k, v, bt, lens = _decode_setup(kv_lens=[5, 0, 33, 0])
    got = _port_decode(q, k, v, bt, lens, 0.1)
    assert np.all(got[1] == 0) and np.all(got[3] == 0)
    np.testing.assert_allclose(got, _ref_decode(q, k, v, bt, lens, 0.1), **TOL)


def test_decode_single_token_kv():
    q, k, v, bt, lens = _decode_setup(b=2, kv_lens=[1, 16])
    np.testing.assert_allclose(_port_decode(q, k, v, bt, lens, 0.2),
                               _ref_decode(q, k, v, bt, lens, 0.2), **TOL)


def test_decode_bf16_cache():
    q, k, v, bt, lens = _decode_setup(b=2, kv_lens=[40, 64])
    sm = 1.0 / np.sqrt(q.shape[-1])
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    expect = j_ref(qb, kb, vb, jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(lens - 1),
                   sm, block_size=BS)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tdecode.paged_decode_attention(tq[:, 0], tk, tv, _t(bt), _t(lens), sm, BS)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(expect[:, 0], np.float32), rtol=2e-2, atol=2e-2)


def test_decode_long_context_matches_chunked_kernel():
    """Wide block table: the JAX chunked (_decode_kernel) path."""
    q, k, v, bt, lens = _decode_setup(b=2, max_blocks=8, kv_lens=[40, 100])
    wide = np.zeros((2, 256), np.int32)
    wide[:, :8] = bt
    sm = 1.0 / np.sqrt(q.shape[-1])
    want = j_decode(jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(wide),
                    jnp.asarray(lens), sm, block_size=BS, interpret=True)
    np.testing.assert_allclose(_port_decode(q, k, v, wide, lens, sm), np.asarray(want), **TOL)


def test_decode_fullrow_path(monkeypatch):
    """Narrow table: the JAX whole-row (_fullrow_kernel) path."""
    import rtp_llm_tpu.ops.attention.pallas_decode as pd

    monkeypatch.setattr(pd, "fullrow_max_tokens", lambda: 2048)
    q, k, v, bt, lens = _decode_setup(b=3, max_blocks=6, kv_lens=[3, 50, 96])
    sm = 1.0 / np.sqrt(q.shape[-1])
    want = pd.paged_decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(bt), jnp.asarray(lens), sm,
                                     block_size=BS, interpret=True)
    np.testing.assert_allclose(_port_decode(q, k, v, bt, lens, sm), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [16, 40, 1000])
def test_decode_sliding_window(window):
    q, k, v, bt, lens = _decode_setup(b=3, kv_lens=[5, 70, 120])
    sm = 1.0 / np.sqrt(q.shape[-1])
    np.testing.assert_allclose(_port_decode(q, k, v, bt, lens, sm, sliding_window=window),
                               _ref_decode(q, k, v, bt, lens, sm, sliding_window=window),
                               **TOL)


def test_decode_sliding_window_fullrow(monkeypatch):
    import rtp_llm_tpu.ops.attention.pallas_decode as pd

    monkeypatch.setattr(pd, "fullrow_max_tokens", lambda: 2048)
    q, k, v, bt, lens = _decode_setup(b=2, max_blocks=7, kv_lens=[30, 100])
    want = pd.paged_decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(bt), jnp.asarray(lens), 0.1,
                                     block_size=BS, sliding_window=24, interpret=True)
    np.testing.assert_allclose(_port_decode(q, k, v, bt, lens, 0.1, sliding_window=24),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_decode_deferred_current_token(window):
    """cur_k / cur_v folded as the token at kv_len - 1 (cache holds kv_len-1):
    against the reference for both windows, and against the interpreted
    Pallas kernel without one (one compile keeps the file quick)."""
    q, k, v, bt, lens = _decode_setup(b=4, kv_lens=[1, 17, 64, 0], seed=5)
    rng = np.random.default_rng(6)
    ck = rng.standard_normal((4, k.shape[1])).astype(np.float32)
    cv = rng.standard_normal((4, k.shape[1])).astype(np.float32)
    sm = 0.09
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                 jnp.asarray(lens), jnp.asarray(np.maximum(lens - 1, 0)), sm,
                 block_size=BS, sliding_window=window, cur_k=jnp.asarray(ck),
                 cur_v=jnp.asarray(cv))
    got = _port_decode(q, k, v, bt, lens, sm, sliding_window=window,
                       cur_k=_t(ck), cur_v=_t(cv))
    np.testing.assert_allclose(got, np.asarray(want[:, 0]), **TOL)
    if window:
        return
    want_pd = j_decode(jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(bt), jnp.asarray(lens), sm, block_size=BS,
                       sliding_window=window, cur_k=jnp.asarray(ck),
                       cur_v=jnp.asarray(cv), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_pd), **TOL)


# ---- prefill ----


def _prefill_setup(t, hq=8, hkv=2, d=128, nb=64, q_offset=0, kv_len=None, seed=0):
    rng = np.random.default_rng(seed)
    kv_len = kv_len if kv_len is not None else q_offset + t
    mb = -(-kv_len // BS) + 1
    q = rng.standard_normal((t, hq, d)).astype(np.float32)
    k = rng.standard_normal((nb * BS, hkv * d)).astype(np.float32)
    v = rng.standard_normal((nb * BS, hkv * d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:mb].astype(np.int32)
    return q, k, v, bt, q_offset, kv_len


def _both_prefill(q, k, v, bt, off, kl, sm):
    want = j_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                     jnp.int32(off), jnp.int32(kl), sm, BS, interpret=True)
    got = tprefill.paged_prefill_attention(
        _t(q[None]), _t(k), _t(v), _t(bt[None]), torch.tensor([off]),
        torch.tensor([kl]), sm, BS)[0]
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("t,q_offset", [(64, 0), (128, 0), (128, 37), (256, 100)])
def test_prefill_matches_kernel(t, q_offset):
    q, k, v, bt, off, kl = _prefill_setup(t, q_offset=q_offset)
    if t == 128:  # the interpreted Pallas kernel: one compile for T=128
        got, want = _both_prefill(q, k, v, bt, off, kl, 1.0 / np.sqrt(q.shape[-1]))
        np.testing.assert_allclose(got, want, **TOL)
    # and the dispatch's plain version equals JAX paged_attention_ref
    ref = j_ref(jnp.asarray(q[None]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt[None]),
                jnp.asarray([kl]), jnp.asarray([off]), 1.0 / np.sqrt(q.shape[-1]),
                block_size=BS)
    port = tattn.paged_attention(_t(q[None]), _t(k), _t(v), _t(bt[None]),
                                 torch.tensor([kl]), torch.tensor([off]),
                                 1.0 / np.sqrt(q.shape[-1]), BS)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def test_prefill_padded_bucket_tail():
    t, q_offset, real = 128, 10, 50
    q, k, v, bt, off, _ = _prefill_setup(t, q_offset=q_offset)
    got, want = _both_prefill(q, k, v, bt, off, q_offset + real, 0.1)
    np.testing.assert_allclose(got[:real], want[:real], **TOL)
    assert np.all(got[real:] == 0) and np.all(want[real:] == 0)


def test_prefill_mha_no_gqa():
    q, k, v, bt, off, kl = _prefill_setup(128, hq=4, hkv=4)
    got, want = _both_prefill(q, k, v, bt, off, kl, 0.09)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_batched_rows_sliding_window():
    """B rows with per-row scalars and a window vs the JAX reference."""
    rng = np.random.default_rng(9)
    b, t, hq, hkv, d, nb, mb = 2, 24, 4, 2, 16, 40, 6
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((nb * BS, hkv * d)).astype(np.float32)
    v = rng.standard_normal((nb * BS, hkv * d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[: b * mb].reshape(b, mb).astype(np.int32)
    offs, lens = np.array([0, 30], np.int32), np.array([20, 54], np.int32)
    want = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                            jnp.asarray(lens), jnp.asarray(offs), 0.25, block_size=BS,
                            sliding_window=8))
    got = tprefill.paged_prefill_attention(_t(q), _t(k), _t(v), _t(bt), _t(offs), _t(lens),
                                           0.25, BS, sliding_window=8).numpy()
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[0, :20], want[0, :20], **TOL)
    assert np.all(got[0, 20:] == 0)  # padded tail of row 0


# ---- dispatch ----


def test_cpu_dispatch_takes_plain_version_and_no_kernel():
    tdecode.KERNEL.launches.n = tprefill.KERNEL.launches.n = 0
    before = tattn.PLAIN_CALLS.n
    q, k, v, bt, lens = _decode_setup(b=2, kv_lens=[9, 40])
    out = tattn.paged_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens), _t(lens - 1), 0.1, BS)
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                 jnp.asarray(lens), jnp.asarray(lens - 1), 0.1, block_size=BS)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    qp, kp, vp, btp, off, kl = _prefill_setup(64)
    tattn.paged_attention(_t(qp[None]), _t(kp), _t(vp), _t(btp[None]), torch.tensor([kl]),
                          torch.tensor([off]), 0.1, BS)
    assert tattn.PLAIN_CALLS.n == before + 2
    assert tdecode.KERNEL.launches.n == 0 and tprefill.KERNEL.launches.n == 0


@pytest.mark.parametrize("kw", [dict(soft_cap=-30.0), dict(alibi_slopes=torch.ones(8)),
                                dict(k_scale=torch.ones(1))],
                         ids=["soft_cap", "alibi", "int8_kv"])
def test_unported_modes_raise(kw):
    """ALiBi is not ported; a soft-cap is, but not a negative one; the int8
    pool's scales are, but only as a pair: a K scale without a V scale
    raises."""
    q, k, v, bt, lens = _decode_setup(b=1, kv_lens=[9])
    with pytest.raises((NotImplementedError, ValueError)):
        tattn.paged_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens), _t(lens - 1), 0.1,
                              BS, **kw)


def test_decode_split_count_depends_on_shapes_only():
    assert tdecode.num_splits(64, 4, 32, 64, sm_count=132) == 1
    assert tdecode.num_splits(64, 4, 32, 64, sm_count=512) == 4
    assert tdecode.num_splits(1, 4, 32, 64, sm_count=132) == 8  # 16 strips of 16 tokens a split
    assert tdecode.num_splits(1, 4, 1, 16, sm_count=132) == 1
