"""The work split and arithmetic of the decode attention kernel
(``csrc/paged_decode.cu``).

The kernel itself runs only on the card. What the CPU can hold:

(a) the host-side plan in ``ops/attention/decode.py``: the split count is a
    function of shapes only, and ``split_strips`` (the kernel's own index
    arithmetic: 16-token strips of the live range dealt to splits, and
    round-robin to the four warps of a split) covers every strip holding a
    live token exactly once and schedules no strip without one;
(b) a blocked emulation in plain PyTorch of the kernel's arithmetic: each
    warp walks its strips with rows outside the live range zero-filled (never
    read: the emulated pool holds NaN there), f32 scores from bf16 / int8 /
    e4m3 operands (each upcast exactly, as the kernel's registers hold them),
    K scale on the score, its own online softmax in f32 in the exp2 domain, V
    scale on p after the normaliser took it, P rounded to bf16 with the
    rounding remainder as a second product while the warp's sum is small;
    then the four warps and the deferred current token merged in f32, then
    the context splits. Held against the port's plain version
    ``paged_decode_ref`` and against the JAX package on the same
    numpy-seeded inputs: the Pallas decode kernel in interpret mode for a
    float pool and for an int8 pool (its ``quant`` mode, scales gathered as
    the JAX package gathers them), ``paged_attention_ref`` for int8 and e4m3
    pools.

Tolerance of (b) against the plain versions: the card's check
(``chip_smoke.py`` ATOL, RTOL, REL_L2): every element within 2e-3 + 1e-2 *
|want| and every (row, head) vector within 1e-2 relative L2. Both sides
round their output to bf16 (one ulp is 2**-8 relative, which RTOL spans) and
sum in different orders. Against the Pallas quant kernel 2e-2, as
``tests/test_torch_kv_quant.py`` holds it: that kernel's dots run in bf16.
A strip read from the wrong rows, a scale on the wrong side of the
normaliser or P rounded without its remainder against few cancelling keys
moves a row by several 1e-2 and more, or makes it NaN.

Groups of 9-16 query heads (D 128) run two n8 head tiles: the emulation
holds a kv head's heads as ``8 * head_tiles(G)`` columns, one online softmax
a column, the remainder product taken while any live head of either tile is
small; the planted "second_tile_left_out" (``-DPD_FAULT=6``) leaves heads
8-15 without scores.
"""

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.ops.attention import _expand_kv_scales
from rtp_llm_tpu.ops.attention import paged_attention_ref as j_ref
from rtp_llm_tpu_torch.ops.attention import decode as td

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

ATOL, RTOL, REL_L2 = 2e-3, 1e-2, 1e-2
LO_RATIO = 64.0  # csrc/paged_decode.cu: when the remainder product is dropped
NEG = -1e30
FP8 = torch.float8_e4m3fn
D = 128


# ---------------------------------------------------------------- (a) plan


def test_split_count_depends_on_shapes_only():
    """The call takes no kv_lens; at the shapes the card runs it fills one
    round of the blocks 132 SMs hold (two a SM for a bf16 pool, four for a
    1-byte one), capped by the table's width."""
    assert td.num_splits(8, 8, 128, 64, sm_count=132) == 4  # 8 rows x 8192, Llama heads
    assert td.num_splits(8, 8, 128, 64, sm_count=132, elem_bytes=1) == 8
    assert td.num_splits(8, 8, 16, 64, sm_count=132) == 4  # served: ~560 tokens, 1024 bucket
    assert td.num_splits(64, 4, 64, 64, sm_count=132) == 1  # B=64, Qwen2-7B heads
    assert td.num_splits(64, 4, 64, 64, sm_count=132, elem_bytes=1) == 2
    assert td.num_splits(64, 8, 64, 64, sm_count=132) == 1  # B=64, Llama heads
    assert td.num_splits(1, 8, 512, 16, sm_count=132) == 32  # capped: 512 strips / 16
    for args in ((8, 8, 128, 64), (1, 1, 1, 16), (3, 2, 7, 16), (64, 4, 2, 64), (2, 1, 64, 64)):
        for eb in (1, 2):
            n = td.num_splits(*args, sm_count=132, elem_bytes=eb)
            max_strips = -(-args[2] * args[3] // td.STRIP)
            assert n == 1 or (args[0] * args[1] * n <= td.BLOCKS_PER_SM[eb] * 132
                              and n <= max_strips // td.MIN_SPLIT_STRIPS)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("cur", [False, True])
@pytest.mark.parametrize("window", [0, 7, 40, 1000])
def test_strips_cover_live_tokens_once_and_no_dead_strip(window, cur, splits):
    for kv_len in (0, 1, 2, 15, 16, 17, 63, 64, 65, 100, 257, 1000, 2049):
        cached = max(kv_len - 1, 0) if cur else kv_len
        lo = max(kv_len - window, 0) if window else 0
        seen = {}
        for split in range(splits):
            for warp in range(td.WARPS):
                strips = td.split_strips(kv_len, window, cur, splits, split, warp)
                assert strips == sorted(strips) and all(
                    b - a == td.WARPS for a, b in zip(strips, strips[1:]))
                for j in strips:
                    seen[j] = seen.get(j, 0) + 1
                    toks = range(j * td.STRIP, (j + 1) * td.STRIP)
                    assert any(lo <= t < cached for t in toks)  # no dead strip
        live = {t // td.STRIP for t in range(lo, cached)}
        assert set(seen) == live and all(n == 1 for n in seen.values())


def test_warps_of_a_split_share_its_strips_evenly():
    for kv_len, splits in ((8192, 9), (560, 4), (2048, 3), (3000, 3), (65, 1)):
        for split in range(splits):
            counts = [len(td.split_strips(kv_len, 0, False, splits, split, w))
                      for w in range(td.WARPS)]
            assert max(counts) - min(counts) <= 1 and counts == sorted(counts, reverse=True)


# ---------------------------------------------------------------- (b) emulation


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_decode(q, k_cache, v_cache, bt, lens, sm, bs, window=0, cur_k=None, cur_v=None,
                   k_scale=None, v_scale=None, splits=1, fault=None, soft_cap=0.0):
    """The kernel's arithmetic, warp by warp, in plain PyTorch (f32 math on
    bf16 / int8 / e4m3 operands). ``fault`` plants one: "no_remainder" (P
    rounded to bf16 alone), "dead_rows_read" (rows outside the live range
    read from their slots instead of zero-filled), "v_scale_before_l",
    "no_tanh" (the soft-cap's tanh left out), "second_tile_left_out"
    (heads 8-15 of a group get no scores). ``soft_cap`` > 0: every score,
    the current token's too, is ``cap * tanh(x * sm / cap) * log2 e`` in
    the exp2 domain (x: q . K with the K scale). Test support: nothing in
    the port calls it."""
    b, hq, d = q.shape
    hkv = k_cache.shape[1] // d
    g = hq // hkv
    maxg = td.N8 * td.head_tiles(g)  # the kernel's head columns: one or two n8 tiles
    sl2 = sm * 1.4426950408889634

    def log2_score(x):  # csrc/paged_decode.cu log2_score
        if soft_cap > 0 and fault != "no_tanh":
            return soft_cap * 1.4426950408889634 * torch.tanh(x * (sm / soft_cap))
        return x * sl2
    has_cur = cur_k is not None
    out = torch.zeros((b, hq, d), dtype=torch.bfloat16)
    for row in range(b):
        kv_len = int(lens[row])
        cached = max(kv_len - 1, 0) if has_cur else kv_len
        lo = max(kv_len - window, 0) if window > 0 else 0
        for kvh in range(hkv):
            cols = slice(kvh * d, (kvh + 1) * d)
            qg = torch.zeros((maxg, d))
            qg[:g] = q[row, kvh * g:(kvh + 1) * g].float()
            parts = []
            for split in range(splits):
                ms, ls, os_ = [], [], []
                for warp in range(td.WARPS):
                    m, l = torch.full((maxg,), NEG), torch.zeros(maxg)
                    o = torch.zeros((maxg, d))
                    for j in td.split_strips(kv_len, window, has_cur, splits, split, warp):
                        pos = j * td.STRIP + torch.arange(td.STRIP)
                        ok = (pos >= lo) & (pos < cached)
                        read = ok | torch.tensor(fault == "dead_rows_read")
                        page = (pos // bs).clamp(max=bt.shape[1] - 1)
                        slots = torch.where(read, bt[row, page].long() * bs + pos % bs, 0)
                        kf = torch.where(read[:, None], k_cache[slots][:, cols].float(), 0.0)
                        vf = torch.where(read[:, None], v_cache[slots][:, cols].float(), 0.0)
                        ks = vs = torch.ones(td.STRIP)
                        if k_scale is not None:
                            ks = torch.where(read, k_scale[slots, kvh].float(), 0.0)
                            vs = torch.where(read, v_scale[slots, kvh].float(), 0.0)
                        c = kf @ qg.T
                        if fault == "second_tile_left_out":
                            c[:, td.N8:] = 0.0
                        s = log2_score(c * ks[:, None])  # S^T: tokens x heads
                        s = torch.where(ok[:, None], s, torch.full((), NEG))
                        mx = s.max(dim=0).values
                        m_new = torch.maximum(m, mx)
                        alpha = torch.exp2(m - m_new)
                        m = m_new
                        p = torch.where(ok[:, None], torch.exp2(s - m[None, :]), 0.0)
                        if fault == "v_scale_before_l":
                            p = p * vs[:, None]
                        l = l * alpha + p.sum(dim=0)
                        o = o * alpha[:, None]
                        small = bool((torch.exp2(mx - m) * LO_RATIO >= l)[:g].any())
                        if fault != "v_scale_before_l":
                            p = p * vs[:, None]
                        hi = _bf16(p)
                        o = o + hi.T @ vf
                        if small and fault != "no_remainder":
                            o = o + _bf16(p - hi).T @ vf
                    ms.append(m), ls.append(l), os_.append(o)
                # the block's merge: its warps, and the current token in the last split
                M = torch.stack(ms).max(dim=0).values
                fold = has_cur and split == splits - 1 and kv_len > 0
                if fold:
                    sc = log2_score((qg * cur_k[row, cols].float()[None, :]).sum(dim=1))
                    M = torch.maximum(M, sc)
                w = [torch.exp2(mw - M) for mw in ms]
                L = sum(lw * ww for lw, ww in zip(ls, w))
                O = sum(ow * ww[:, None] for ow, ww in zip(os_, w))
                if fold:
                    pc = torch.exp2(sc - M)
                    L = L + pc
                    O = O + pc[:, None] * cur_v[row, cols].float()[None, :]
                parts.append((M, L, O))
            # the split merge (the second kernel; an identity for one split)
            M = torch.stack([pm for pm, _, _ in parts]).max(dim=0).values
            L = sum(pl * torch.exp2(pm - M) for pm, pl, _ in parts)
            O = sum(po * torch.exp2(pm - M)[:, None] for pm, _, po in parts)
            inv = torch.where((L > 0) & (kv_len > 0), 1.0 / L.clamp_min(1e-38), 0.0)
            out[row, kvh * g:(kvh + 1) * g] = (O * inv[:, None])[:g].to(torch.bfloat16)
    return out


def _check(got, want):
    gf, w = got.float(), want.float()
    diff = gf - w
    dn, wn = diff.norm(dim=-1), w.norm(dim=-1)
    rel = torch.where(wn > 0, dn / wn.clamp_min(1e-30),
                      torch.where(dn > 0, torch.full((), float("inf")), torch.zeros(())))
    ok = (bool(torch.isfinite(gf).all()) and float(rel.max()) <= REL_L2
          and not bool((diff.abs() > ATOL + RTOL * w.abs()).any()))
    return ok, float(diff.abs().max()), float(rel.max())


LENS = [0, 1, 2, 17, 63, 64, 65, 150]


def _case(seed, lens, hq, hkv, bs, extra_blocks=1, d=D):
    """bf16-representable q, pool and current token from a numpy seed;
    distinct blocks per row, the table one block wider than the deepest row."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    mb = -(-max(max(lens), 1) // bs) + extra_blocks
    nb = b * mb + 2
    f = lambda *shape: _bf16(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    q = f(b, hq, d).to(torch.bfloat16)
    k, v = f(nb * bs, hkv * d), f(nb * bs, hkv * d)
    ck, cv = f(b, hkv * d).to(torch.bfloat16), f(b, hkv * d).to(torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(np.arange(1, nb))[: b * mb].reshape(b, mb)
                          .astype(np.int32))
    return q, k, v, ck, cv, bt, torch.tensor(lens, dtype=torch.int32)


def _live_slots(bt, lens, bs, ns):
    live = torch.zeros(ns, dtype=torch.bool)
    for r, n in enumerate(lens.tolist()):
        pos = torch.arange(n)
        live[bt[r, pos // bs].long() * bs + pos % bs] = True
    return live


def _quantize(k, hkv, d=D):
    f = k.view(-1, hkv, d)
    s = (f.abs().amax(dim=-1) / 127.0).clamp_min(1e-8).to(torch.bfloat16)
    q8 = torch.round(f / s.float()[..., None]).clamp(-127, 127).to(torch.int8)
    return q8.view(k.shape), s


def _pools(pool, k, v, live, hkv, d=D):
    """(k, v, scales for the plain version, the same pool as the emulation
    reads it: every slot no live token maps to NaN, or its int8 scales)."""
    nan = float("nan")
    if pool == "int8":
        k8, ks = _quantize(k, hkv, d)
        v8, vs = _quantize(v, hkv, d)
        poison = lambda s: torch.where(live[:, None], s, torch.full_like(s, nan))
        return k8, v8, dict(k_scale=ks, v_scale=vs), (
            k8, v8, dict(k_scale=poison(ks), v_scale=poison(vs)))
    if pool == "e4m3":
        k, v = k.to(FP8), v.to(FP8)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    poison = lambda c: torch.where(live[:, None], c.float(), torch.full((), nan)).to(c.dtype)
    return k, v, {}, (poison(k), poison(v), {})


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("cur", [False, True], ids=["in_pool", "cur_token"])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("g", [1, 4, 7, 8])
@pytest.mark.parametrize("pool", ["bf16", "int8", "e4m3"])
def test_emulation_matches_plain_version(pool, g, window, cur, bs, splits):
    hkv = 2
    q, k, v, ck, cv, bt, lens = _case(g * 7 + bs + splits, LENS, g * hkv, hkv, bs)
    live = _live_slots(bt, lens, bs, k.shape[0])
    k, v, sc, (kp, vp, scp) = _pools(pool, k, v, live, hkv)
    kw = dict(sliding_window=window, cur_k=ck if cur else None, cur_v=cv if cur else None)
    sm = D ** -0.5
    want = td.paged_decode_ref(q, k, v, bt, lens, sm, bs, **kw, **sc)
    got = emulate_decode(q, kp, vp, bt, lens, sm, bs, window, kw["cur_k"], kw["cur_v"],
                         splits=splits, **scp)
    ok, err, rel = _check(got, want)
    assert ok, (pool, g, window, cur, bs, splits, err, rel)
    assert (got[lens == 0] == 0).all()  # an empty row is exact zeros


def _j_bf16(x):
    return jnp.asarray(x.view(torch.int16).numpy().view(ml_dtypes.bfloat16))


@pytest.mark.parametrize("cur,window,g", [(False, 0, 4), (True, 40, 7), (True, 0, 8)],
                         ids=["in_pool_g4", "cur_token_window_g7", "cur_token_g8"])
def test_emulation_matches_jax_pallas_decode(monkeypatch, cur, window, g):
    """The JAX Pallas decode kernel in interpret mode (whole-row path) on a
    float pool of bf16-representable values."""
    import rtp_llm_tpu.ops.attention.pallas_decode as pd

    monkeypatch.setattr(pd, "fullrow_max_tokens", lambda: 2048)
    hkv, bs = 2, 16
    lens = [2, 17, 70]
    q, k, v, ck, cv, bt, lens_t = _case(31 + g, lens, g * hkv, hkv, bs)
    sm = D ** -0.5
    jkw = dict(cur_k=jnp.asarray(ck.float().numpy()), cur_v=jnp.asarray(cv.float().numpy())) \
        if cur else {}
    want = pd.paged_decode_attention(
        jnp.asarray(q.float().numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(bt.numpy()), jnp.asarray(lens_t.numpy()), sm, block_size=bs,
        sliding_window=window, interpret=True, **jkw)
    got = emulate_decode(q, k.to(torch.bfloat16), v.to(torch.bfloat16), bt, lens_t, sm, bs,
                         window, ck if cur else None, cv if cur else None, splits=2)
    ok, err, rel = _check(got, torch.from_numpy(np.asarray(want, dtype=np.float32)))
    assert ok, (err, rel)


@pytest.mark.parametrize("cur", [False, True], ids=["in_pool", "cur_token"])
def test_emulation_matches_jax_pallas_quant_kernel(monkeypatch, cur):
    """The JAX Pallas decode kernel's ``quant`` mode in interpret mode, its
    scales gathered as the JAX package gathers them (2e-2: its dots run in
    bf16), and JAX ``paged_attention_ref`` with scales (the card's check)."""
    import rtp_llm_tpu.ops.attention.pallas_decode as pd

    monkeypatch.setattr(pd, "fullrow_max_tokens", lambda: 2048)
    hkv, g, bs = 2, 4, 16
    lens = [3, 17, 64, 96]
    q, k, v, ck, cv, bt, lens_t = _case(41, lens, g * hkv, hkv, bs)
    k8, ks = _quantize(k, hkv)
    v8, vs = _quantize(v, hkv)
    sm = D ** -0.5
    jb = lambda t: jnp.asarray(t.float().numpy())
    jkw = dict(cur_k=jb(ck), cur_v=jb(cv)) if cur else {}
    ks_e, vs_e = _expand_kv_scales(_j_bf16(ks), _j_bf16(vs), jnp.asarray(bt.numpy()), bs,
                                   g * hkv, hkv)
    want_pallas = pd.paged_decode_attention(
        jb(q), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray(lens_t.numpy()), sm, block_size=bs, interpret=True, k_scale_e=ks_e,
        v_scale_e=vs_e, **jkw)
    offs = (lens_t - 1).clamp_min(0)
    want_ref = j_ref(jb(q)[:, None], jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
                     jnp.asarray(bt.numpy()), jnp.asarray(lens_t.numpy()),
                     jnp.asarray(offs.numpy()), sm, block_size=bs, k_scale=_j_bf16(ks),
                     v_scale=_j_bf16(vs), **jkw)[:, 0]
    got = emulate_decode(q, k8, v8, bt, lens_t, sm, bs, 0, ck if cur else None,
                         cv if cur else None, k_scale=ks, v_scale=vs, splits=2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want_pallas, np.float32),
                               rtol=2e-2, atol=2e-2)
    ok, err, rel = _check(got, torch.from_numpy(np.asarray(want_ref, np.float32)))
    assert ok, (err, rel)


def test_emulation_matches_jax_on_an_e4m3_pool():
    hkv, g, bs = 2, 7, 64
    lens = [1, 2, 65, 150, 0]
    q, k, v, ck, cv, bt, lens_t = _case(43, lens, g * hkv, hkv, bs)
    k8, v8 = k.to(FP8), v.to(FP8)
    as_j = lambda x: jnp.asarray(x.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))
    sm = D ** -0.5
    offs = (lens_t - 1).clamp_min(0)
    want = j_ref(jnp.asarray(q.float().numpy())[:, None], as_j(k8), as_j(v8),
                 jnp.asarray(bt.numpy()), jnp.asarray(lens_t.numpy()),
                 jnp.asarray(offs.numpy()), sm, block_size=bs, sliding_window=40)[:, 0]
    got = emulate_decode(q, k8, v8, bt, lens_t, sm, bs, 40, splits=3)
    ok, err, rel = _check(got, torch.from_numpy(np.asarray(want, np.float32)))
    assert ok, (err, rel)


def few_cancelling_keys(seed, rows=8, hq=8, hkv=2, bs=16):
    """Rows of two keys whose scores nearly tie (the second key is the first
    plus 5% noise) and whose V rows nearly cancel (v2 = -0.95 v1): each
    output is a small difference of two large terms, so P rounded to bf16
    without its remainder (up to 2**-9 absolute) moves it by up to a few
    1e-2 relative, while P as two bf16 terms stays within 1e-4."""
    q, k, v, ck, cv, bt, lens = _case(seed, [2] * rows, hq, hkv, bs)
    rng = np.random.default_rng(seed + 1)
    for r in range(rows):
        s0, s1 = int(bt[r, 0]) * bs, int(bt[r, 0]) * bs + 1
        noise = torch.from_numpy(rng.standard_normal(hkv * D).astype(np.float32))
        k[s1] = _bf16(k[s0] + 0.05 * noise)
        v[s0] = v[s0] * 4
        v[s1] = _bf16(-0.95 * v[s0])
    return q, k.to(torch.bfloat16), v.to(torch.bfloat16), bt, lens


@pytest.mark.parametrize("fault", ["no_remainder", "dead_rows_read", "v_scale_before_l"])
def test_emulation_catches_a_planted_fault(fault):
    """Each planted fault fails the check its right counterpart passes: the
    remainder left out on rows of two cancelling keys; dead rows read from a
    pool that holds NaN there; the int8 V scale folded in before the
    normaliser."""
    sm, bs, hkv = D ** -0.5, 16, 2
    if fault == "no_remainder":
        q, k, v, bt, lens = few_cancelling_keys(5)
        want = td.paged_decode_ref(q, k, v, bt, lens, sm, bs)
        kw = {}
    else:
        q, k, v, ck, cv, bt, lens = _case(6, LENS, 8, hkv, bs)
        live = _live_slots(bt, lens, bs, k.shape[0])
        pool = "bf16" if fault == "dead_rows_read" else "int8"
        k, v, sc, (kp, vp, scp) = _pools(pool, k, v, live, hkv)
        want = td.paged_decode_ref(q, k, v, bt, lens, sm, bs, **sc)
        k, v, kw = kp, vp, scp
    right = emulate_decode(q, k, v, bt, lens, sm, bs, **kw)
    assert _check(right, want)[0]
    wrong = emulate_decode(q, k, v, bt, lens, sm, bs, fault=fault, **kw)
    assert not _check(wrong, want)[0], fault


# ---------------------------------------------------------------- head_dim 256, soft-cap


@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_ring_and_blocks_per_multiprocessor_at_every_head_dim(d):
    """The Python mirror of ``Ring<E, D>``: a block's shared memory fits
    the 227 KB a block may take, the blocks a multiprocessor holds fit its
    228 KB (1 KB reserved each), and the caps hold up to D 128; at D 256 a
    bf16 block is alone on its multiprocessor (three 16 KB stages a warp,
    192 KB) and a 1-byte one has a neighbour."""
    for elem, scaled in ((2, False), (1, True), (1, False)):
        smem = td.ring_bytes(elem, d, scaled)
        blocks = td.blocks_per_sm(elem, d, scaled)
        assert smem <= 232448 and blocks * (smem + td.BLOCK_RESERVED) <= td.SM_SMEM
        assert blocks == (td.BLOCKS_PER_SM[elem] if d <= 128 else {2: 1, 1: 2}[elem])
    assert td.ring_bytes(2, 256) == 4 * 3 * 2 * 16 * 512 + 128
    assert td.ring_bytes(1, 256, scaled=True) == 4 * (2 * 2 * 16 * 256 + 16 * 512 + 512) + 128
    assert td.ring_bytes(2, 128) == 4 * 3 * 2 * 16 * 256 + 128  # D 128 as before: 96 KB


def test_split_plan_at_gemma2_heads():
    """Gemma-2-9B's heads (16 / 8, D 256): a block a multiprocessor halves
    the splits a bf16 row takes beside D 128 (8 rows x 8192 tokens: 2, not
    4); 64 rows of 2048 fill the card unsplit."""
    assert td.num_splits(8, 8, 128, 64, 132, 2, 256) == 2
    assert td.num_splits(8, 8, 128, 64, 132, 2, 128) == 4
    assert td.num_splits(8, 8, 128, 64, 132, 1, 256) == 4
    assert td.num_splits(64, 8, 32, 64, 132, 2, 256) == 1


def test_check_head_takes_256_and_refuses_other_widths():
    for hq, hkv in ((16, 8), (16, 16), (16, 2)):
        td.check_head(256, hq, hkv, "paged_decode")
    for d in (32, 160, 192, 512):
        with pytest.raises(NotImplementedError, match="64, 80, 96, 128, 256"):
            td.check_head(d, 16, 8, "paged_decode")


CAP = 5.0  # the chip's check: q scaled by 4 so that scores reach several caps


@pytest.mark.parametrize("d,g,pool,cur,window", [
    (128, 2, "bf16", True, 40), (256, 2, "bf16", False, 0), (256, 1, "int8", True, 40),
    (256, 8, "e4m3", True, 0)], ids=["d128_g2_bf16", "d256_g2_bf16", "d256_g1_int8",
                                     "d256_g8_e4m3"])
def test_soft_capped_emulation_matches_jax_and_plain(d, g, pool, cur, window):
    """The kernel's capped arithmetic (tanh in f32, then the exp2 domain;
    the int8 K scale inside it; the current token capped too) against the
    JAX ``paged_attention_ref`` with ``soft_cap`` and the port's plain
    version; the same emulation without the tanh fails the check."""
    hkv, bs = 2, 16
    q, k, v, ck, cv, bt, lens = _case(50 + d + g, [1, 17, 65, 150, 0], g * hkv, hkv, bs, d=d)
    q = (q.float() * 4).to(torch.bfloat16)
    live = _live_slots(bt, lens, bs, k.shape[0])
    k, v, sc, (kp, vp, scp) = _pools(pool, k, v, live, hkv, d)
    sm = d ** -0.5
    kw = dict(cur_k=ck if cur else None, cur_v=cv if cur else None)
    want = td.paged_decode_ref(q, k, v, bt, lens, sm, bs, window, soft_cap=CAP, **kw, **sc)
    got = emulate_decode(q, kp, vp, bt, lens, sm, bs, window, splits=2, soft_cap=CAP, **kw,
                         **scp)
    ok, err, rel = _check(got, want)
    assert ok, (err, rel)
    as_j = {"bf16": lambda x: _j_bf16(x), "int8": lambda x: jnp.asarray(x.numpy()),
            "e4m3": lambda x: jnp.asarray(x.view(torch.uint8).numpy()
                                          .view(ml_dtypes.float8_e4m3fn))}[pool]
    jkw = {n: _j_bf16(t) for n, t in sc.items()}
    if cur:
        jkw.update(cur_k=_j_bf16(ck), cur_v=_j_bf16(cv))
    offs = (lens - 1).clamp_min(0)
    jwant = j_ref(_j_bf16(q)[:, None], as_j(k), as_j(v), jnp.asarray(bt.numpy()),
                  jnp.asarray(lens.numpy()), jnp.asarray(offs.numpy()), sm, block_size=bs,
                  sliding_window=window, soft_cap=CAP, **jkw)[:, 0]
    ok, err, rel = _check(got, torch.from_numpy(np.asarray(jwant, np.float32)))
    assert ok, (err, rel)
    wrong = emulate_decode(q, kp, vp, bt, lens, sm, bs, window, splits=2, soft_cap=CAP,
                           fault="no_tanh", **kw, **scp)
    assert not _check(wrong, want)[0]


# ---------------------------------------------------------------- groups of 9-16 heads


@pytest.mark.parametrize("window,cur", [(0, False), (40, True)], ids=["in_pool", "cur_window"])
@pytest.mark.parametrize("g", [9, 12, 16])
@pytest.mark.parametrize("pool", ["bf16", "int8", "e4m3"])
def test_two_head_tile_emulation_matches_plain_version(pool, g, window, cur):
    """StarCoder2's G 9, Command R+'s G 12 and G 16 (two n8 tiles, the
    second 1, 4 or 8 heads live) against the plain version, split over KV."""
    hkv, bs = 2, 16
    q, k, v, ck, cv, bt, lens = _case(70 + g, LENS, g * hkv, hkv, bs)
    live = _live_slots(bt, lens, bs, k.shape[0])
    k, v, sc, (kp, vp, scp) = _pools(pool, k, v, live, hkv)
    kw = dict(sliding_window=window, cur_k=ck if cur else None, cur_v=cv if cur else None)
    sm = D ** -0.5
    want = td.paged_decode_ref(q, k, v, bt, lens, sm, bs, **kw, **sc)
    got = emulate_decode(q, kp, vp, bt, lens, sm, bs, window, kw["cur_k"], kw["cur_v"],
                         splits=3, **scp)
    ok, err, rel = _check(got, want)
    assert ok, (pool, g, window, cur, err, rel)
    assert (got[lens == 0] == 0).all()


@pytest.mark.parametrize("g", [9, 12, 16])
def test_two_head_tile_emulation_matches_jax_pallas_decode(monkeypatch, g):
    """The JAX Pallas decode kernel in interpret mode (it zero-expands the
    query over the kv heads, any G) at the new groups, current token
    deferred; the second tile left out fails the same check."""
    import rtp_llm_tpu.ops.attention.pallas_decode as pd

    monkeypatch.setattr(pd, "fullrow_max_tokens", lambda: 2048)
    hkv, bs = 2, 16
    lens = [2, 17, 70]
    q, k, v, ck, cv, bt, lens_t = _case(90 + g, lens, g * hkv, hkv, bs)
    sm = D ** -0.5
    jb = lambda t: jnp.asarray(t.float().numpy())
    want = pd.paged_decode_attention(
        jb(q), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray(lens_t.numpy()), sm, block_size=bs, interpret=True, cur_k=jb(ck),
        cur_v=jb(cv))
    want = torch.from_numpy(np.asarray(want, dtype=np.float32))
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    got = emulate_decode(q, kb, vb, bt, lens_t, sm, bs, 0, ck, cv, splits=2)
    ok, err, rel = _check(got, want)
    assert ok, (err, rel)
    wrong = emulate_decode(q, kb, vb, bt, lens_t, sm, bs, 0, ck, cv, splits=2,
                           fault="second_tile_left_out")
    assert not _check(wrong, want)[0]


def test_group_plan_and_limits():
    """Two head tiles: at most two blocks a multiprocessor (a 1-byte pool's
    four would leave a thread 128 registers for twice the state), so a
    1-byte pool's splits halve at G > 8; G 128 is the largest group at D 64
    and D 128 (in chunks of 16 past 16), 8 at the other widths."""
    assert [td.head_tiles(g) for g in (1, 8, 9, 12, 16, 17, 71)] == [1, 1, 2, 2, 2, 2, 2]
    assert td.blocks_per_sm(1, 128, True, tiles=2) == 2 and td.blocks_per_sm(2, 128, tiles=2) == 2
    assert td.num_splits(8, 4, 128, 64, 132, 1, 128, 9) == td.num_splits(8, 4, 128, 64, 132, 1) // 2
    assert td.num_splits(8, 4, 128, 64, 132, 2, 128, 9) == td.num_splits(8, 4, 128, 64, 132, 2)
    for g in (9, 12, 16, 17, 48, 71, 128):
        td.check_head(128, g * 4, 4, "paged_decode")
        td.check_head(64, g * 2, 2, "paged_decode")
    for d in (64, 128):
        with pytest.raises(NotImplementedError, match="<= 128"):
            td.check_head(d, 129 * 2, 2, "paged_decode")
    for d in (96, 256):
        with pytest.raises(NotImplementedError, match="<= 8"):
            td.check_head(d, 9 * 2, 2, "paged_decode")


# ---------------------------------------------------------------- head_dim 80 (Phi-2)


@pytest.mark.parametrize("cur", [False, True], ids=["in_pool", "cur_token"])
@pytest.mark.parametrize("pool", ["bf16", "int8", "e4m3"])
def test_d80_emulation_matches_plain_and_jax(pool, cur):
    """Phi-2's width (MHA, G 1; G 8 too): a bf16 ring row is ten 16-byte
    chunks in a 256-byte pitch, a 1-byte one five in 128 (a strip's 80
    chunks deal unevenly over 32 lanes), S five k16 steps, P V five m16
    tiles. The warp-by-warp arithmetic at D 80 on a pool whose dead slots
    hold NaN, split over KV, against the port's plain version and the JAX
    package's plain path (its dispatch serves D 80 there); the two plain
    versions against each other. The ring's shared memory and blocks a
    multiprocessor are D 96's."""
    d, hkv, bs = 80, 2, 16
    assert td.ring_bytes(2, d) == td.ring_bytes(2, 96) and td.blocks_per_sm(1, d, True) == 4
    for g in (1, 8):
        q, k, v, ck, cv, bt, lens = _case(80 + g, LENS, g * hkv, hkv, bs, d=d)
        live = _live_slots(bt, lens, bs, k.shape[0])
        k, v, sc, (kp, vp, scp) = _pools(pool, k, v, live, hkv, d)
        sm = d ** -0.5
        kw = dict(cur_k=ck if cur else None, cur_v=cv if cur else None)
        want = td.paged_decode_ref(q, k, v, bt, lens, sm, bs, 40, **kw, **sc)
        got = emulate_decode(q, kp, vp, bt, lens, sm, bs, 40, splits=3, **kw, **scp)
        ok, err, rel = _check(got, want)
        assert ok and (got[lens == 0] == 0).all(), (g, err, rel)
        as_j = {"bf16": _j_bf16, "int8": lambda x: jnp.asarray(x.numpy()),
                "e4m3": lambda x: jnp.asarray(x.view(torch.uint8).numpy()
                                              .view(ml_dtypes.float8_e4m3fn))}[pool]
        jkw = {n: _j_bf16(t) for n, t in sc.items()}
        if cur:
            jkw.update(cur_k=_j_bf16(ck), cur_v=_j_bf16(cv))
        offs = (lens - 1).clamp_min(0)
        jwant = j_ref(_j_bf16(q)[:, None], as_j(k), as_j(v), jnp.asarray(bt.numpy()),
                      jnp.asarray(lens.numpy()), jnp.asarray(offs.numpy()), sm, block_size=bs,
                      sliding_window=40, **jkw)[:, 0]
        jwant = torch.from_numpy(np.asarray(jwant, np.float32))
        jwant[lens == 0] = 0  # an empty row: zeros, as the kernel writes them
        for mine in (got, want):
            ok, err, rel = _check(mine, jwant)
            assert ok, (g, err, rel)
