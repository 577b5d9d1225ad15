"""The tiling of the prefill attention kernel (``csrc/paged_prefill.cu``).

The kernel itself runs only on the card. What the CPU can hold:

(a) the host-side planner in ``ops/attention/prefill.py`` (rows a block,
    tokens a block, key tile, grid, the live-tile rule, the row -> (token,
    head) map): every live (token, head) is covered exactly once, no dead
    tile is scheduled, and the key tiles of a query tile cover every key its
    tokens may see;
(b) a blocked emulation in plain PyTorch of the kernel's arithmetic (64-key
    tiles walked as the planner says, f32 scores from bf16 operands, online
    softmax in f32 in the exp2 domain, P rounded to bf16 before ``P V`` with
    the rounding remainder added while a row's sum is small, K scale on the
    score, V scale after the normaliser took p, dead tiles skipped, padded
    rows zero), held against the port's plain version ``paged_prefill_ref``
    and against the JAX package on the same numpy-seeded inputs: the Pallas
    kernel in interpret mode for a float pool, and ``paged_attention_ref``
    for int8 / fp8 pools (the JAX package reads a quantized pool at prefill
    through that plain path).

Tolerance of (b): the one the card's check uses (``chip_smoke.py`` ATOL,
RTOL, REL_L2): every element within 2e-3 + 1e-2 * |want| and every (token,
head) vector within 1e-2 relative L2. Both sides round their output to bf16
(one ulp is 2**-8 relative, which RTOL spans) and sum in different orders;
a key tile read from the wrong block or a scale on the wrong side of the
normaliser moves a row by several 1e-2 and more.
"""

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rtp_llm_tpu.ops.attention import paged_attention_ref as j_ref
from rtp_llm_tpu.ops.attention.pallas_prefill import paged_prefill_attention as j_prefill
from rtp_llm_tpu_torch.ops.attention import prefill as tp

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

ATOL, RTOL, REL_L2 = 2e-3, 1e-2, 1e-2
LO_RATIO = 64.0  # csrc/paged_prefill.cu: when the remainder product is dropped
NEG = -1e30
FP8 = torch.float8_e4m3fn


# ---------------------------------------------------------------- (a) planner


def _tq(g):
    return tp.BLOCK_ROWS // g


GROUPS = [*range(1, 9), 9, 12, 16]  # 9-16: D 128's two-tile groups (StarCoder2, Command R+)


@pytest.mark.parametrize("g", GROUPS)
def test_row_map_is_a_bijection_onto_tokens_times_heads(g):
    plan = tp.tile_plan(1, 2048, 4 * g, 4)
    assert plan.group == g and plan.tokens == 128 // g and plan.rows == plan.tokens * g
    assert plan.rows <= tp.BLOCK_ROWS and tp.BLOCK_ROWS - plan.rows < g
    pairs = [tp.row_token_head(plan, r) for r in range(tp.BLOCK_ROWS)]
    live = [p for p in pairs if p is not None]
    assert pairs[plan.rows:] == [None] * (tp.BLOCK_ROWS - plan.rows)
    assert sorted(live) == [(t, h) for t in range(plan.tokens) for h in range(g)]
    # a token's heads are neighbouring rows: one K/V tile serves all of them
    assert all(live[r] == (r // g, r % g) for r in range(plan.rows))
    assert plan.smem_bytes == 161 * 1024 < 227 * 1024  # one block a multiprocessor


def _t_values(g):
    tq = _tq(g)
    return sorted({tq - 1, tq, tq + 1, 100, 2048})


@pytest.mark.parametrize("window", [0, 70])
@pytest.mark.parametrize("case", ["no_prefix", "prefix", "len_inside_tile", "len_at_tile",
                                  "all_padding"])
@pytest.mark.parametrize("g", GROUPS)
def test_planner_covers_live_work_once_and_schedules_no_dead_tile(g, case, window):
    for t in _t_values(g):
        tq = _tq(g)
        off, kv_len = {
            "no_prefix": (0, t),
            "prefix": (1000, 1000 + t),
            "len_inside_tile": (37, 37 + max(1, min(t, tq + tq // 2))),  # tail rows padded
            "len_at_tile": (37, 37 + min(t, tq)),  # kv_len exactly at a tile's first token
            "all_padding": (50, 50),  # kv_len <= q_offset: the row is padding
        }[case]
        plan = tp.tile_plan(3, t, 2 * g, 2)
        assert plan.grid == (-(-t // tq), 2, 3)
        covered = np.zeros((t, g), np.int32)
        for qtile in range(plan.grid[0]):
            first = qtile * tq
            toks = np.arange(first, min(first + tq, t))
            live_toks = toks[off + toks < kv_len]
            if not tp.tile_is_live(plan, qtile, off, kv_len):
                assert live_toks.size == 0  # a skipped tile holds padding only
                continue
            assert live_toks.size > 0  # no dead tile is scheduled
            for r in range(tp.BLOCK_ROWS):
                th = tp.row_token_head(plan, r)
                if th is not None and first + th[0] < t:
                    covered[first + th[0], th[1]] += 1
            tiles = tp.key_tiles(plan, qtile, t, off, kv_len, window)
            assert len(tiles) >= 1 and all(kb % plan.key_tile == 0 for kb in tiles)
            lo_key = max(0, off + int(live_toks[0]) - window + 1) if window else 0
            hi_key = min(off + int(live_toks[-1]), kv_len - 1)
            assert tiles[0] <= lo_key and tiles[-1] + plan.key_tile > hi_key  # all visible keys
            assert tiles[0] + plan.key_tile > lo_key and tiles[-1] <= hi_key  # no useless tile
        in_live_tile = np.array([tp.tile_is_live(plan, i // tq, off, kv_len) for i in range(t)])
        assert (covered[in_live_tile] == 1).all() and (covered[~in_live_tile] == 0).all()
        assert (off + np.arange(t)[~in_live_tile] >= kv_len).all()


def test_planner_rejects_groups_the_kernel_does_not_take():
    for hq, hkv in ((129, 1), (6, 4), (4, 0)):
        with pytest.raises(ValueError):
            tp.tile_plan(1, 64, hq, hkv)
    for d in (96, 256):  # groups past 8 at D 64 and D 128 only
        with pytest.raises(ValueError, match="1..8"):
            tp.tile_plan(1, 64, 9, 1, d)
    with pytest.raises(ValueError, match="1..128"):
        tp.tile_plan(1, 64, 129, 1, 64)


# ---------------------------------------------------------------- (b) emulation


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_prefill(q, k_cache, v_cache, bt, offs, lens, sm, bs, window=0,
                    k_scale=None, v_scale=None, soft_cap=0.0, no_tanh=False):
    """The kernel's arithmetic, block by block, in plain PyTorch (f32 math on
    bf16 / int8 / e4m3 operands). ``soft_cap`` > 0: scores ``cap * tanh(x *
    sm / cap) * log2 e`` (x: q . K with the K scale; ``no_tanh`` plants the
    fault of leaving the tanh out). Test support: nothing in the port calls
    it."""
    b, t, hq, d = q.shape
    hkv = k_cache.shape[1] // d
    plan = tp.tile_plan(b, t, hq, hkv, d)
    g, tq, kt = plan.group, plan.tokens, plan.key_tile
    scale_log2 = sm * 1.4426950408889634
    out = torch.zeros((b, t, hq, d), dtype=torch.bfloat16)
    tiles_walked = 0
    for row in range(b):
        off, kv_len = int(offs[row]), int(lens[row])
        for qtile in range(plan.grid[0]):
            if not tp.tile_is_live(plan, qtile, off, kv_len):
                continue  # zeros, nothing loaded
            first = qtile * tq
            ntok = min(tq, t - first)
            span = min(off + first + ntok, kv_len)
            for kvh in range(hkv):
                qt = q[row, first:first + ntok, kvh * g:(kvh + 1) * g].float().reshape(ntok * g, d)
                qpos = (off + first + torch.arange(ntok)).repeat_interleave(g)
                m = torch.full((ntok * g,), NEG)
                l = torch.zeros(ntok * g)
                o = torch.zeros((ntok * g, d))
                for kb in tp.key_tiles(plan, qtile, t, off, kv_len, window):
                    tiles_walked += 1
                    pos = kb + torch.arange(kt)
                    valid = pos < span  # rows past the span are zero-filled, never read
                    slots = (bt[row, (pos // bs).clamp(max=bt.shape[1] - 1)].long() * bs + pos % bs)
                    slots = torch.where(valid, slots, torch.zeros_like(slots))
                    cols = slice(kvh * d, (kvh + 1) * d)
                    kf = torch.where(valid[:, None], k_cache[slots][:, cols].float(), torch.zeros(()))
                    vf = torch.where(valid[:, None], v_cache[slots][:, cols].float(), torch.zeros(()))
                    s = qt @ kf.T
                    if k_scale is not None:
                        ks = torch.where(valid, k_scale[slots, kvh].float(), torch.zeros(()))
                        s = s * ks[None, :]
                    if soft_cap > 0 and not no_tanh:  # csrc/paged_prefill.cu capped_log2_score
                        s = soft_cap * 1.4426950408889634 * torch.tanh(s * (sm / soft_cap))
                    else:
                        s = s * scale_log2
                    ok = (pos[None, :] <= qpos[:, None]) & (pos[None, :] < kv_len)
                    if window > 0:
                        ok &= pos[None, :] > qpos[:, None] - window
                    s = torch.where(ok, s, torch.full((), NEG))
                    mx = s.max(dim=1).values
                    m_new = torch.maximum(m, mx)
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(s > 0.5 * NEG, torch.exp2(s - m_new[:, None]), torch.zeros(()))
                    l = l * alpha + p.sum(dim=1)
                    o = o * alpha[:, None]
                    if v_scale is not None:
                        vs = torch.where(valid, v_scale[slots, kvh].float(), torch.zeros(()))
                        p = p * vs[None, :]
                    hi = _bf16(p)
                    # a 64-row warpgroup adds the remainder while any of its rows is still "small"
                    small = torch.exp2(mx - m_new) * LO_RATIO >= l
                    warp_small = torch.zeros_like(small)
                    for w0 in range(0, ntok * g, 64):
                        warp_small[w0:w0 + 64] = small[w0:w0 + 64].any()
                    rem = torch.where(warp_small[:, None], _bf16(p - hi), torch.zeros(()))
                    o = o + hi @ vf + rem @ vf
                    m = m_new
                inv = torch.where((qpos < kv_len) & (l > 0), 1.0 / l.clamp_min(1e-38), torch.zeros(()))
                res = (o * inv[:, None]).to(torch.bfloat16).reshape(ntok, g, d)
                out[row, first:first + ntok, kvh * g:(kvh + 1) * g] = res
    return out, tiles_walked


def _check(got, want):
    g, w = got.float(), want.float()
    diff = g - w
    dn, wn = diff.norm(dim=-1), w.norm(dim=-1)
    rel = torch.where(wn > 0, dn / wn.clamp_min(1e-30),
                      torch.where(dn > 0, torch.full((), float("inf")), torch.zeros(())))
    ok = (bool(torch.isfinite(g).all()) and float(rel.max()) <= REL_L2
          and not bool((diff.abs() > ATOL + RTOL * w.abs()).any()))
    return ok, float(diff.abs().max()), float(rel.max())


def _case(seed, b, t, hq, hkv, offs, lens, bs=16, d=128):
    """bf16-representable q and float pool from a numpy seed; distinct blocks
    per row; every slot no live key maps to is poisoned with NaN."""
    rng = np.random.default_rng(seed)
    mb = -(-max(o + t for o in offs) // bs) + 1
    nb = b * mb + 2
    q = _bf16(torch.from_numpy(rng.standard_normal((b, t, hq, d)).astype(np.float32)))
    k = _bf16(torch.from_numpy(rng.standard_normal((nb * bs, hkv * d)).astype(np.float32)))
    v = _bf16(torch.from_numpy(rng.standard_normal((nb * bs, hkv * d)).astype(np.float32)))
    bt = torch.from_numpy(rng.permutation(np.arange(1, nb))[: b * mb].reshape(b, mb).astype(np.int32))
    return q, k, v, bt, torch.tensor(offs, dtype=torch.int32), torch.tensor(lens, dtype=torch.int32)


def _live_slots(bt, lens, bs, ns):
    live = torch.zeros(ns, dtype=torch.bool)
    for r, n in enumerate(lens.tolist()):
        pos = torch.arange(n)
        live[bt[r, pos // bs].long() * bs + pos % bs] = True
    return live


def _quantize(k, hkv, d):
    f = k.view(-1, hkv, d)
    s = (f.abs().amax(dim=-1) / 127.0).clamp_min(1e-8).to(torch.bfloat16)
    q8 = torch.round(f / s.float()[..., None]).clamp(-127, 127).to(torch.int8)
    return q8.view(k.shape), s


CASES = {
    # name: (b, t, hq, hkv, q_offsets, kv_lens, window)
    "g4_prefix_two_tiles": (1, 48, 8, 2, [70], [118], 0),
    "g7_ragged_t": (1, 40, 7, 1, [0], [40], 0),
    "g1_one_tile": (1, 100, 2, 2, [5], [105], 0),
    "g8_three_rows_one_padding": (3, 24, 8, 1, [0, 37, 64], [20, 61, 64], 0),
    "g4_window_inside_tile": (2, 48, 4, 1, [0, 90], [48, 130], 50),
}


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("name", list(CASES))
def test_emulation_matches_plain_version(name, pool):
    b, t, hq, hkv, offs, lens, window = CASES[name]
    q, k, v, bt, offs_t, lens_t = _case(sorted(CASES).index(name), b, t, hq, hkv, offs, lens)
    d, bs, sm = 128, 16, 128 ** -0.5
    live = _live_slots(bt, lens_t, bs, k.shape[0])
    kw, kw_poisoned = {}, {}
    if pool == "int8":
        k, ks = _quantize(k, hkv, d)
        v, vs = _quantize(v, hkv, d)
        kw = dict(k_scale=ks, v_scale=vs)
        nan = torch.full_like(ks, float("nan"))
        kw_poisoned = dict(k_scale=torch.where(live[:, None], ks, nan),
                           v_scale=torch.where(live[:, None], vs, nan))
        kp, vp = k, v
    else:
        if pool == "fp8":
            k, v = k.to(FP8), v.to(FP8)
        # dead slots hold NaN for the emulation: it must never read them
        nan_rows = torch.full((1, k.shape[1]), float("nan")).to(k.dtype)
        kp = torch.where(live[:, None], k.float(), nan_rows.float()).to(k.dtype)
        vp = torch.where(live[:, None], v.float(), nan_rows.float()).to(v.dtype)
    want = tp.paged_prefill_ref(q.to(torch.bfloat16), k, v, bt, offs_t, lens_t, sm, bs,
                                window, **kw)
    got, tiles = emulate_prefill(q.to(torch.bfloat16), kp, vp, bt, offs_t, lens_t, sm, bs,
                                 window, **kw_poisoned)
    ok, err, rel = _check(got, want)
    assert ok, (name, pool, err, rel)
    pos = offs_t[:, None] + torch.arange(t)[None, :]
    assert (got[pos >= lens_t[:, None]] == 0).all()  # padded rows are exact zeros
    assert tiles > 0


@pytest.mark.parametrize("pool", ["f32", "int8", "fp8"])
def test_emulation_matches_jax(pool):
    """Same inputs through the JAX package: the interpreted Pallas prefill
    kernel (float pool, one row, T a multiple of its tile) or its plain
    reference with scales / an fp8 pool."""
    b, t, hq, hkv, d, bs, sm = 1, 64, 8, 2, 128, 16, 128 ** -0.5
    offs, lens = [37], [101]
    q, k, v, bt, offs_t, lens_t = _case(7, b, t, hq, hkv, offs, lens)
    jq = jnp.asarray(q.numpy())
    if pool == "f32":
        want = j_prefill(jq[0], jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                         jnp.asarray(bt.numpy()[0]), jnp.int32(offs[0]), jnp.int32(lens[0]),
                         sm, bs, interpret=True)[None]
        kw = {}
    elif pool == "int8":
        k, ks = _quantize(k, hkv, d)
        v, vs = _quantize(v, hkv, d)
        kw = dict(k_scale=ks, v_scale=vs)
        as_j = lambda s: jnp.asarray(s.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        want = j_ref(jq, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), jnp.asarray(bt.numpy()),
                     jnp.asarray(lens_t.numpy()), jnp.asarray(offs_t.numpy()), sm, block_size=bs,
                     k_scale=as_j(ks), v_scale=as_j(vs))
    else:
        k, v = k.to(FP8), v.to(FP8)
        kw = {}
        as_j = lambda x: jnp.asarray(x.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))
        want = j_ref(jq, as_j(k), as_j(v), jnp.asarray(bt.numpy()), jnp.asarray(lens_t.numpy()),
                     jnp.asarray(offs_t.numpy()), sm, block_size=bs)
    got, _ = emulate_prefill(q.to(torch.bfloat16), k, v, bt, offs_t, lens_t, sm, bs, 0, **kw)
    want = torch.from_numpy(np.asarray(want, dtype=np.float32))
    ok, err, rel = _check(got, want)
    assert ok, (pool, err, rel)


def test_emulation_skips_dead_tiles_and_catches_a_planted_fault():
    """A bucket tail: T = 96 at G = 4 is three query tiles, kv_len ends in
    the first, so two tiles are never walked. And the check tells a wrong
    kernel from a right one: the V scale folded in before the normaliser."""
    b, t, hq, hkv, d, bs, sm = 1, 96, 4, 1, 128, 16, 128 ** -0.5
    q, k, v, bt, offs_t, lens_t = _case(3, b, t, hq, hkv, [0], [30])
    got, tiles = emulate_prefill(q.to(torch.bfloat16), k, v, bt, offs_t, lens_t, sm, bs)
    assert tiles == 1 and (got[0, 30:] == 0).all()
    k8, ks = _quantize(k, hkv, d)
    v8, vs = _quantize(v, hkv, d)
    want = tp.paged_prefill_ref(q.to(torch.bfloat16), k8, v8, bt, offs_t, lens_t, sm, bs, 0,
                                k_scale=ks, v_scale=vs)
    right, _ = emulate_prefill(q.to(torch.bfloat16), k8, v8, bt, offs_t, lens_t, sm, bs, 0,
                               k_scale=ks, v_scale=vs)
    assert _check(right, want)[0]
    wrong, _ = emulate_prefill(q.to(torch.bfloat16), k8, v8, bt, offs_t, lens_t, sm, bs, 0,
                               k_scale=ks, v_scale=torch.ones_like(vs))
    assert not _check(wrong, want)[0]


# ---------------------------------------------------------------- head_dim 256, soft-cap


def test_tile_plan_at_head_dim_256():
    """D 256: Q 64 KB, K and V tiles 32 KB each, two ring stages (four would
    need 320 KB): 193 KB a block, within the 227 KB it may take; the row
    map at every group; other widths refused."""
    assert tp.ring_stages(256) == 2 and all(tp.ring_stages(d) == 4 for d in (64, 96, 128))
    assert tp.staged_dims(256) == 256
    for g in range(1, 9):
        plan = tp.tile_plan(1, 2048, 2 * g, 2, 256)
        assert plan.smem_bytes == 128 * 512 + 2 * 2 * 64 * 512 + 1024 == 197632
        assert plan.smem_bytes <= 232448 and plan.rows == (128 // g) * g
    for d in (160, 192, 512):
        with pytest.raises(ValueError, match="head_dim"):
            tp.tile_plan(1, 64, 8, 8, d)


CAP = 5.0  # the chip's check: q scaled by 4 so that scores reach several caps


@pytest.mark.parametrize("d,pool,name", [(128, "bf16", "g4_window_inside_tile"),
                                         (256, "bf16", "g4_prefix_two_tiles"),
                                         (256, "int8", "g8_three_rows_one_padding"),
                                         (256, "fp8", "g1_one_tile")])
def test_soft_capped_emulation_matches_jax_and_plain(d, pool, name):
    """The capped tile arithmetic against the JAX ``paged_attention_ref``
    with ``soft_cap`` and the port's plain version, at D 128 and 256 on each
    pool; without the tanh it fails the check."""
    b, t, hq, hkv, offs, lens, window = CASES[name]
    q, k, v, bt, offs_t, lens_t = _case(60 + d, b, t, hq, hkv, offs, lens, d=d)
    q = _bf16(q * 4).to(torch.bfloat16)
    bs, sm = 16, d ** -0.5
    kw, jkw = {}, {}
    as_j = lambda x: jnp.asarray(x.numpy())
    if pool == "int8":
        k, ks = _quantize(k, hkv, d)
        v, vs = _quantize(v, hkv, d)
        kw = dict(k_scale=ks, v_scale=vs)
        jb = lambda s: jnp.asarray(s.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        jkw = dict(k_scale=jb(ks), v_scale=jb(vs))
    elif pool == "fp8":
        k, v = k.to(FP8), v.to(FP8)
        as_j = lambda x: jnp.asarray(x.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))
    want = tp.paged_prefill_ref(q, k, v, bt, offs_t, lens_t, sm, bs, window, soft_cap=CAP, **kw)
    got, _ = emulate_prefill(q, k, v, bt, offs_t, lens_t, sm, bs, window, soft_cap=CAP, **kw)
    ok, err, rel = _check(got, want)
    assert ok, (err, rel)
    jwant = j_ref(jnp.asarray(q.float().numpy()), as_j(k), as_j(v), jnp.asarray(bt.numpy()),
                  jnp.asarray(lens_t.numpy()), jnp.asarray(offs_t.numpy()), sm, block_size=bs,
                  sliding_window=window, soft_cap=CAP, **jkw)
    pos = offs_t[:, None] + torch.arange(t)[None, :]
    jwant = torch.tensor(np.asarray(jwant, np.float32))
    jwant[pos >= lens_t[:, None]] = 0  # padded rows: zeros, as the kernel writes them
    ok, err, rel = _check(got, jwant)
    assert ok, (err, rel)
    wrong, _ = emulate_prefill(q, k, v, bt, offs_t, lens_t, sm, bs, window, soft_cap=CAP,
                               no_tanh=True, **kw)
    assert not _check(wrong, want)[0]


# ---------------------------------------------------------------- groups of 9-16 heads

GROUP_CASES = {
    # name: (b, t, hq, hkv, q_offsets, kv_lens, window): G 9 (StarCoder2), 12
    # (Command R+), 16; tiles of 14, 10 and 8 tokens
    "g9_prefix_window": (2, 40, 18, 2, [0, 70], [40, 110], 30),
    "g12_ragged_padding": (2, 33, 12, 1, [0, 5], [25, 38], 0),
    "g16_prefix": (1, 24, 32, 2, [50], [74], 0),
    "g12_verify_window": (3, 5, 24, 2, [17, 64, 100], [22, 69, 103], 0),  # T = K + 1
}


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_group_emulation_matches_plain_version(name, pool):
    """The block row map at G 9 / 12 / 16 (dead rows 2, 8, 0), the causal
    mask's token index r / G and the write-back, against the plain version;
    a speculative verify window of T 5 through the same plan."""
    b, t, hq, hkv, offs, lens, window = GROUP_CASES[name]
    q, k, v, bt, offs_t, lens_t = _case(100 + sorted(GROUP_CASES).index(name), b, t, hq, hkv,
                                        offs, lens)
    d, bs, sm = 128, 16, 128 ** -0.5
    kw = {}
    if pool == "int8":
        k, ks = _quantize(k, hkv, d)
        v, vs = _quantize(v, hkv, d)
        kw = dict(k_scale=ks, v_scale=vs)
    elif pool == "fp8":
        k, v = k.to(FP8), v.to(FP8)
    qb = q.to(torch.bfloat16)
    want = tp.paged_prefill_ref(qb, k, v, bt, offs_t, lens_t, sm, bs, window, **kw)
    got, _ = emulate_prefill(qb, k, v, bt, offs_t, lens_t, sm, bs, window, **kw)
    ok, err, rel = _check(got, want)
    assert ok, (name, pool, err, rel)


@pytest.mark.parametrize("g", [9, 12, 16])
def test_group_emulation_matches_jax(g):
    """G 9 / 12 / 16 through the JAX package's plain reference (the Pallas
    prefill kernel takes them too), behind a 37-token prefix; the rows of
    heads past the eighth staged as zeros (``-DPP_FAULT=3``) fail the same
    check."""
    b, t, hkv, d, bs, sm = 1, 40, 2, 128, 16, 128 ** -0.5
    q, k, v, bt, offs_t, lens_t = _case(110 + g, b, t, g * hkv, hkv, [37], [77])
    want = j_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                 jnp.asarray(bt.numpy()), jnp.asarray(lens_t.numpy()),
                 jnp.asarray(offs_t.numpy()), sm, block_size=bs)
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    qb = q.to(torch.bfloat16)
    got, _ = emulate_prefill(qb, k, v, bt, offs_t, lens_t, sm, bs)
    ok, err, rel = _check(got, want)
    assert ok, (g, err, rel)
    dropped = qb.clone().view(b, t, hkv, g, d)
    dropped[:, :, :, 8:] = 0  # what PP_FAULT 3 stages
    wrong, _ = emulate_prefill(dropped.view(b, t, g * hkv, d), k, v, bt, offs_t, lens_t, sm, bs)
    assert not _check(wrong, want)[0]


# ---------------------------------------------------------------- head_dim 80 (Phi-2)


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("name", ["g1_one_tile", "g4_prefix_two_tiles", "g8_three_rows_one_padding"])
def test_d80_emulation_matches_plain_and_jax(name, pool):
    """Phi-2's width: the plan stages two 64-dim halves (S over five k16
    steps, P V at N 128 of which 48 columns are dropped: 161 KB a block),
    and the tile arithmetic at D 80 on a pool whose dead slots hold NaN,
    against the port's plain version and the JAX package's plain path
    (``paged_attention_ref``: the JAX dispatch serves D 80 there); the two
    plain versions against each other."""
    d, bs = 80, 16
    sm = d ** -0.5
    plan = tp.tile_plan(1, 2048, 32, 32, d)
    assert tp.staged_dims(d) == 128 and plan.smem_bytes == 128 * 256 + 4 * 2 * 64 * 256 + 1024
    b, t, hq, hkv, offs, lens, window = CASES[name]
    q, k, v, bt, offs_t, lens_t = _case(80 + len(name), b, t, hq, hkv, offs, lens, d=d)
    q = q.to(torch.bfloat16)
    live = _live_slots(bt, lens_t, bs, k.shape[0])
    kw, kw_poisoned, jkw = {}, {}, {}
    as_j = lambda x: jnp.asarray(x.float().numpy())
    if pool == "int8":
        k, ks = _quantize(k, hkv, d)
        v, vs = _quantize(v, hkv, d)
        kw = dict(k_scale=ks, v_scale=vs)
        nan = torch.full_like(ks, float("nan"))
        kw_poisoned = dict(k_scale=torch.where(live[:, None], ks, nan),
                           v_scale=torch.where(live[:, None], vs, nan))
        kp, vp = k, v
        jb = lambda s: jnp.asarray(s.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        jkw = dict(k_scale=jb(ks), v_scale=jb(vs))
        as_j = lambda x: jnp.asarray(x.numpy())
    else:
        if pool == "fp8":
            k, v = k.to(FP8), v.to(FP8)
            as_j = lambda x: jnp.asarray(x.view(torch.uint8).numpy()
                                         .view(ml_dtypes.float8_e4m3fn))
        nan_rows = torch.full((1, k.shape[1]), float("nan"))
        kp = torch.where(live[:, None], k.float(), nan_rows).to(k.dtype)
        vp = torch.where(live[:, None], v.float(), nan_rows).to(v.dtype)
    want = tp.paged_prefill_ref(q, k, v, bt, offs_t, lens_t, sm, bs, window, **kw)
    got, tiles = emulate_prefill(q, kp, vp, bt, offs_t, lens_t, sm, bs, window, **kw_poisoned)
    ok, err, rel = _check(got, want)
    assert ok and tiles > 0, (name, pool, err, rel)
    jwant = j_ref(jnp.asarray(q.float().numpy()), as_j(k), as_j(v), jnp.asarray(bt.numpy()),
                  jnp.asarray(lens_t.numpy()), jnp.asarray(offs_t.numpy()), sm, block_size=bs,
                  sliding_window=window, **jkw)
    pos = offs_t[:, None] + torch.arange(t)[None, :]
    jwant = torch.tensor(np.asarray(jwant, np.float32))
    jwant[pos >= lens_t[:, None]] = 0  # padded rows: zeros, as the kernel writes them
    for mine in (got, want):
        ok, err, rel = _check(mine, jwant)
        assert ok, (name, pool, err, rel)
