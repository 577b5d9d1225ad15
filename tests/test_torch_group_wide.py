"""The head-chunk mode of the attention kernels (``csrc/paged_decode.cu``,
``csrc/paged_prefill.cu``): groups of 17-128 query heads a kv head at D 64
and D 128 (StarCoder's 48 on one kv head, Falcon-7B's 71), cut into chunks
of 16 heads, one block a chunk.

The kernels run only on the card. What the CPU holds:

(a) the chunk map: ``decode.head_chunks`` covers a group's heads once (G 18:
    16 + 2; 48: 3 x 16; 71: 4 x 16 + 7) and the kernels' ``blockIdx.y = kv
    head * chunks + chunk`` reaches every query head once; the decode split
    plan counts a block a chunk; each chunk's prefill plan (its own G, tokens
    and live rows, the grid of the fullest chunk) covers every (token, head)
    of a row once, a chunk's tiles past T skipped;
(b) blocked emulations of the mode: each chunk is the two-tile arithmetic of
    ``tests/test_torch_decode_tiles.py`` / ``tests/test_torch_prefill_tiles.py``
    at G' = min(16, G - 16 c) on the chunk's query heads, against the port's
    plain version (every pool type) and the JAX package's plain reference;
    the planted fault of the mode (the last chunk reads the first chunk's
    queries: ``-DPD_FAULT=8`` / ``-DPP_FAULT=5``) fails the same check.

Tolerances are those of the two files it borrows its emulations from.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtp_llm_tpu.ops.attention import paged_attention_ref as j_ref
from rtp_llm_tpu_torch.ops.attention import decode as td
from rtp_llm_tpu_torch.ops.attention import prefill as tp
from tests import test_torch_decode_tiles as dt
from tests import test_torch_prefill_tiles as pt

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

GROUPS = (18, 48, 71)
FP8 = torch.float8_e4m3fn


# ---------------------------------------------------------------- (a) the map


@pytest.mark.parametrize("g", GROUPS + (16, 128))
def test_head_chunks_reach_every_query_head_once(g):
    chunks = td.head_chunks(g)
    assert [n for _, n in chunks] == [16] * (g // 16) + ([g % 16] if g % 16 else [])
    hkv = 3
    seen = []
    for y in range(hkv * len(chunks)):  # the kernels' blockIdx.y
        kvh, c = divmod(y, len(chunks))
        h0, n = chunks[c]
        seen += [kvh * g + h0 + j for j in range(n)]
    assert sorted(seen) == list(range(hkv * g))
    assert td.head_tiles(g) == (1 if g <= 8 else 2)


def test_decode_split_plan_counts_a_block_a_chunk():
    """StarCoder at 64 rows: three chunk blocks a row, so the splits fit a
    third of the blocks one chunk would take."""
    sm = 132
    for g, chunks in ((48, 3), (71, 5), (16, 1)):
        want = max(1, min(td.blocks_per_sm(2, 128, tiles=2) * sm // (8 * chunks),
                          (2048 // td.STRIP) // td.MIN_SPLIT_STRIPS))
        assert td.num_splits(8, 1, 2048 // 64, 64, sm, 2, 128, g) == want


@pytest.mark.parametrize("g", GROUPS)
def test_prefill_chunk_plans_cover_tokens_times_heads_once(g):
    """Each chunk's plan: its G, BLOCK_ROWS // G tokens, the grid of the
    fullest chunk (G 71's last chunk: 7 heads, 18 tokens, 126 rows, tiles
    past T returning at once); over the chunks every (token, head) of a row
    is covered once."""
    t, hkv = 37, 2
    chunks = td.head_chunks(g)
    covered = np.zeros((t, g), dtype=int)
    for c, (h0, n) in enumerate(chunks):
        plan = tp.tile_plan(1, t, g * hkv, hkv, 64, chunk=c)
        assert (plan.group, plan.head0) == (n, h0)
        assert plan.tokens == tp.BLOCK_ROWS // n and plan.rows == plan.tokens * n
        assert plan.grid == (-(-t // (tp.BLOCK_ROWS // chunks[0][1])), hkv * len(chunks), 1)
        for qtile in range(plan.grid[0]):
            first = qtile * plan.tokens
            if first >= t:  # the kernel returns before any load or store
                continue
            for r in range(tp.BLOCK_ROWS):
                th = tp.row_token_head(plan, r)
                if th is not None and first + th[0] < t:
                    covered[first + th[0], h0 + th[1]] += 1
    assert (covered == 1).all()
    if g == 71:
        last = tp.tile_plan(1, t, g, 1, 64, chunk=4)
        assert (last.group, last.tokens, last.rows) == (7, 18, 126)


# ---------------------------------------------------------------- (b) emulation


def _chunk_q(q, g, hkv, h0, n, source_h0=None):
    """The query heads a chunk's blocks read, ``[..., hkv * n, D]``: heads
    ``h0 .. h0 + n`` of each kv head's group (``source_h0``: the planted
    fault reads another chunk's)."""
    src = h0 if source_h0 is None else source_h0
    idx = torch.tensor([kvh * g + src + j for kvh in range(hkv) for j in range(n)])
    return q.index_select(-2, idx), torch.tensor([kvh * g + h0 + j for kvh in range(hkv)
                                                  for j in range(n)])


def _by_chunks(q, g, hkv, run, fault=False):
    """A wide group's output, chunk by chunk: ``run(q of a chunk)`` is the
    two-tile emulation of one chunk's blocks."""
    out = torch.zeros(q.shape, dtype=torch.bfloat16)
    chunks = td.head_chunks(g)
    for c, (h0, n) in enumerate(chunks):
        last = fault and len(chunks) > 1 and c == len(chunks) - 1
        qc, heads = _chunk_q(q, g, hkv, h0, n, 0 if last else None)
        out.index_copy_(-2, heads, run(qc))
    return out


def _decode_case(g, pool, d):
    hkv, bs = 1, 16
    lens = [0, 1, 17, 70, 150]
    q, k, v, ck, cv, bt, lens_t = dt._case(200 + g, lens, g * hkv, hkv, bs, d=d)
    live = dt._live_slots(bt, lens_t, bs, k.shape[0])
    k, v, sc, (kp, vp, scp) = dt._pools(pool, k, v, live, hkv, d)
    return q, (k, v, sc), (kp, vp, scp), ck, cv, bt, lens_t, bs


@pytest.mark.parametrize("pool", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("g", GROUPS)
def test_decode_chunk_emulation_matches_plain_version(g, pool):
    """Each chunk's blocks (two n8 tiles, split over KV) on a pool whose dead
    slots hold NaN, the current token deferred, against the plain version."""
    d = 128 if g == 48 else 64
    q, (k, v, sc), (kp, vp, scp), ck, cv, bt, lens, bs = _decode_case(g, pool, d)
    sm = d ** -0.5
    want = td.paged_decode_ref(q, k, v, bt, lens, sm, bs, cur_k=ck, cur_v=cv, **sc)
    got = _by_chunks(q, g, 1, lambda qc: dt.emulate_decode(qc, kp, vp, bt, lens, sm, bs, 0,
                                                          ck, cv, splits=2, **scp))
    ok, err, rel = dt._check(got, want)
    assert ok, (g, pool, err, rel)
    assert (got[lens == 0] == 0).all()


@pytest.mark.parametrize("g", GROUPS)
def test_decode_chunk_emulation_matches_jax_and_catches_the_planted_fault(g):
    """The JAX package's plain reference at T 1 (the query at kv_len - 1,
    a 40-token window); the last chunk reading the first chunk's queries
    fails the same check."""
    d = 128 if g == 48 else 64
    q, (k, v, _), _, _, _, bt, lens, bs = _decode_case(g, "bf16", d)
    sm = d ** -0.5
    offs = (lens.long() - 1).clamp_min(0)
    jb = lambda t: jnp.asarray(t.float().numpy())
    want = j_ref(jb(q[:, None]), jb(k), jb(v), jnp.asarray(bt.numpy()),
                 jnp.asarray(lens.numpy()), jnp.asarray(offs.numpy()), sm, block_size=bs,
                 sliding_window=40)
    want = torch.from_numpy(np.array(want, dtype=np.float32))[:, 0]
    want[lens == 0] = 0.0
    run = lambda qc: dt.emulate_decode(qc, k, v, bt, lens, sm, bs, 40, splits=2)
    ok, err, rel = dt._check(_by_chunks(q, g, 1, run), want)
    assert ok, (g, err, rel)
    assert not dt._check(_by_chunks(q, g, 1, run, fault=True), want)[0]


def _prefill_case(g, pool, d):
    b, t, hkv = 2, 21, 1
    q, k, v, bt, offs, lens = pt._case(300 + g, b, t, g * hkv, hkv, [0, 40], [21, 55], d=d)
    kw = {}
    if pool == "int8":
        k, ks = pt._quantize(k, hkv, d)
        v, vs = pt._quantize(v, hkv, d)
        kw = dict(k_scale=ks, v_scale=vs)
    elif pool == "e4m3":
        k, v = k.to(FP8), v.to(FP8)
    return q.to(torch.bfloat16), k, v, bt, offs, lens, kw


@pytest.mark.parametrize("pool", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("g", GROUPS)
def test_prefill_chunk_emulation_matches_plain_version(g, pool):
    """Each chunk's blocks (its own row map at G') behind a 40-token reused
    prefix, one row with a padded tail, against the plain version."""
    d = 128 if g == 48 else 64
    q, k, v, bt, offs, lens, kw = _prefill_case(g, pool, d)
    sm = d ** -0.5
    want = tp.paged_prefill_ref(q, k, v, bt, offs, lens, sm, 16, 0, **kw)
    got = _by_chunks(q, g, 1, lambda qc: pt.emulate_prefill(qc, k, v, bt, offs, lens, sm, 16,
                                                           **kw)[0])
    ok, err, rel = pt._check(got, want)
    assert ok, (g, pool, err, rel)


@pytest.mark.parametrize("g", GROUPS)
def test_prefill_chunk_emulation_matches_jax_and_catches_the_planted_fault(g):
    """The JAX package's plain reference with a 30-token window; the last
    chunk staging the first chunk's queries fails the same check."""
    d = 128 if g == 48 else 64
    q, k, v, bt, offs, lens, _ = _prefill_case(g, "bf16", d)
    sm = d ** -0.5
    jb = lambda t: jnp.asarray(t.float().numpy())
    want = j_ref(jb(q), jb(k), jb(v), jnp.asarray(bt.numpy()), jnp.asarray(lens.numpy()),
                 jnp.asarray(offs.numpy()), sm, block_size=16, sliding_window=30)
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    pos = offs.long()[:, None] + torch.arange(q.shape[1])[None, :]
    want[pos >= lens.long()[:, None]] = 0.0  # padded tail rows: the kernel's zeros
    run = lambda qc: pt.emulate_prefill(qc, k, v, bt, offs, lens, sm, 16, 30)[0]
    ok, err, rel = pt._check(_by_chunks(q, g, 1, run), want)
    assert ok, (g, err, rel)
    assert not pt._check(_by_chunks(q, g, 1, run, fault=True), want)[0]
