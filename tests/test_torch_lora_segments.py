"""X4's segment pass and the grouped LoRA delta on the CPU, against numpy and
the JAX gather-and-einsums.

* ``lora_segments`` (its plain version: a stable argsort and a bincount)
  against a numpy reference: the stable order, the offsets, the tile
  table's bound and coverage (every live row in exactly one tile of its own
  adapter, no row of id 0 in any, unused entries zero), ids outside
  ``[0, n_ids)`` taken as 0, N 0, one adapter on every row, 8 adapters.
* A numpy emulation of the CUDA segment kernel's warp ranges, match groups
  and scans gives the same record.
* ``lora_delta`` given the segment record equals the JAX branch's gather
  and einsums (``rtp_llm_tpu/models/llama_family.py:686-693``) for mixed
  ids at rank 16, rank 64 on three members (joined to 192) and a member
  with no B.
* The shrink's plan: chunks and splits for the Qwen2-7B fused linears.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtp_llm_tpu_torch.ops import lora as lora_ops

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

TM = lora_ops.TILE_ROWS


def _want_segments(ids, n_ids):
    """numpy: (perm, offsets, tiles as a list of (adapter, first, rows))."""
    v = np.where((ids >= 0) & (ids < n_ids), ids, 0)
    perm = np.argsort(v, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(v, minlength=n_ids))])
    tiles = [(a, first, min(TM, offsets[a + 1] - first)) for a in range(1, n_ids)
             for first in range(offsets[a], offsets[a + 1], TM)]
    return perm, offsets, tiles


def _check_record(seg, ids, n_ids):
    perm, offsets, tiles = _want_segments(ids, n_ids)
    n = len(ids)
    np.testing.assert_array_equal(seg.perm.numpy(), perm)
    np.testing.assert_array_equal(seg.offsets.numpy(), offsets)
    table = seg.tiles.numpy()
    assert table.shape == (lora_ops.max_tiles(n, n_ids), 4)
    used = [tuple(t[:3]) for t in table if t[2] > 0]
    assert used == tiles
    assert len(used) <= -(-n // TM) + n_ids
    assert not table[len(used):].any() and not table[:, 3].any()
    assert not seg.counters.numpy().any()
    v = np.where((ids >= 0) & (ids < n_ids), ids, 0)
    covered = np.concatenate([perm[f: f + c] for _, f, c in used]) if used else np.zeros(0, int)
    assert sorted(covered.tolist()) == sorted(np.flatnonzero(v > 0).tolist())
    for a, f, c in used:
        assert 1 <= c <= TM and (v[perm[f: f + c]] == a).all()


SEGMENT_CASES = {
    "mixed": (np.random.default_rng(1).integers(0, 3, 200), 3),
    "outside_range": (np.array([0, 5, -1, 2, 7, 1, 2, -3, 3, 1]), 3),
    "n0": (np.zeros(0, int), 3),
    "one_adapter_every_row": (np.full(130, 2), 3),
    "all_id_0": (np.zeros(64, int), 3),
    "eight_adapters": (np.random.default_rng(2).integers(0, 9, 64), 9),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_plain_segments_match_numpy(case):
    ids, n_ids = SEGMENT_CASES[case]
    seg = lora_ops.lora_segments(torch.from_numpy(ids.astype(np.int32)), n_ids)
    _check_record(seg, ids, n_ids)


def _emulate_segments_kernel(ids, n_ids, max_tiles):
    """csrc/lora_bgmv.cu's segments_kernel: W warps (from the shared-memory
    budget), each a contiguous range of whole 32-row chunks; counts by
    match group, a prefix over warps within an id, scans over ids, the
    placement in row order, the tiles, the unused entries."""
    n = len(ids)
    w = min(32, (12288 - 3 * (n_ids + 1)) // n_ids)
    cnt = np.zeros((w, n_ids), int)
    span = (-(-n // w) + 31) // 32 * 32
    seg_id = [int(i) if 0 <= i < n_ids else 0 for i in ids]
    ranges = [(min(n, k * span), min(n, min(n, k * span) + span)) for k in range(w)]
    for k, (lo, hi) in enumerate(ranges):
        for base in range(lo, hi, 32):
            group = [seg_id[m] for m in range(base, min(base + 32, hi))]
            for v in set(group):
                cnt[k, v] += group.count(v)
    total = cnt.sum(0)
    cnt = np.cumsum(cnt, 0) - cnt
    start = np.concatenate([[0], np.cumsum(total)])
    ntiles = [0] + [-(-int(c) // TM) for c in total[1:]]
    tstart = np.concatenate([[0], np.cumsum(ntiles)])
    cnt += start[:n_ids]
    perm = np.full(n, -1)
    for k, (lo, hi) in enumerate(ranges):
        for base in range(lo, hi, 32):
            for m in range(base, min(base + 32, hi)):
                perm[cnt[k, seg_id[m]]] = m
                cnt[k, seg_id[m]] += 1
    tiles = np.zeros((max_tiles, 4), int)
    for v in range(1, n_ids):
        for j, first in enumerate(range(0, int(total[v]), TM)):
            tiles[tstart[v] + j] = (v, start[v] + first, min(TM, total[v] - first), 0)
    return perm, start, tiles


@pytest.mark.parametrize("n,n_ids,seed", [(64, 3, 0), (2048, 3, 1), (320, 9, 2), (70, 400, 3),
                                          (1000, 2, 4)])
def test_segment_kernel_emulation_matches_the_plain_version(n, n_ids, seed):
    """The kernel's arithmetic (warp ranges of 32-row chunks, fewer warps
    when n_ids crowds the shared counts) gives the plain version's record."""
    ids = np.random.default_rng(seed).integers(-1, n_ids + 1, n)
    seg = lora_ops.lora_segments(torch.from_numpy(ids.astype(np.int32)), n_ids)
    perm, offsets, tiles = _emulate_segments_kernel(ids, n_ids, seg.tiles.shape[0])
    np.testing.assert_array_equal(perm, seg.perm.numpy())
    np.testing.assert_array_equal(offsets, seg.offsets.numpy())
    np.testing.assert_array_equal(tiles, seg.tiles.numpy())


def _jax_delta(x, y0, a, bs, ids, layer):
    """The JAX branch: gather each row's adapter, einsum to bf16, then each
    member's einsum added to its columns."""
    ja = jnp.asarray(a, jnp.bfloat16)[jnp.asarray(ids), layer]
    xa = jnp.einsum("bth,bhr->btr", jnp.asarray(x)[:, None].astype(ja.dtype), ja)
    out, seg = [], 0
    for b, o in bs:
        if b is None:
            out.append(jnp.zeros((len(ids), 1, o), jnp.float32))
            continue
        jb = jnp.asarray(b, jnp.bfloat16)[jnp.asarray(ids), layer]
        r = b.shape[2]
        out.append(jnp.einsum("btr,bro->bto", xa[..., seg: seg + r], jb).astype(jnp.float32))
        seg += r
    return np.asarray(jnp.asarray(y0)[:, None] + jnp.concatenate(out, -1))[:, 0]


@pytest.mark.parametrize("rank,widths,absent", [(16, (40,), ()), (64, (48, 16, 16), ()),
                                                (16, (32, 16, 16), (1,))])
def test_delta_with_segments_matches_the_jax_einsums(rank, widths, absent):
    """``lora_delta`` on the CPU, given the forward's segment record, equals
    the JAX gather and einsums within 1e-2 of the delta's spread; rows of
    id 0 and a member with no B keep y exactly."""
    rng = np.random.default_rng(rank + len(widths))
    n, k, layers = 37, 64, 3
    present = [j for j in range(len(widths)) if j not in absent]
    big_r = len(present) * rank
    a = rng.standard_normal((4, layers, k, big_r)).astype(np.float32) * 0.2
    a[0] = 0
    bs = []
    for j, o in enumerate(widths):
        b = None
        if j in present:
            b = rng.standard_normal((4, layers, rank, o)).astype(np.float32) * 0.2
            b[0] = 0
        bs.append((b, o))
    x = rng.standard_normal((n, k)).astype(np.float32)
    y0 = rng.standard_normal((n, sum(widths))).astype(np.float32)
    ids = rng.integers(0, 4, n).astype(np.int32)
    want = _jax_delta(x, y0, a, bs, ids, 1)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    members = [(None if b is None else torch.from_numpy(b).to(torch.bfloat16), o) for b, o in bs]
    lora_ops.check_stacks(ta, members)
    tids = torch.from_numpy(ids)
    seg = lora_ops.lora_segments(tids, 4)
    got = lora_ops.lora_delta(torch.from_numpy(x), torch.from_numpy(y0.copy()), ta, members,
                              tids, 1, seg).numpy()
    spread = np.abs(want - y0).max()
    assert spread > 0.1
    assert np.abs(got - want).max() <= 1e-2 * spread
    np.testing.assert_array_equal(got[ids == 0], y0[ids == 0])
    for j in absent:
        cols = slice(sum(widths[:j]), sum(widths[: j + 1]))
        np.testing.assert_array_equal(got[:, cols], y0[:, cols])


def test_a_segment_record_of_other_rows_is_refused():
    seg = lora_ops.lora_segments(torch.zeros(5, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        lora_ops._segments_for(torch.zeros(6, dtype=torch.int32), 3, seg)
    with pytest.raises(ValueError):
        lora_ops._segments_for(torch.zeros(5, dtype=torch.int32), 4, seg)


@pytest.mark.parametrize("n", [64, 320, 2048])
def test_shrink_plan_at_the_served_shapes(n):
    """Qwen2-7B's fused linears at rank 16 (and qkv at rank 64): rank chunks
    within MAX_RCHUNKS (16 ranks a block up to NARROW_ROWS rows, the
    fewest chunks above), splits that leave no split empty and launch
    about NARROW_BLOCKS / WIDE_BLOCKS blocks over the row tiles (more than
    half the splits that would, once k-tiles are dealt evenly)."""
    for k, r in ((3584, 48), (3584, 16), (3584, 32), (18944, 16), (3584, 192)):
        nt, splits = lora_ops.shrink_plan(n, k, r)
        chunks = -(-(r // 8) // nt)
        assert nt <= lora_ops.MAX_NT and chunks <= lora_ops.MAX_RCHUNKS
        narrow = n <= lora_ops.NARROW_ROWS
        assert nt == (max(2, -(-(r // 8) // lora_ops.MAX_RCHUNKS)) if narrow
                      else lora_ops.shrink_chunk(r))
        k_tiles = -(-k // lora_ops.K_TILE)
        per = -(-k_tiles // splits)
        assert 1 <= splits <= lora_ops.MAX_SPLITS and (splits - 1) * per < k_tiles
        blocks = lora_ops.NARROW_BLOCKS if narrow else lora_ops.WIDE_BLOCKS
        want = min(-(-blocks // (-(-n // TM) * chunks)), lora_ops.MAX_SPLITS, k_tiles)
        assert want / 2 < splits <= want
    assert lora_ops.shrink_chunk(192) == 12 and lora_ops.shrink_chunk(48) == 6
    with pytest.raises(ValueError):
        lora_ops.shrink_chunk(8 * lora_ops.MAX_NT * lora_ops.MAX_RCHUNKS + 8)
