"""Dynamic multi-LoRA: each token row adds its own adapter's delta.

``lora_delta(x, y, A, members, ids, layer, seg)`` adds each row n's adapter
delta to ``y`` in place. ``A`` ``[n_ids, L, in, R]`` joins the members of a
fused linear along R (``LlamaFamilyModel.fuse_lora``); ``members`` lists
them in the column order of y as ``(B_j, o_j)``, ``B_j`` ``[n_ids, L, r,
o_j]`` bf16 (``LoraManager.device_pack``) or None for a member no adapter
targets, whose columns keep y as it is. Member j adds ``(x @ A[ids[n],
layer])[seg_j: seg_j + r] @ B_j[ids[n], layer]`` to its columns, seg_j being
r times the members present before it. Id 0 is all zeros and the scale is
folded into B. In the JAX package this is a gather and two einsums a linear
that XLA fuses (``rtp_llm_tpu/models/llama_family.py:686-693``); PyTorch has
no such form (the gather writes the ``[N, in, R]`` stacks out and reads them
back), so on the card it runs the hand-written X4 ``csrc/lora_bgmv.cu``.

The rows are grouped by adapter once a forward: ``lora_segments(ids,
n_ids)`` (one launch; the ids are the same for every layer and linear)
gives the ``Segments`` record: the rows in a stable adapter order, each
adapter's offsets and a table of tiles of at most ``TILE_ROWS`` rows of one
adapter (``ceil(N / TILE_ROWS) + n_ids`` entries; rows of id 0 form none).
Then two launches a linear, both over that table: ``shrink`` (``t =
bf16(x @ A)``, held as f32 ``[N, R]``, on tensor cores, ``in`` split over
blocks and the splits' partials added in a fixed order) and ``expand`` (``y
+= bf16(t @ B_j)`` for every member at once, each B tile read once a tile of
rows). Everything is capturable in a CUDA graph: shapes follow N and n_ids
alone, and no count is read on the host.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions: the segments as a stable argsort and a bincount, the delta as the
JAX gather and einsums in torch (x read in A's type, bf16; each product
summed in f32 and rounded to bf16, t kept as f32 values, the delta; then
added to y). The plain delta takes ids and needs no segment record.

What the kernels do not take (``check_stacks`` and ``expand_layout`` raise
before any weight changes): R not a multiple of 8, or above
``MAX_RCHUNKS`` chunks of ``8 * MAX_NT`` ranks; more than three members;
member widths not multiples of 8; a member rank above ``MAX_RANK``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import I32, I64, P

R_MULTIPLE = 8  # the shrink reads A's rows in 16-byte vectors (csrc/lora_bgmv.cu)
TILE_ROWS = 64  # rows of one adapter a shrink / expand block (TM)
K_TILE = 128  # k a shrink ring stage (KT)
MAX_NT = 16  # 8-rank tiles a shrink block takes at most (128 ranks)
MAX_RCHUNKS = 8  # rank chunks of a shrink: R <= 8 * 8 * MAX_NT
MAX_RANK = 256  # a member's r in the expand (its B tile in shared memory)
MAX_MEMBERS = 3  # q | k | v
# shrink_plan: up to NARROW_ROWS rows the shrink's blocks take 16 ranks and
# `in` is split until about NARROW_BLOCKS blocks are launched (two an SM of
# the H100's 132); above, WIDE_BLOCKS (each streams x for 64 rows); at most
# MAX_SPLITS splits (picked by a sweep on an H100, PERF.md)
NARROW_ROWS, NARROW_BLOCKS, WIDE_BLOCKS, MAX_SPLITS = 512, 264, 128, 64

KERNELS = {
    "segments": _kernels.Kernel("lora_segments", "lora_bgmv.cu", "lora_segments",
                                [P, I32, I32, I32, P, P, P, P, P]),
    "shrink": _kernels.Kernel("lora_shrink", "lora_bgmv.cu", "lora_shrink",
                              [P, I64, P, P, P, P, I32, P, I32, I32, I32, I32, I32, I32, I32,
                               P, P, I32, P]),
    "expand": _kernels.Kernel("lora_expand", "lora_bgmv.cu", "lora_expand",
                              [P, I64, P, P, I32, P, P, P, I32, I32, I32, I32, I32, I32, I32, P,
                               I64, I32, P]),
}
PLAIN_CALLS = _kernels.Counter("lora_delta_plain")


class Segments(NamedTuple):
    """One forward's rows grouped by adapter (``lora_segments``): views of
    one int32 buffer. ``tiles`` ``[max_tiles, 4]`` (adapter, first position
    in ``perm``, rows, 0), unused entries all 0; ``counters`` the shrink's
    split counters, ``[max_tiles * MAX_RCHUNKS]``, zero between launches."""
    perm: torch.Tensor  # [N]
    offsets: torch.Tensor  # [n_ids + 1]
    tiles: torch.Tensor  # [max_tiles, 4]
    counters: torch.Tensor
    n_ids: int


def max_tiles(n: int, n_ids: int) -> int:
    """Entries of the tile table: a bound on the tiles of any ids."""
    return -(-n // TILE_ROWS) + n_ids


def _segments_buffer(n: int, n_ids: int, device) -> Segments:
    m = max_tiles(n, n_ids)
    buf = torch.empty(m * 4 + m * MAX_RCHUNKS + n + n_ids + 1, dtype=torch.int32, device=device)
    tiles, counters, perm, offsets = buf.split([m * 4, m * MAX_RCHUNKS, n, n_ids + 1])
    return Segments(perm, offsets, tiles.view(m, 4), counters, n_ids)


def lora_segments_ref(ids: torch.Tensor, n_ids: int) -> Segments:
    """The plain segment pass: ids outside [0, n_ids) taken as 0, a stable
    argsort, a bincount, and each adapter's rows cut into tiles of
    ``TILE_ROWS`` in order, adapter by adapter."""
    PLAIN_CALLS.n += 1
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < n_ids), ids, torch.zeros_like(ids))
    seg = _segments_buffer(ids.numel(), n_ids, ids.device)
    seg.perm.copy_(torch.argsort(ids, stable=True))
    counts = torch.bincount(ids, minlength=n_ids)
    seg.offsets.copy_(torch.cat([counts.new_zeros(1), counts.cumsum(0)]))
    seg.tiles.zero_()
    seg.counters.zero_()
    j = 0
    for v in range(1, n_ids):
        first, c = int(seg.offsets[v]), int(counts[v])
        for k in range(0, c, TILE_ROWS):
            seg.tiles[j] = torch.tensor([v, first + k, min(TILE_ROWS, c - k), 0])
            j += 1
    return seg


def lora_segments(ids: torch.Tensor, n_ids: int) -> Segments:
    """Group the rows of ``ids`` ``[N]`` by adapter: one launch a forward."""
    if ids.device.type == "cpu":
        return lora_segments_ref(ids, n_ids)
    ids = _ids32(ids)
    seg = _segments_buffer(ids.numel(), n_ids, ids.device)
    KERNELS["segments"].launch(ids.data_ptr(), ids.numel(), n_ids, seg.tiles.shape[0],
                               seg.perm.data_ptr(), seg.offsets.data_ptr(),
                               seg.tiles.data_ptr(), seg.counters.data_ptr(),
                               _kernels.stream_ptr(ids.device))
    return seg


def shrink_chunk(r: int) -> int:
    """The shrink's chunk NT (8 NT ranks a block): R / 8 dealt evenly into
    the fewest chunks of at most ``MAX_NT``, so every R that is a multiple
    of 8 is served."""
    if r < R_MULTIPLE or r % R_MULTIPLE:
        raise ValueError(f"a LoRA stack's rank must be a positive multiple of {R_MULTIPLE}, "
                         f"not {r}")
    v = r // R_MULTIPLE
    chunks = -(-v // MAX_NT)
    if chunks > MAX_RCHUNKS:
        raise ValueError(f"a LoRA stack's joined rank {r} is above the shrink's "
                         f"{R_MULTIPLE * MAX_NT * MAX_RCHUNKS}")
    return -(-v // chunks)


def shrink_plan(n: int, k: int, r: int) -> tuple:
    """``(nt, splits)`` of the shrink for N rows, ``in`` = k and R = r. Up
    to ``NARROW_ROWS`` rows (a decode or verify window: a few tiles) a block
    takes 16 ranks, so that the rank chunks add blocks and each chunk's
    split sum is small, and ``in`` is split towards ``NARROW_BLOCKS``
    blocks; above, the fewest chunks (``shrink_chunk``: x is read once) and
    ``WIDE_BLOCKS``. Splits deal ``in``'s k-tiles of ``K_TILE`` evenly, at
    most ``MAX_SPLITS``, none empty."""
    narrow = n <= NARROW_ROWS
    nt = max(2, -(-(r // R_MULTIPLE) // MAX_RCHUNKS)) if narrow else shrink_chunk(r)
    shrink_chunk(r)  # raises on a rank the kernel does not take
    k_tiles = -(-k // K_TILE)
    chunks = -(-(r // R_MULTIPLE) // nt)
    blocks = NARROW_BLOCKS if narrow else WIDE_BLOCKS
    want = -(-blocks // (max(1, -(-n // TILE_ROWS)) * chunks))
    splits = max(1, min(want, MAX_SPLITS, k_tiles))
    per = -(-k_tiles // splits)
    return nt, -(-k_tiles // per)


def expand_layout(members, out: int) -> tuple:
    """``(r, col1, col2)`` of the expand: the rank the present members share
    and the column bounds of members 1 and 2 in y (``out`` for members that
    are not there). Raises on what the kernel does not take."""
    if not 1 <= len(members) <= MAX_MEMBERS:
        raise ValueError(f"a LoRA expand takes 1 to {MAX_MEMBERS} members, not {len(members)}")
    widths = [o for _, o in members]
    if sum(widths) != out or any(o % 8 for o in widths):
        raise ValueError(f"member widths {widths} must be multiples of 8 summing to {out}")
    ranks = {b.shape[2] for b, _ in members if b is not None}
    if len(ranks) > 1:
        raise ValueError(f"the members of a fused linear share one rank, not {sorted(ranks)}")
    if ranks and max(ranks) > MAX_RANK:
        raise ValueError(f"a LoRA rank above {MAX_RANK} is not served, not {max(ranks)}")
    for b, o in members:
        if b is not None and b.shape[3] != o:
            raise ValueError(f"a member's B is {tuple(b.shape)}, its width {o}")
    bounds = [sum(widths[: j + 1]) for j in range(len(widths))][:-1]
    bounds += [out] * (2 - len(bounds))
    return (ranks.pop() if ranks else 0), bounds[0], bounds[1]


def check_stacks(A: torch.Tensor, members) -> None:
    """Raise unless the kernels take ``A`` and ``members`` (the checks the
    CUDA wrappers make before a launch)."""
    shrink_chunk(A.shape[-1])
    if A.shape[2] % 8:
        raise ValueError(f"a LoRA A's input width must be a multiple of 8, not {A.shape[2]}")
    r, _, _ = expand_layout(members, sum(o for _, o in members))
    if r * sum(b is not None for b, _ in members) > A.shape[-1]:
        raise ValueError(f"the members' ranks overrun A's {A.shape[-1]}")


def lora_shrink_ref(x: torch.Tensor, A: torch.Tensor, ids: torch.Tensor,
                    layer: int) -> torch.Tensor:
    """``t[n] = x[n] @ A[ids[n], layer]``: x ``[N, in]``, ``[N, R]`` f32
    holding values rounded to A's type (the JAX einsum's bf16 output)."""
    PLAIN_CALLS.n += 1
    a = A[ids.long(), layer]  # [N, in, R]
    return torch.einsum("ni,nir->nr", x.to(A.dtype).float(), a.float()).to(A.dtype).float()


def lora_expand_ref(t: torch.Tensor, members, ids: torch.Tensor, layer: int,
                    y: torch.Tensor) -> torch.Tensor:
    """``y[n, cols_j] += (t[n, seg_j:] @ B_j[ids[n], layer]).to(bf16)`` in
    place for each member present; returns y."""
    PLAIN_CALLS.n += 1
    col = seg = 0
    for b, o in members:
        if b is not None:
            r = b.shape[2]
            d = torch.einsum("nr,nro->no", t[:, seg: seg + r], b[ids.long(), layer].float())
            y[:, col: col + o] += d.to(b.dtype).to(y.dtype)
            seg += r
        col += o
    return y


def _ids32(ids: torch.Tensor) -> torch.Tensor:
    return ids if ids.dtype == torch.int32 and ids.is_contiguous() else ids.to(
        torch.int32).contiguous()


def _segments_for(ids: torch.Tensor, n_ids: int, seg: Optional[Segments]) -> Segments:
    if seg is None:
        return lora_segments(ids, n_ids)
    if seg.n_ids != n_ids or seg.perm.numel() != ids.numel():
        raise ValueError(f"a segment record of {seg.perm.numel()} rows over {seg.n_ids} ids "
                         f"does not fit {ids.numel()} rows over {n_ids}")
    return seg


def lora_shrink(x: torch.Tensor, A: torch.Tensor, ids: torch.Tensor, layer: int,
                seg: Optional[Segments] = None) -> torch.Tensor:
    """``t`` ``[N, R]`` f32. ``seg``: the forward's segment record (made here
    when None)."""
    if x.device.type == "cpu":
        return lora_shrink_ref(x, A, ids, layer)
    if x.dtype != torch.bfloat16 or A.dtype != torch.bfloat16 or not A.is_contiguous():
        raise NotImplementedError("lora_shrink takes bf16 x and a contiguous bf16 stack")
    if x.stride(-1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        x = x.contiguous()
    n_ids, layers, k, r = A.shape
    n = x.shape[0]
    seg = _segments_for(ids, n_ids, seg)
    nt, splits = shrink_plan(n, k, r)
    t = torch.empty((n, r), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits, n, r), dtype=torch.float32, device=x.device)
    KERNELS["shrink"].launch(x.data_ptr(), x.stride(0), seg.perm.data_ptr(),
                             seg.offsets.data_ptr(), seg.tiles.data_ptr(),
                             seg.counters.data_ptr(), seg.tiles.shape[0], A.data_ptr(), n_ids,
                             layers, layer, k, r, nt, splits, ws.data_ptr(),
                             t.data_ptr(), n, _kernels.stream_ptr(x.device))
    return t


def lora_expand(t: torch.Tensor, members, ids: torch.Tensor, layer: int,
                y: torch.Tensor, seg: Optional[Segments] = None) -> torch.Tensor:
    if y.device.type == "cpu":
        return lora_expand_ref(t, members, ids, layer, y)
    present = [b for b, _ in members if b is not None]
    if (y.dtype != torch.bfloat16 or t.dtype != torch.float32
            or any(b.dtype != torch.bfloat16 or not b.is_contiguous() for b in present)):
        raise NotImplementedError("lora_expand takes bf16 y, f32 t and contiguous bf16 stacks")
    if y.stride(-1) != 1 or t.stride(-1) != 1:
        raise ValueError("lora_expand updates y in place: the rows of y and t must be contiguous")
    r, col1, col2 = expand_layout(members, y.shape[1])
    if not present:
        return y
    n_ids, layers = present[0].shape[:2]
    seg = _segments_for(ids, n_ids, seg)
    bs = [b.data_ptr() if b is not None else None for b, _ in members]
    bs += [None] * (MAX_MEMBERS - len(bs))
    KERNELS["expand"].launch(t.data_ptr(), t.stride(0), seg.perm.data_ptr(),
                             seg.tiles.data_ptr(), seg.tiles.shape[0], *bs, n_ids, layers,
                             layer, r, col1, col2, y.shape[1], y.data_ptr(), y.stride(0),
                             y.shape[0], _kernels.stream_ptr(y.device))
    return y


def lora_delta(x: torch.Tensor, y: torch.Tensor, A: torch.Tensor, members,
               ids: torch.Tensor, layer: int, seg: Optional[Segments] = None) -> torch.Tensor:
    """Add each row's adapter delta to ``y [N, out]`` in place (ids ``[N]``
    per token row; ``seg`` their ``lora_segments`` record, made here when
    None); returns y."""
    if x.device.type == "cuda":
        seg = _segments_for(ids, A.shape[0], seg)
    return lora_expand(lora_shrink(x, A, ids, layer, seg), members, ids, layer, y, seg)


def warm(device) -> None:
    """Launch the three kernels once on rows of id 0 (nothing to do): the
    library is built, its module loaded and its shared-memory limits set
    before any graph capture."""
    x = torch.zeros((1, 8), dtype=torch.bfloat16, device=device)
    A = torch.zeros((1, 1, 8, R_MULTIPLE), dtype=torch.bfloat16, device=device)
    B = torch.zeros((1, 1, R_MULTIPLE, 8), dtype=torch.bfloat16, device=device)
    ids = torch.zeros(1, dtype=torch.int32, device=device)
    lora_delta(x, x, A, [(B, 8)], ids, 0)
