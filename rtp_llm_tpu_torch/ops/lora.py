"""Dynamic multi-LoRA: each token row adds its own adapter's delta.

``lora_delta(x, y, A, members, ids, layer)`` adds each row n's adapter
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
back), so on the card it runs the hand-written X4 ``csrc/lora_bgmv.cu``, two
launches: ``shrink`` (``t = bf16(x @ A)``, held as f32 ``[N, R]``) and
``expand`` (``y += bf16(t @ B_j)`` for every member at once).

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
version, the JAX gather and einsums in torch: x is read in A's type (bf16),
each product sums in f32 and is rounded to bf16 (t kept as f32 values, the
delta), and the delta is then added to y.
"""

from __future__ import annotations

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import I32, I64, P

R_MULTIPLE = 8  # the shrink reads A's rows in 16-byte vectors (csrc/lora_bgmv.cu)
MAX_CHUNK = 16  # 16-byte vectors of A a shrink block takes at most (128 ranks)
MAX_MEMBERS = 3  # q | k | v

KERNELS = {
    "shrink": _kernels.Kernel("lora_shrink", "lora_bgmv.cu", "lora_shrink",
                              [P, I64, P, P, I32, I32, I32, I32, I32, I32, P, I32, P]),
    "expand": _kernels.Kernel("lora_expand", "lora_bgmv.cu", "lora_expand",
                              [P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, P, I64,
                               I32, P]),
}
PLAIN_CALLS = _kernels.Counter("lora_delta_plain")


def shrink_chunk(r: int) -> int:
    """The shrink's chunk C (8 C ranks a block): the largest divisor of R /
    8 up to ``MAX_CHUNK``, so every rank that is a multiple of 8 is served."""
    if r < R_MULTIPLE or r % R_MULTIPLE:
        raise ValueError(f"a LoRA stack's rank must be a positive multiple of {R_MULTIPLE}, "
                         f"not {r}")
    v = r // R_MULTIPLE
    return max(c for c in range(1, MAX_CHUNK + 1) if v % c == 0)


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


def lora_shrink(x: torch.Tensor, A: torch.Tensor, ids: torch.Tensor, layer: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return lora_shrink_ref(x, A, ids, layer)
    if x.dtype != torch.bfloat16 or A.dtype != torch.bfloat16 or not A.is_contiguous():
        raise NotImplementedError("lora_shrink takes bf16 x and a contiguous bf16 stack")
    if x.stride(-1) != 1:
        x = x.contiguous()
    n_ids, layers, k, r = A.shape
    n = x.shape[0]
    ids = _ids32(ids)
    t = torch.empty((n, r), dtype=torch.float32, device=x.device)
    KERNELS["shrink"].launch(x.data_ptr(), x.stride(0), ids.data_ptr(), A.data_ptr(), n_ids,
                             layers, layer, k, r, shrink_chunk(r), t.data_ptr(), n,
                             _kernels.stream_ptr(x.device))
    return t


def lora_expand(t: torch.Tensor, members, ids: torch.Tensor, layer: int,
                y: torch.Tensor) -> torch.Tensor:
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
    bs = [b.data_ptr() if b is not None else None for b, _ in members]
    bs += [None] * (MAX_MEMBERS - len(bs))
    ids = _ids32(ids)
    KERNELS["expand"].launch(t.data_ptr(), t.stride(0), ids.data_ptr(), *bs, n_ids, layers,
                             layer, r, col1, col2, y.shape[1], y.data_ptr(), y.stride(0),
                             y.shape[0], _kernels.stream_ptr(y.device))
    return y


def lora_delta(x: torch.Tensor, y: torch.Tensor, A: torch.Tensor, members,
               ids: torch.Tensor, layer: int) -> torch.Tensor:
    """Add each row's adapter delta to ``y [N, out]`` in place (ids ``[N]``
    per token row); returns y."""
    return lora_expand(lora_shrink(x, A, ids, layer), members, ids, layer, y)


def warm(device) -> None:
    """Launch both kernels once on rows of id 0 (they return at once): the
    library is built and its module loaded before any graph capture."""
    x = torch.zeros((1, 8), dtype=torch.bfloat16, device=device)
    A = torch.zeros((1, 1, 8, R_MULTIPLE), dtype=torch.bfloat16, device=device)
    B = torch.zeros((1, 1, R_MULTIPLE, 8), dtype=torch.bfloat16, device=device)
    ids = torch.zeros(1, dtype=torch.int32, device=device)
    lora_delta(x, x, A, [(B, 8)], ids, 0)
