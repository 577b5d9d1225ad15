"""Mixture-of-experts routing and expert MLP: the port of
``rtp_llm_tpu/ops/moe.py::fused_moe`` and of the softmax routing of
``rtp_llm_tpu/models/llama_family.py::_moe_mlp`` (qwen2_moe, qwen3_moe,
mixtral; bf16 expert stacks).

* ``route(logits, k, norm)``: softmax over the f32 router logits, the top k
  (``torch.topk``), renormalised under ``moe_norm_topk_prob`` (the JAX
  ``maximum(sum, 1e-20)``). Plain PyTorch: the JAX package leaves it to XLA,
  and PyTorch has the same ops.
* ``sort_by_expert(top_idx, E)``: the N * K assignments in a stable order by
  expert (``torch.argsort(stable=True)``, as ``jnp.argsort``) and the group
  offsets ``[E + 1]`` int32, counted with ``scatter_add_``: nothing is read
  back to the host, so the layer can be captured in a decode graph.
* ``grouped_gemm(x, w, offsets, rows)``: ``y[r] = x[rows[r]] @ w[e(r)]`` for
  rows sorted by expert, e(r) the group holding r (``rows`` None: x's own
  rows). The JAX package's ``jax.lax.ragged_dot`` is an XLA op with no Pallas
  kernel, and PyTorch has no public form of it: on the card it runs the
  hand-written X6 ``csrc/moe_grouped_gemm.cu`` (bf16 operands, f32 sums,
  bf16 out; the group offsets read on the device; x's rows gathered through
  ``rows`` in the operand load); on the CPU its plain version, one
  ``matmul`` an expert, which reads the offsets on the host. ``tile_rows``
  picks the tile height of X6's warp-specialised ``wgmma`` kernel (W by TMA)
  from the rows and experts: 64, 128 or 160 rows.
* ``fused_moe(x, top_idx, top_w, w_gate_up, w_down)``: the gate-up product
  of every assignment (``w_gate_up [E, H, 2I]``: the port fuses gate and up
  as it fuses the dense MLP's), SiLU(gate) * up, the down product, and the
  combine: each token's K rows gathered through the inverse permutation and
  added in f32, in the sorted order (expert ascending) the JAX scatter-add
  takes, one by one from zero, so that replays give the same bits (no
  atomic ``index_add_``). ``fused_moe_plain`` is the same function on the
  plain products: the CPU path's and ``chip_smoke.py``'s yardstick.

A CUDA tensor launches X6 or raises; it never falls back to the plain
version. X6 takes bf16 operands, K and N multiples of 8, 16-byte aligned
rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch._kernels import I32, I64, P
from rtp_llm_tpu_torch.ops.activations import silu_and_mul

# rows a tile of X6's instances (csrc/moe_grouped_gemm.cu), and each one's
# time a tile against a 128-row tile's: a tile reads its W slice whole
# whatever its rows, and its products grow with them. Fitted to
# chip_smoke.py [moe-switch] (PERF.md, X6's switch-point table): a fixed
# switch on the mean rows an expert lost up to 40% where a 160-row tile
# pads groups of 161-224 rows to 320.
TILE_ROWS = (64, 128, 160)
TILE_COST = {64: 0.9, 128: 1.0, 160: 1.1}

KERNELS = {"moe_gemm": _kernels.Kernel(
    "moe_grouped_gemm", "moe_grouped_gemm.cu", "moe_grouped_gemm",
    [P, I64, P, P, P, P, I64, I32, I32, I32, I32, I32, P])}
PLAIN_CALLS = _kernels.Counter("moe_grouped_gemm_plain")
# X6's launches by instance (rows a tile), beside the entry's own count
TILE_LAUNCHES = {tm: _kernels.Counter(f"moe_grouped_gemm_tm{tm}") for tm in TILE_ROWS}


def route(logits: torch.Tensor, k: int, norm_topk_prob: bool):
    """(top_idx ``[N, k]`` int64, top_w ``[N, k]`` f32) of f32 router
    logits ``[N, E]``."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1)
    if norm_topk_prob:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return top_idx, top_w


def sort_by_expert(top_idx: torch.Tensor, num_experts: int):
    """(order ``[N * K]`` int64: the flat assignments stably sorted by
    expert, offsets ``[E + 1]`` int32: each expert's first sorted row)."""
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.zeros(num_experts + 1, dtype=torch.int32, device=flat.device)
    offsets[1:] = counts.cumsum(0, dtype=torch.int32)
    return order, offsets


def _tiles_an_expert(m: float, tm: int) -> float:
    """The mean of ceil(g / tm) over groups g ~ Normal(m, m): 1 + the sum
    over k of P(g > k tm)."""
    tiles, k = 1.0, 1
    while True:
        p = 0.5 * math.erfc((k * tm - m) / math.sqrt(2 * m))
        if p < 1e-4:
            return tiles
        tiles, k = tiles + p, k + 1


def tile_rows(rows: int, num_experts: int) -> int:
    """X6's rows a tile for ``rows`` sorted rows over ``num_experts``: the
    height of the least expected cost, an expert's mean tiles (its group of
    about m = rows / num_experts rows, spread as a count is, by sqrt(m))
    times ``TILE_COST``; the taller on a tie."""
    m = max(rows / num_experts, 1e-9)
    cost = {tm: _tiles_an_expert(m, tm) * TILE_COST[tm] for tm in TILE_ROWS}
    return min(TILE_ROWS, key=lambda tm: (cost[tm], -tm))


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: one ``matmul`` an expert over its group (the
    offsets read on the host)."""
    PLAIN_CALLS.n += 1
    xs = x if rows is None else x.index_select(0, rows)
    y = xs.new_empty((xs.shape[0], w.shape[-1]))
    off = offsets.tolist()
    for e in range(w.shape[0]):
        if off[e + 1] > off[e]:
            y[off[e]: off[e + 1]] = xs[off[e]: off[e + 1]] @ w[e]
    return y


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[R, N]``: X6 on a CUDA tensor, the plain version on a CPU one. ``x``
    ``[*, K]`` (``rows`` ``[R]`` picks its rows; None: R = x's rows), ``w``
    ``[E, K, N]`` contiguous, ``offsets`` ``[E + 1]`` int32 on x's device."""
    if x.device.type != "cuda":
        return grouped_gemm_plain(x, w, offsets, rows)
    e, k, n = w.shape
    r = x.shape[0] if rows is None else rows.shape[0]
    if (x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or k % 8 or n % 8
            or x.shape[-1] != k or x.stride(-1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16
            or not w.is_contiguous() or offsets.dtype != torch.int32):
        raise ValueError(f"moe_grouped_gemm takes bf16 x [*, K] and w [E, K, N] with K, N "
                         f"multiples of 8 and 16-byte aligned rows (got x {tuple(x.shape)} "
                         f"{x.dtype}, w {tuple(w.shape)} {w.dtype})")
    y = torch.empty((r, n), dtype=torch.bfloat16, device=x.device)
    if r == 0:
        return y
    rows_i32 = None if rows is None else rows.to(torch.int32).contiguous()
    tm = tile_rows(r, e)
    KERNELS["moe_gemm"].launch(x.data_ptr(), x.stride(0),
                               None if rows_i32 is None else rows_i32.data_ptr(),
                               w.data_ptr(), offsets.data_ptr(), y.data_ptr(), y.stride(0),
                               r, k, n, e, tm, _kernels.stream_ptr(x.device))
    TILE_LAUNCHES[tm].n += 1
    return y


def fused_moe(x: torch.Tensor, top_idx: torch.Tensor, top_w: torch.Tensor,
              w_gate_up: torch.Tensor, w_down: torch.Tensor, plain: bool = False):
    """``[N, H]`` f32: the routed experts' outputs of x ``[N, H]`` combined by
    ``top_w`` (module docstring). ``plain`` takes the plain products."""
    n, h = x.shape
    k = top_idx.shape[1]
    order, offsets = sort_by_expert(top_idx, w_gate_up.shape[0])
    gemm = grouped_gemm_plain if plain else grouped_gemm
    gate_up = gemm(x, w_gate_up, offsets, rows=torch.div(order, k, rounding_mode="floor"))
    i = w_down.shape[1]
    down = gemm(silu_and_mul(gate_up[:, :i], gate_up[:, i:]), w_down, offsets)  # [N * K, H]
    # each token's K rows in sorted order, and their weights
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    pos, perm = inv.view(n, k).sort(dim=1)
    wts = top_w.float().gather(1, perm)
    out = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + down[pos[:, j]].float() * wts[:, j: j + 1]
    return out


def fused_moe_plain(x, top_idx, top_w, w_gate_up, w_down):
    """``fused_moe`` through the plain products."""
    return fused_moe(x, top_idx, top_w, w_gate_up, w_down, plain=True)
