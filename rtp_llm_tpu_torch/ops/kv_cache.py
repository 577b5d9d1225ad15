"""Paged KV cache ops: slot computation and row writes.

Port of ``rtp_llm_tpu/ops/kv_cache.py``. The pool layout is the same:
``[L, 2, num_blocks * block_size, Hkv * D]`` — per layer and plane (k, v) a
flat slot-major row table with all kv heads in one row. A token at absolute
position ``p`` of a request with block table ``bt`` lives at flat slot
``bt[p // block_size] * block_size + p % block_size``. Block 0 is the
reserved null block: padded block-table entries point there.

Invalid tokens (padding, inactive rows) get slot ``2**30``. The JAX package
relies on scatter ``mode="drop"`` to discard them; ``index_put_`` has no such
mode, so ``write_kv`` masks them explicitly: an invalid row is redirected to
slot 0 and writes back the value slot 0 already holds, which leaves the pool
bit-for-bit unchanged without a host synchronisation.

Quantized pools. An int8 pool keeps, beside the ``[.., NS, Hkv*D]`` int8
data, a ``[.., NS, Hkv]`` bf16 scale per (slot, kv head): symmetric,
``amax / 127`` with a floor of 1e-8, round half to even, clipped to +-127
(``quantize_kv``). An fp8 pool is one ``torch.float8_e4m3fn`` tensor with no
scales: a written value is downcast, attention upcasts. Rows of a 1-byte
float pool move as their bytes (``storage_view``), so no indexing kernel has
to know the type.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_SLOT = 2**30
FP8 = torch.float8_e4m3fn


class SplitPool(NamedTuple):
    """The KV pools of a model that mixes global and sliding-window layers
    (gemma2; the JAX package's ``{"full", "swa"}`` cache): ``full`` is the
    paged pool of the global layers ``[Lf, 2, NS, Hkv*D]``, ``swa`` the
    sliding layers' rings, one a decode slot, ``[Ls, 2, NSw, Hkv*D]``. Each
    is a tensor or an int8 pool's ``{"data", "scale"}`` dict; a NamedTuple,
    so that it is never taken for the int8 dict."""

    full: object
    swa: object


def storage_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or its bytes when it is an fp8 tensor: gathers and
    scatters then run on uint8 and leave every bit as it is."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def token_slots(
    positions: torch.Tensor, block_table: torch.Tensor, block_size: int,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Flat cache slots for tokens at ``positions`` (int64). Invalid -> 2**30.

    positions: [...]; block_table: [..., max_blocks] aligned with positions'
    leading dims (or 1-D for a single sequence); valid: bool [...].
    """
    positions = positions.long()
    block_idx = torch.div(positions, block_size, rounding_mode="floor")
    offs = positions - block_idx * block_size
    bt = block_table.long()
    mb = bt.shape[-1]
    safe_idx = block_idx.clamp(0, mb - 1)  # invalid positions may overrun
    if bt.dim() == 1:
        blocks = bt[safe_idx]
    else:
        blocks = torch.gather(bt, -1, safe_idx)
    slots = blocks * block_size + offs
    return torch.where(valid, slots, torch.full_like(slots, INVALID_SLOT))


def write_kv(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    slots: torch.Tensor,
    null_slot: int = 0,
) -> None:
    """Write new KV rows into the paged cache in place.

    k_cache/v_cache: [num_slots, Hkv*D] (views into the [L, 2, NS, HD] pool
    work: writes land in the pool); k_new/v_new: [T, Hkv, D] or [T, Hkv*D];
    slots: [T] flat slots, out-of-range = dropped (redirected to
    ``null_slot``, a slot no valid row writes: the paged pool's slot 0, in
    the null block; a ring pool's last slot, in its own null block).
    """
    t = k_new.shape[0]
    ns = k_cache.shape[0]
    valid = (slots >= 0) & (slots < ns)
    safe = torch.where(valid, slots, torch.full_like(slots, null_slot))
    keep = valid.unsqueeze(-1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        rows = storage_view(new.reshape(t, -1).to(cache.dtype))
        cache = storage_view(cache)
        # invalid rows rewrite the null slot with its own current contents
        cache[safe] = torch.where(keep, rows, cache[safe])


def quantize_kv(k_new: torch.Tensor, v_new: torch.Tensor):
    """Symmetric per-(token, kv-head) int8 quantization of KV rows.

    k_new/v_new: [T, Hkv, D] -> (rows [T, Hkv*D] int8, scales [T, Hkv] bf16)
    for each. The rows are divided by the f32 scale; the stored scale is its
    bf16 rounding, as in the JAX package.
    """
    # a tensor, not a Python number: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds amax / 127 differently from
    # the true division the CPU (and the JAX package) performs
    qmax = torch.full((), 127.0, dtype=torch.float32, device=k_new.device)

    def q(x):
        xf = x.float()
        scale = (xf.abs().amax(dim=-1) / qmax).clamp_min(1e-8)  # [T, Hkv]
        qx = torch.round(xf / scale[..., None]).clamp(-127, 127)
        return qx.to(torch.int8).reshape(x.shape[0], -1), scale.to(torch.bfloat16)

    kq, ks = q(k_new)
    vq, vs = q(v_new)
    return kq, ks, vq, vs


def write_kv_quant(k_cache, v_cache, k_scale, v_scale, k_new, v_new, slots,
                   null_slot: int = 0) -> None:
    """Quantize KV rows and write them, in place, into an int8 pool and its
    scale tensors.

    k_cache/v_cache: [num_slots, Hkv*D] int8; k_scale/v_scale: [num_slots,
    Hkv] bf16; k_new/v_new: [T, Hkv, D]; slots: [T], out-of-range = dropped
    (data and scales both, masked as ``write_kv`` masks).
    """
    kq, ks, vq, vs = quantize_kv(k_new, v_new)
    write_kv(k_cache, v_cache, kq, vq, slots, null_slot)
    write_kv(k_scale, v_scale, ks, vs, slots, null_slot)
