"""GPTQ / AWQ checkpoint ingestion: packed int4 HF tensors -> canonical
quantized weights. Port of ``rtp_llm_tpu/quant/gptq_awq.py`` on torch tensors.

Both formats store 4-bit values packed into int32 with per-group scales and
zeros over the *input* dim (group size g, typically 128):

  GPTQ: qweight [in/8, out] i32 (8 nibbles along input, LSB first),
        qzeros  [in/g, out/8] i32 (8 nibbles along out, LSB first),
        scales  [in/g, out] f16, optional g_idx [in] (act-order).
  AWQ:  qweight [in, out/8] i32 (8 nibbles along out, order 0,2,4,6,1,3,5,7),
        qzeros  [in/g, out/8] i32 (same nibble order), scales [in/g, out] f16.

Dequant: W[i, o] = (q[i, o] - z[g(i), o]) * s[g(i), o].

``(q >> 4*j) & 0xF`` on int32 is right under torch's arithmetic shift too:
the sign bits it drags in lie above the four kept bits.
"""

from __future__ import annotations

from typing import Optional

import torch

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)  # nibble j of a word holds logical column AWQ_ORDER[j]
_AWQ_NIBBLE_OF_COLUMN = (0, 4, 1, 5, 2, 6, 3, 7)  # its inverse
_SHIFTS = tuple(range(0, 32, 4))


def _nibbles(t: torch.Tensor) -> torch.Tensor:
    """i32 [...] -> u8 [..., 8]: the eight nibbles of each word, LSB first."""
    t = t.to(torch.int32)
    return torch.stack([(t >> s) & 0xF for s in _SHIFTS], dim=-1).to(torch.uint8)


def unpack_gptq_qweight(qweight: torch.Tensor) -> torch.Tensor:
    """[in/8, out] i32 -> [in, out] u8 (values 0..15)."""
    kq, n = qweight.shape
    return _nibbles(qweight).permute(0, 2, 1).reshape(kq * 8, n)


def unpack_gptq_qzeros(qzeros: torch.Tensor) -> torch.Tensor:
    """[in/g, out/8] i32 -> [in/g, out] u8."""
    g, nq = qzeros.shape
    return _nibbles(qzeros).reshape(g, nq * 8)


def unpack_awq_qweight(qweight: torch.Tensor) -> torch.Tensor:
    """[in, out/8] i32 -> [in, out] u8 (AWQ's interleaved nibble order)."""
    k, nq = qweight.shape
    return _nibbles(qweight)[:, :, list(_AWQ_NIBBLE_OF_COLUMN)].reshape(k, nq * 8)


def unpack_awq_qzeros(qzeros: torch.Tensor) -> torch.Tensor:
    return unpack_awq_qweight(qzeros)


def dequant_reference(q, zeros, scales, group_size: int) -> torch.Tensor:
    """[in, out] u8, [in/g, out], [in/g, out] -> [in, out] f32 (for tests)."""
    gi = torch.arange(q.shape[0], device=q.device) // group_size
    return (q.float() - zeros[gi].float()) * scales[gi].float()


def gptq_to_canonical(qweight, qzeros, scales, g_idx: Optional[torch.Tensor] = None):
    """Returns (values i8 [in, out] holding the raw 0..15 codes, scale f32
    [in/g, out], zero f32 [in/g, out], act_perm i32 [in] or None); dequant
    is (v - z) * s.

    Stored zeros follow the AutoGPTQ convention: true zero = stored + 1.
    Act-order (desc_act) checkpoints: ``g_idx`` assigns input rows to groups
    out of order; the rows are stable-sorted by group, so that each group's
    rows are contiguous as the groupwise kernels read them, and
    ``act_perm`` is that permutation of the input features: the product is
    ``x[:, act_perm] @ W``. A monotonic ``g_idx`` (rows already in group
    order) gives None."""
    q = unpack_gptq_qweight(qweight)
    z = unpack_gptq_qzeros(qzeros)
    s = scales.float()
    k = q.shape[0]
    perm = None
    if g_idx is not None:
        g_idx = g_idx.to(torch.int64)
        natural = torch.arange(k, device=g_idx.device) // (k // s.shape[0])
        if not torch.equal(g_idx, natural):
            perm = torch.argsort(g_idx, stable=True).to(torch.int32)
            q = q[perm.long()]
    return q.to(torch.int8), s, z.float() + 1.0, perm


def awq_to_canonical(qweight, qzeros, scales):
    return (unpack_awq_qweight(qweight).to(torch.int8), scales.float(),
            unpack_awq_qzeros(qzeros).float())
