"""Rotary position embeddings (port of ``rtp_llm_tpu/ops/rope.py``).

Frequency tables are computed once on the host in float64 numpy (the same
arithmetic as the JAX package) and handed to torch; application is neox-style
(rotate halves), as HF llama/qwen, or GPT-J pairs (cohere). The partial forms
rotate only the first ``rotary_dim`` dims of a head and pass the rest
through, with tables computed at ``rotary_dim`` (JAX ``rotary_dim =
int(head_dim * partial_rotary_factor)``): half-split for gpt_neox and phi
(``rotate_partial``, JAX ``apply_rope_partial_neox``), pairwise for glm4 and
chatglm (``rotate_pairs_partial``, JAX ``apply_rope_partial_interleaved``).

The scaled tables follow HF ``transformers.modeling_rope_utils``, which
the JAX package departs from in two (ROADMAP.md, section C): YaRN's ramp
(C25: HF keeps ``inv_freq`` on the high-frequency dims and divides the
low-frequency ones by ``factor``, clamps the ramp's top at ``dim - 1``, and
takes a missing ``original_max_position_embeddings`` as
``max_position_embeddings``; the JAX package divides the high-frequency dims,
clamps at ``dim // 2 - 1`` and defaults to 4096) and dynamic NTK (C26: HF's
table is the unscaled one up to ``max_position_embeddings`` whatever
``original_max_position_embeddings`` says, and an engine never serves past
it; the JAX package raises the base for every position).

Phi-3's ``longrope`` (``su``) keeps two tables, from the config's
``short_factor`` and ``long_factor``, both scaled by ``attention_factor``
(default sqrt(1 + ln(f) / ln(orig)), f = ``max_position_embeddings`` /
orig). HF picks one a forward by ``max(position_ids) + 1 > orig``; the port
picks one a stream (``rope_switch``, the model's gather), so that a batch
never changes a stream's answer. A ``rope_scaling`` type outside
``ROPE_TYPES`` raises ``ValueError`` at load: the JAX package computes the
unscaled tables for it without a word (C7).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


# the rope_scaling types the tables compute ("" / "default": unscaled)
ROPE_TYPES = ("", "default", "linear", "dynamic", "dynamic_ntk", "yarn", "llama3",
              "longrope", "su")
LONGROPE_TYPES = ("longrope", "su")


def rope_type(rope_scaling: Optional[dict]) -> str:
    """The ``rope_type`` (or older ``type``) of a ``rope_scaling`` dict, ""
    for none."""
    if not rope_scaling:
        return ""
    return rope_scaling.get("rope_type", rope_scaling.get("type", "")) or ""


def rope_switch(rope_scaling: Optional[dict], max_position_embeddings: int) -> int:
    """The length past which a stream takes longrope's long table: the
    ``original_max_position_embeddings`` (``ModelConfig.from_hf_config``
    copies Phi-3's top-level key into the dict), else
    ``max_position_embeddings``; 0 for every other type (one table)."""
    if rope_type(rope_scaling) not in LONGROPE_TYPES:
        return 0
    return int(rope_scaling.get("original_max_position_embeddings")
               or max_position_embeddings)


def compute_rope_freqs(
    head_dim: int,
    max_len: int,
    theta: float = 10000.0,
    rope_scaling: Optional[dict] = None,
    max_position_embeddings: Optional[int] = None,
    long: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (cos, sin) tables of shape [max_len, head_dim//2] in f32 numpy.
    ``max_position_embeddings`` (default ``max_len``) is the config's: YaRN's
    default original length and dynamic NTK's cap. ``long`` picks
    longrope's long table (``long_factor``) over the short one.

    The unscaled, linear, dynamic and llama3 tables are the JAX package's,
    bit for bit (f64 frequencies and angles, rounded once); the YaRN and
    longrope ones, which the JAX package computes otherwise or not at all,
    are HF's, with its f32 arithmetic."""
    rtype = rope_type(rope_scaling)
    if rtype not in ROPE_TYPES:
        raise ValueError(f"rope_scaling type {rtype!r} is not computed by the port "
                         f"(it computes {', '.join(t for t in ROPE_TYPES if t)})")
    max_pos = max_position_embeddings or max_len
    if rtype == "yarn" or rtype in LONGROPE_TYPES:
        inv, attn = (_yarn(head_dim, theta, max_pos, rope_scaling) if rtype == "yarn"
                     else _longrope(head_dim, theta, max_pos, rope_scaling, long))
        freqs = torch.arange(max_len, dtype=torch.float32)[:, None] * inv[None, :]
        return (freqs.cos() * attn).numpy(), (freqs.sin() * attn).numpy()
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if rtype == "linear":
        inv_freq = inv_freq / float(rope_scaling.get("factor", 1.0))
    elif rtype == "llama3":
        inv_freq = _llama3_inv_freq(inv_freq, rope_scaling)
    # dynamic NTK: HF rescales only past max_position_embeddings, where the
    # port never serves (C26): the unscaled table
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def _yarn(head_dim, theta, max_pos, rs):
    """HF ``_compute_yarn_parameters`` (f32): (inverse frequencies, attention
    factor). Dims below the ramp (high frequency) keep ``inv_freq``, dims
    above it take ``inv_freq / factor``."""
    factor = float(rs["factor"])
    orig = rs.get("original_max_position_embeddings") or max_pos
    beta_fast = rs.get("beta_fast") or 32
    beta_slow = rs.get("beta_slow") or 1

    def find_dim(num_rot):
        return (head_dim * math.log(orig / (num_rot * 2 * math.pi))) / (2 * math.log(theta))

    low, high = find_dim(beta_fast), find_dim(beta_slow)
    if rs.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001  # HF's guard against a zero-width ramp
    pos_freqs = theta ** (torch.arange(0, head_dim, 2).float() / head_dim)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    extrapolation = 1 - ramp  # 1: keep inv_freq (high frequency)
    inv_freq = (1.0 / (factor * pos_freqs) * (1 - extrapolation)
                + 1.0 / pos_freqs * extrapolation)

    def mscale(scale, m=1.0):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    attn = rs.get("attention_factor")
    if attn is None:
        m, m_all = rs.get("mscale"), rs.get("mscale_all_dim")
        attn = mscale(factor, m) / mscale(factor, m_all) if m and m_all else mscale(factor)
    return inv_freq, float(attn)


def _longrope(head_dim, theta, max_pos, rs, long):
    """HF ``_compute_longrope_parameters`` (f32): the short or long table's
    inverse frequencies ``1 / (ext * theta^(2i / d))`` and the attention
    factor both tables share."""
    orig = rope_switch(rs, max_pos)
    factor = max_pos / orig if rs.get("original_max_position_embeddings") else rs.get("factor")
    attn = rs.get("attention_factor")
    if attn is None:
        attn = (1.0 if factor is None or factor <= 1.0
                else math.sqrt(1 + math.log(factor) / math.log(orig)))
    ext = torch.tensor(rs["long_factor" if long else "short_factor"], dtype=torch.float32)
    if ext.shape != (head_dim // 2,):
        raise ValueError(f"longrope: {'long' if long else 'short'}_factor has {ext.numel()} "
                         f"entries; the rotated width {head_dim} needs {head_dim // 2}")
    shape = torch.arange(0, head_dim, 2, dtype=torch.int64).float() / head_dim
    return 1.0 / (ext * theta ** shape), float(attn)


def _llama3_inv_freq(inv_freq, rope_scaling):
    factor = float(rope_scaling.get("factor", 8.0))
    low_factor = float(rope_scaling.get("low_freq_factor", 1.0))
    high_factor = float(rope_scaling.get("high_freq_factor", 4.0))
    orig_max = float(rope_scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2 * math.pi / inv_freq
    low_wavelen = orig_max / low_factor
    high_wavelen = orig_max / high_factor
    out = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (orig_max / wavelen - low_factor) / (high_factor - low_factor)
    smoothed = (1 - smooth) * inv_freq / factor + smooth * inv_freq
    is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(is_mid, smoothed, out)


def rope_at(positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """The (cos, sin) rows for ``positions``, shaped [..., 1, half] to
    broadcast over heads. A model gathers them once per forward."""
    return cos[positions].unsqueeze(-2), sin[positions].unsqueeze(-2)


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Neox-style rotation of x [..., heads, head_dim] by gathered rows."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def rotate_pairs(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """GPT-J pair rotation of x [..., heads, head_dim] by gathered rows
    (cohere): pair (2i, 2i + 1) turns by angle i, over the whole head (JAX
    ``apply_rope_partial_interleaved`` at ``rotary_dim = head_dim``)."""
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([even * c - odd * s, odd * c + even * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rotate_partial(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Neox-style rotation of the first ``rotary_dim = 2 * c.shape[-1]``
    dims of x [..., heads, head_dim]; the rest pass through untouched (JAX
    ``apply_rope_partial_neox``: the rotated slice rounds to x's type alone)."""
    r = 2 * c.shape[-1]
    return torch.cat([rotate(x[..., :r], c, s), x[..., r:]], dim=-1)


def rotate_pairs_partial(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """GPT-J pair rotation of the first ``rotary_dim = 2 * c.shape[-1]`` dims
    of x [..., heads, head_dim] (glm4, chatglm: pair (2i, 2i + 1) of the
    slice turns by angle i); the rest pass through untouched (JAX
    ``apply_rope_partial_interleaved``)."""
    r = 2 * c.shape[-1]
    return torch.cat([rotate_pairs(x[..., :r], c, s), x[..., r:]], dim=-1)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Apply neox-style rotary embedding.

    x: [..., heads, head_dim]; positions: broadcastable to x.shape[:-2];
    cos/sin: [max_len, head_dim//2] f32 tensors on x's device. Rotation pairs
    (i, i + head_dim//2) — matches HF llama/qwen.
    """
    return rotate(x, *rope_at(positions, cos, sin))
