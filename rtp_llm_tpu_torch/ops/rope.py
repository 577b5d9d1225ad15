"""Rotary position embeddings (port of ``rtp_llm_tpu/ops/rope.py``).

Frequency tables are computed once on the host in float64 numpy (the same
arithmetic as the JAX package) and handed to torch; application is neox-style
(rotate halves), as HF llama/qwen, or GPT-J pairs (cohere). The partial forms
rotate only the first ``rotary_dim`` dims of a head and pass the rest
through, with tables computed at ``rotary_dim`` (JAX ``rotary_dim =
int(head_dim * partial_rotary_factor)``): half-split for gpt_neox and phi
(``rotate_partial``, JAX ``apply_rope_partial_neox``), pairwise for glm4 and
chatglm (``rotate_pairs_partial``, JAX ``apply_rope_partial_interleaved``).

A ``rope_scaling`` type outside ``ROPE_TYPES`` (Phi-3's 128k ``longrope`` /
``su``, for one) raises ``ValueError`` at load: the JAX package computes the
unscaled tables for it without a word (ROADMAP.md, section C, C7).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


# the rope_scaling types the tables compute ("" / "default": unscaled)
ROPE_TYPES = ("", "default", "linear", "dynamic", "dynamic_ntk", "yarn", "llama3")


def compute_rope_freqs(
    head_dim: int,
    max_len: int,
    theta: float = 10000.0,
    rope_scaling: Optional[dict] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (cos, sin) tables of shape [max_len, head_dim//2] in f32 numpy."""
    if rope_scaling:
        rtype = rope_scaling.get("rope_type", rope_scaling.get("type", ""))
        if rtype not in ROPE_TYPES:
            raise ValueError(f"rope_scaling type {rtype!r} is not computed by the port "
                             f"(it computes {', '.join(t for t in ROPE_TYPES if t)})")
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    attn_factor = 1.0
    if rope_scaling:
        rtype = rope_scaling.get("rope_type", rope_scaling.get("type", ""))
        factor = float(rope_scaling.get("factor", 1.0))
        if rtype == "linear":
            inv_freq = inv_freq / factor
        elif rtype in ("dynamic", "dynamic_ntk"):
            orig_max = rope_scaling.get("original_max_position_embeddings", max_len)
            alpha = factor * max_len / orig_max - (factor - 1)
            theta2 = theta * alpha ** (head_dim / (head_dim - 2))
            inv_freq = 1.0 / (
                theta2 ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
            )
        elif rtype == "yarn":
            orig_max = rope_scaling.get("original_max_position_embeddings", 4096)
            beta_fast = rope_scaling.get("beta_fast", 32.0)
            beta_slow = rope_scaling.get("beta_slow", 1.0)
            inv_freq = _yarn_inv_freq(
                inv_freq, head_dim, theta, orig_max, factor, beta_fast, beta_slow
            )
            attn_factor = float(
                rope_scaling.get("attention_factor")
                or (0.1 * math.log(factor) + 1.0)
            )
        elif rtype == "llama3":
            inv_freq = _llama3_inv_freq(inv_freq, rope_scaling)
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    cos = np.cos(freqs) * attn_factor
    sin = np.sin(freqs) * attn_factor
    return cos.astype(np.float32), sin.astype(np.float32)


def _yarn_inv_freq(inv_freq, head_dim, theta, orig_max, factor, beta_fast, beta_slow):
    def find_dim(num_rot):
        return (head_dim * math.log(orig_max / (num_rot * 2 * math.pi))) / (
            2 * math.log(theta)
        )

    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), head_dim // 2 - 1)
    dims = np.arange(head_dim // 2, dtype=np.float64)
    ramp = np.clip((dims - low) / max(high - low, 1e-3), 0.0, 1.0)
    mask = 1.0 - ramp  # 1 = interpolate (low freq), 0 = extrapolate (high freq)
    return inv_freq / factor * mask + inv_freq * (1.0 - mask)


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
