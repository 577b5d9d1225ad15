"""Activation ops (port of ``rtp_llm_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_and_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU elementwise: silu(gate) * up."""
    return F.silu(gate) * up
