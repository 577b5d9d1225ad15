"""Activation ops (port of ``rtp_llm_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_and_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU elementwise: silu(gate) * up."""
    return F.silu(gate) * up


def gelu_tanh_and_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """GeGLU elementwise (gemma): gelu(gate), tanh approximation, * up."""
    return F.gelu(gate, approximate="tanh") * up


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu, tanh approximation (starcoder2's and bloom's non-gated MLP)."""
    return F.gelu(x, approximate="tanh")


# the gated activation of each ``ModelConfig.hidden_act``
ACT_AND_MUL = {"silu": silu_and_mul, "gelu_tanh": gelu_tanh_and_mul}
# the activation alone, for a non-gated MLP ``down(act(up(x)))``; "gelu" is
# exact (erf): mpt's and falcon's (HF ``GELUActivation``)
ACT = {"silu": F.silu, "gelu_tanh": gelu_tanh, "gelu": F.gelu}
