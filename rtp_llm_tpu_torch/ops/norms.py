"""Normalization ops (port of ``rtp_llm_tpu/ops/norms.py``): RMSNorm, the
weight-only LayerNorm and the biased LayerNorm.

Accumulation is in f32 whatever the input dtype; the output keeps x's dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 accumulation, output in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)


def layer_norm_nobias(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean-centred, weight-only LayerNorm (cohere) in f32, output in
    x.dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    normed = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with its bias (starcoder2) in f32, output in x.dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    normed = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float() + bias.float()).to(x.dtype)


# the norm of each ``ModelConfig.norm_type`` where a site has no bias: a
# "layernorm" site without one is a LayerNorm of zero bias (HF's; the JAX
# package runs RMSNorm there, ROADMAP C12)
NORMS = {"rmsnorm": rms_norm, "layernorm_nobias": layer_norm_nobias,
         "layernorm": layer_norm_nobias}
