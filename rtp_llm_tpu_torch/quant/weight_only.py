"""Load-time 4-bit weight quantization: symmetric groupwise int4 and fp4
(e2m1). Port of the 4-bit routes of ``rtp_llm_tpu/quant/weight_only.py``,
written on torch tensors so that a full-width model quantizes on the card.

Storage (canonical kernels are ``[..., in, out]``):
  int4: {name: u8 [..., in/2, out] split-half packed offset codes,
         name.scale: f32 [..., in/G, out], name.int4p: marker}
  fp4:  {name: u8 [..., in/2, out] split-half packed e2m1 codes,
         name.scale: f32 [..., in/32, out], name.fp4: marker}
Both are consumed by ``ops/quant_gemm.groupwise_matmul_packed``.

Not ported (each raises ``NotImplementedError``; see ROADMAP.md section A):
per-channel int8, fp8, w8a8, w4a8, the int8 LM head (``quantize_lm_head``),
4-bit expert stacks, and in dims that do not pack (``K % (2 * group) != 0``,
which the JAX package stores as per-channel int8).
"""

from __future__ import annotations

from typing import Optional

import torch

from rtp_llm_tpu_torch.config.engine_config import QuantConfig, QuantMethod
from rtp_llm_tpu_torch.loader.weight_maps import WeightSpec
from rtp_llm_tpu_torch.ops.quant_gemm import pack_split_half

MARKER = True  # a plain entry: only its presence (``name + ".int4p" in w``) is tested

# canonical names never quantized (embeddings feed gathers; norms are tiny)
_NEVER = {"embed_tokens", "final_norm", "input_norm", "post_attn_norm",
          "q_norm", "k_norm", "router", "router_bias", "shared_expert_gate"}

E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
FP4_GROUP = 32  # MXFP4 group size


def int4_quantize_groupwise(w: torch.Tensor, group_size: int):
    """Symmetric groupwise int4 (int8 storage, values in [-7, 7]) with one
    scale per (group, out). w ``[..., in, out]``, in % group_size == 0."""
    *lead, k, n = w.shape
    g = k // group_size
    wg = w.reshape(*lead, g, group_size, n)
    scale = (wg.abs().amax(dim=-2, keepdim=True) / 7.0).float()
    q = torch.clamp(torch.round(wg / scale.clamp_min(1e-10)), -7, 7).to(torch.int8)
    return q.reshape(*lead, k, n), scale.squeeze(-2)


def _e2m1_encode(mag: torch.Tensor) -> torch.Tensor:
    """Nearest-value e2m1 magnitude code (0..7) for non-negative inputs."""
    vals = torch.tensor(E2M1_VALUES, dtype=torch.float32, device=mag.device)
    mids = (vals[1:] + vals[:-1]) / 2.0
    return torch.bucketize(mag, mids, right=True).to(torch.uint8)


def fp4_quantize_groupwise(w: torch.Tensor, group_size: int = FP4_GROUP,
                           e8m0_scales: bool = False):
    """w ``[..., in, out]`` -> (packed u8 ``[..., in/2, out]``, scale f32
    ``[..., in/G, out]``). The per-(group, out) scale maps the group's amax
    onto e2m1's largest value (6.0); ``e8m0_scales`` rounds scales up to
    powers of two (MXFP4). Codes are packed split-half along the in dim."""
    *lead, k, n = w.shape
    g = k // group_size
    wg = w.float().reshape(*lead, g, group_size, n)
    scale = wg.abs().amax(dim=-2, keepdim=True).clamp_min(1e-10) / 6.0
    if e8m0_scales:
        scale = torch.exp2(torch.ceil(torch.log2(scale)))
    scaled = wg / scale
    code = _e2m1_encode(scaled.abs()) | ((scaled < 0).to(torch.uint8) << 3)
    return (pack_split_half(code.reshape(*lead, k, n), code="e2m1"),
            scale.squeeze(-2).float())


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported (ROADMAP.md, section A)")


def make_quant_transform(quant: QuantConfig):
    """Loader transform implementing ``QuantConfig`` (None for no-op):
    ``transform(spec, tensor) -> {suffix: tensor or marker}``."""
    if not quant.is_quantized:
        return None
    if quant.method not in (QuantMethod.WEIGHT_ONLY_INT4, QuantMethod.FP4):
        raise _not_ported(f"load-time quantization method {quant.method.value!r}")
    if quant.quantize_lm_head:
        raise _not_ported("the per-channel int8 LM head (quantize_lm_head)")
    fp4 = quant.method == QuantMethod.FP4
    group = FP4_GROUP if fp4 else quant.group_size

    def transform(spec: WeightSpec, arr: torch.Tensor) -> Optional[dict]:
        quantize = (
            spec.name not in _NEVER
            and not spec.name.endswith("_bias")
            and not spec.name.endswith("_norm")
            and arr.dim() >= 2
            and spec.shard_axis in ("out", "in", "expert")
            and spec.name != "lm_head"
        )
        if not quantize:
            return {"": arr.to(torch.bfloat16)}
        if spec.shard_axis == "expert":
            raise _not_ported("4-bit quantization of expert stacks")
        if arr.shape[-2] % (2 * group) != 0:
            raise _not_ported(
                f"{spec.name}: an in dim of {arr.shape[-2]} does not pack at group "
                f"{group}; the int8 groupwise path for unpackable shapes")
        if fp4:
            q, s = fp4_quantize_groupwise(arr.float())
            return {"": q, ".scale": s, ".fp4": MARKER}
        q, s = int4_quantize_groupwise(arr.float(), group)
        return {"": pack_split_half(q), ".scale": s, ".int4p": MARKER}

    return transform
