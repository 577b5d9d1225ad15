"""Load-time weight quantization: per-channel int8, fp8 (e4m3), W8A8, W4A8
and symmetric groupwise int4 and fp4 (e2m1). Port of the dense routes of
``rtp_llm_tpu/quant/weight_only.py``, written on torch tensors so that a
full-width model quantizes on the card. Codes and scales equal the JAX
package's bit for bit, except one route named below.

Storage (canonical kernels are ``[..., in, out]``):
  int8:  {name: i8 [..., in, out], name.scale: f32 [..., out]}
  fp8:   {name: e4m3 [..., in, out], name.scale: f32 ``[...]`` (block 0:
          one scale a tensor), ``[..., out]`` (block -1) or
          ``[..., in/block, out]`` (block > 0, each block's scale repeated
          over its out columns)}
  w8a8:  int8 plus the ``name.w8a8`` marker (per-token int8 activations)
  w4a8:  {name: i8 [..., in, out] holding int4 values in [-7, 7],
          name.scale: f32 [..., in/G, out], name.w4a8: marker}
  int4:  {name: u8 [..., in/2, out] split-half packed offset codes,
          name.scale: f32 [..., in/G, out], name.int4p: marker}
  fp4:   {name: u8 [..., in/2, out] split-half packed e2m1 codes,
          name.scale: f32 [..., in/32, out], name.fp4: marker}
  lm_head with ``quantize_lm_head``: int8 whatever the trunk's method.
An in dim that does not pack at the 4-bit group (``K % (2 * group)``) takes
the per-channel int8 form. The 8-bit forms run through
``ops/quant_gemm8.py``, the packed 4-bit ones through ``ops/quant_gemm.py``.

Per-tensor fp8 (block 0, also the fallback of an in dim that is not a
multiple of the block) takes one scale per layer of a stacked linear
(``[L]``). The JAX package takes one scale over the whole ``[L, in, out]``
stack, a 0-d array that its forward then indexes per layer and fails on
(ROADMAP.md, section C).

Not ported (``NotImplementedError``): quantized expert stacks (MoE).
"""

from __future__ import annotations

from typing import Optional

import torch

from rtp_llm_tpu_torch.config.engine_config import QuantConfig, QuantMethod
from rtp_llm_tpu_torch.loader.weight_maps import WeightSpec
from rtp_llm_tpu_torch.ops.quant_gemm import pack_split_half
from rtp_llm_tpu_torch.ops.quant_gemm8 import FP8, true_div

MARKER = True  # a plain entry: only its presence (``name + ".int4p" in w``) is tested

# canonical names never quantized (embeddings feed gathers; norms are tiny)
_NEVER = {"embed_tokens", "final_norm", "input_norm", "post_attn_norm",
          "q_norm", "k_norm", "router", "router_bias", "shared_expert_gate"}

E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
FP4_GROUP = 32  # MXFP4 group size
FP8_MAX = 448.0  # float8_e4m3fn


def _per_matrix(fn, w: torch.Tensor):
    """``fn`` on each ``[in, out]`` matrix of ``w [..., in, out]``, the
    results stacked back: a full-width stack quantizes one layer's f32 copy
    at a time."""
    if w.dim() == 2:
        return fn(w)
    outs = [fn(m) for m in w.reshape(-1, *w.shape[-2:])]
    return tuple(torch.stack(o).reshape(*w.shape[:-2], *o[0].shape) for o in zip(*outs))


def int8_quantize(w: torch.Tensor):
    """Symmetric per-out-channel int8: w ~= q * scale, scale ``[..., out]``.
    As the JAX package: x times the f32 reciprocal of the scale, rint, clip
    (a multiply, not a division)."""
    def one(m):
        m = m.float()
        scale = true_div(m.abs().amax(dim=-2).clamp_min(1e-10), 127.0)
        q = m * torch.div(torch.ones_like(scale), scale)
        return torch.round(q).clamp_(-127, 127).to(torch.int8), scale
    return _per_matrix(one, w)


def fp8_quantize(w: torch.Tensor, block: int = 0):
    """fp8 e4m3 codes and f32 scales of ``w [..., in, out]``: ``block`` 0 one
    scale a matrix (0-d; ``[L]`` for a stack), -1 one per out channel
    ``[..., out]``, > 0 one per (block x block) tile stored expanded to
    ``[..., in/block, out]``. Divides, then converts to e4m3 with
    round-to-nearest-even."""
    def per_tensor(m):
        m = m.float()
        amax = m.abs().amax()
        # the JAX package divides a Python float (f64) and rounds to f32
        scale = true_div(torch.where(amax > 0, amax.double(), 1e-8), FP8_MAX).float()
        return (m / scale).to(FP8), scale

    def per_channel(m):
        m = m.float()
        scale = true_div(m.abs().amax(dim=-2).clamp_min(1e-8), FP8_MAX)
        return (m / scale).to(FP8), scale

    def per_block(m):
        m = m.float()
        k, n = m.shape
        gi, go = max(k // block, 1), max(n // block, 1)
        bi, bo = k // gi, n // go
        mb = m.reshape(gi, bi, go, bo)
        scale = true_div(mb.abs().amax(dim=(1, 3), keepdim=True).clamp_min(1e-8), FP8_MAX)
        q = (mb / scale).to(FP8).reshape(k, n)
        return q, scale[:, 0, :, 0].repeat_interleave(bo, dim=-1)

    fn = per_channel if block == -1 else per_tensor if block <= 0 else per_block
    return _per_matrix(fn, w)


def int4_quantize_groupwise(w: torch.Tensor, group_size: int):
    """Symmetric groupwise int4 (int8 storage, values in [-7, 7]) with one
    scale per (group, out). w ``[..., in, out]``, in % group_size == 0."""
    *lead, k, n = w.shape
    g = k // group_size
    wg = w.reshape(*lead, g, group_size, n)
    scale = true_div(wg.abs().amax(dim=-2, keepdim=True), 7.0).float()
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
    scale = true_div(wg.abs().amax(dim=-2, keepdim=True).clamp_min(1e-10), 6.0)
    if e8m0_scales:
        scale = torch.exp2(torch.ceil(torch.log2(scale)))
    scaled = wg / scale
    code = _e2m1_encode(scaled.abs()) | ((scaled < 0).to(torch.uint8) << 3)
    return (pack_split_half(code.reshape(*lead, k, n), code="e2m1"),
            scale.squeeze(-2).float())


def _int8_entry(arr: torch.Tensor) -> dict:
    q, s = int8_quantize(arr)
    return {"": q, ".scale": s}


def make_quant_transform(quant: QuantConfig):
    """Loader transform implementing ``QuantConfig`` (None for no-op):
    ``transform(spec, tensor) -> {suffix: tensor or marker}``."""
    if not quant.is_quantized:
        return None
    method = quant.method

    def transform(spec: WeightSpec, arr: torch.Tensor) -> Optional[dict]:
        if spec.name == "lm_head" and quant.quantize_lm_head:
            return _int8_entry(arr)
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
            raise NotImplementedError(
                "quantization of expert stacks is not ported (ROADMAP.md, A11 step 1b: "
                "quantized experts through parallel/ep_moe.py's capacity path)")
        k = arr.shape[-2]
        if method in (QuantMethod.WEIGHT_ONLY_INT8, QuantMethod.W8A8):
            out = _int8_entry(arr)
            if method == QuantMethod.W8A8:
                out[".w8a8"] = MARKER
            return out
        if method in (QuantMethod.WEIGHT_ONLY_INT4, QuantMethod.W4A8):
            if k % (2 * quant.group_size):
                return _int8_entry(arr)
            q, s = int4_quantize_groupwise(arr.float(), quant.group_size)
            if method == QuantMethod.W4A8:
                return {"": q, ".scale": s, ".w4a8": MARKER}
            return {"": pack_split_half(q), ".scale": s, ".int4p": MARKER}
        if method == QuantMethod.FP4:
            if k % (2 * FP4_GROUP):
                return _int8_entry(arr)
            q, s = fp4_quantize_groupwise(arr.float())
            return {"": q, ".scale": s, ".fp4": MARKER}
        if method == QuantMethod.FP8:
            block = quant.fp8_block_size
            if block and k % block:
                block = 0  # irregular shapes fall back to per-tensor
            q, s = fp8_quantize(arr, block)
            return {"": q, ".scale": s}
        raise NotImplementedError(f"load-time quantization method {method.value!r}")

    return transform
