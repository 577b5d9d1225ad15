"""Canonical weight naming + HF name map for the dense llama family.

Port of the llama-family entries of ``rtp_llm_tpu/loader/weight_maps.py``.
Canonical layout: linear kernels are ``[in, out]`` (HF stores ``[out, in]``;
transposed at load) and per-layer tensors are stacked on a leading ``[L]``.

  embed_tokens [V,H]; final_norm [H]; lm_head [H,V]
  input_norm / post_attn_norm [L,H]
  q_proj [L,H,Hq*D] (+ q_bias [L,Hq*D]); k_proj / v_proj likewise
  o_proj [L,Hq*D,H]; q_norm / k_norm [L,D]
  gate_proj / up_proj [L,H,I]; down_proj [L,I,H]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from rtp_llm_tpu_torch.config.model_config import ModelConfig


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """One canonical tensor: its HF name pattern (``{l}`` = layer index),
    whether it is stacked per layer, whether HF's trailing two dims flip, and
    which canonical dim tensor parallelism would shard (``"out"`` / ``"in"``):
    the mark by which the quantization code knows a linear kernel."""

    name: str
    hf_pattern: str
    per_layer: bool = False
    transpose: bool = False
    shard_axis: Optional[str] = None


def get_weight_specs(cfg: ModelConfig) -> list[WeightSpec]:
    lay = "model.layers.{l}."
    specs = [
        WeightSpec("embed_tokens", "model.embed_tokens.weight"),
        WeightSpec("final_norm", "model.norm.weight"),
        WeightSpec("input_norm", lay + "input_layernorm.weight", per_layer=True),
        WeightSpec("post_attn_norm", lay + "post_attention_layernorm.weight", per_layer=True),
    ]
    for p in ("q", "k", "v", "o"):
        specs.append(WeightSpec(f"{p}_proj", lay + f"self_attn.{p}_proj.weight",
                                per_layer=True, transpose=True,
                                shard_axis="in" if p == "o" else "out"))
    if not cfg.tie_word_embeddings:
        specs.append(WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"))
    if cfg.attention_bias:
        for p in ("q", "k", "v"):
            specs.append(WeightSpec(f"{p}_bias", lay + f"self_attn.{p}_proj.bias",
                                    per_layer=True, shard_axis="out"))
    if cfg.use_qk_norm:
        for p in ("q", "k"):
            specs.append(WeightSpec(f"{p}_norm", lay + f"self_attn.{p}_norm.weight",
                                    per_layer=True))
    for p in ("gate", "up", "down"):
        specs.append(WeightSpec(f"{p}_proj", lay + f"mlp.{p}_proj.weight",
                                per_layer=True, transpose=True,
                                shard_axis="in" if p == "down" else "out"))
    return specs


def hf_names_for(spec: WeightSpec, num_layers: int) -> list[str]:
    """The concrete HF tensor names a spec expands to, in layer order."""
    if not spec.per_layer:
        return [spec.hf_pattern]
    return [spec.hf_pattern.replace("{l}", str(l)) for l in range(num_layers)]
