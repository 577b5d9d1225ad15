"""Canonical weight naming + HF name maps for the dense llama family.

Port of the llama-family entries of ``rtp_llm_tpu/loader/weight_maps.py``:
the llama table (qwen2, qwen3, llama, mistral, yi, internlm with its
``o_proj`` bias), phi3's fused ``qkv_proj`` / ``gate_up_proj`` rows sliced
apart (``hf_slice``) and internlm2's ``wqkv``, grouped per kv head, split
(``hf_transform``), and gemma / gemma2 (the llama table, tied embeddings;
gemma2's sandwich norms ``pre_ffn_norm`` / ``post_ffn_norm``).
Canonical layout: linear kernels are ``[in, out]`` (HF stores ``[out, in]``;
transposed at load) and per-layer tensors are stacked on a leading ``[L]``.

  embed_tokens [V,H]; final_norm [H]; lm_head [H,V]
  input_norm / post_attn_norm [L,H] (+ pre_ffn_norm / post_ffn_norm, gemma2)
  q_proj [L,H,Hq*D] (+ q_bias [L,Hq*D]); k_proj / v_proj likewise
  o_proj [L,Hq*D,H] (+ o_proj.bias [L,H], internlm); q_norm / k_norm [L,D]
  gate_proj / up_proj [L,H,I]; down_proj [L,I,H]
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from rtp_llm_tpu_torch.config.model_config import ModelConfig


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """One canonical tensor: its HF name pattern (``{l}`` = layer index),
    whether it is stacked per layer, whether HF's trailing two dims flip, and
    which canonical dim tensor parallelism would shard (``"out"`` / ``"in"``):
    the mark by which the quantization code knows a linear kernel.
    ``optional``: a checkpoint may lack it. ``hf_slice`` (a, b): rows a..b
    of the HF tensor (a fused checkpoint tensor, before the transpose);
    ``hf_transform``: a reorder of the HF tensor, ``(tensor, cfg) ->
    tensor``, after the slice and before the transpose."""

    name: str
    hf_pattern: str
    per_layer: bool = False
    transpose: bool = False
    shard_axis: Optional[str] = None
    optional: bool = False
    hf_slice: Optional[tuple] = None
    hf_transform: Optional[Callable] = None


def get_weight_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """The spec table of ``cfg.model_type`` (``FAMILY_BUILDERS``)."""
    try:
        specs_of = FAMILY_BUILDERS[cfg.model_type]
    except KeyError:
        raise ValueError(f"no weight map for model_type {cfg.model_type!r}") from None
    return specs_of(cfg)


def _llama_specs(cfg: ModelConfig) -> list[WeightSpec]:
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
        if cfg.model_type == "internlm":  # internlm v1's o_proj carries one too
            specs.append(WeightSpec("o_proj.bias", lay + "self_attn.o_proj.bias",
                                    per_layer=True, optional=True))
    if cfg.use_qk_norm:
        for p in ("q", "k"):
            specs.append(WeightSpec(f"{p}_norm", lay + f"self_attn.{p}_norm.weight",
                                    per_layer=True))
    if cfg.sandwich_norms:  # gemma2
        for p in ("pre", "post"):
            specs.append(WeightSpec(f"{p}_ffn_norm", lay + f"{p}_feedforward_layernorm.weight",
                                    per_layer=True))
    for p in ("gate", "up", "down"):
        specs.append(WeightSpec(f"{p}_proj", lay + f"mlp.{p}_proj.weight",
                                per_layer=True, transpose=True,
                                shard_axis="in" if p == "down" else "out"))
    return specs


def _phi3_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """phi3: the llama layout with fused ``qkv_proj`` and ``gate_up_proj``
    checkpoint tensors, each member's rows sliced out."""
    lay = "model.layers.{l}."
    qd, kvd = cfg.num_attention_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    i = cfg.intermediate_size
    lin = dict(per_layer=True, transpose=True, shard_axis="out")
    return [
        WeightSpec("embed_tokens", "model.embed_tokens.weight"),
        WeightSpec("final_norm", "model.norm.weight"),
        WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"),
        WeightSpec("input_norm", lay + "input_layernorm.weight", per_layer=True),
        WeightSpec("post_attn_norm", lay + "post_attention_layernorm.weight", per_layer=True),
        WeightSpec("q_proj", lay + "self_attn.qkv_proj.weight", hf_slice=(0, qd), **lin),
        WeightSpec("k_proj", lay + "self_attn.qkv_proj.weight", hf_slice=(qd, qd + kvd), **lin),
        WeightSpec("v_proj", lay + "self_attn.qkv_proj.weight",
                   hf_slice=(qd + kvd, qd + 2 * kvd), **lin),
        WeightSpec("o_proj", lay + "self_attn.o_proj.weight", per_layer=True, transpose=True,
                   shard_axis="in"),
        WeightSpec("gate_proj", lay + "mlp.gate_up_proj.weight", hf_slice=(0, i), **lin),
        WeightSpec("up_proj", lay + "mlp.gate_up_proj.weight", hf_slice=(i, 2 * i), **lin),
        WeightSpec("down_proj", lay + "mlp.down_proj.weight", per_layer=True, transpose=True,
                   shard_axis="in"),
    ]


def internlm2_split_qkv(which: int) -> Callable:
    """internlm2's fused ``wqkv`` holds its rows per kv head as ``[Hkv, g +
    2, D]``: the group's g query heads, then one k, one v. ``which`` 0 / 1 /
    2 picks q / k / v."""

    def split(t, cfg):
        hkv = cfg.num_kv_heads
        g = cfg.num_attention_heads // hkv
        t2 = t.reshape(hkv, g + 2, cfg.head_dim, *t.shape[1:])
        sel = t2[:, :g] if which == 0 else t2[:, g + which - 1:g + which]
        return sel.reshape(-1, *t.shape[1:])

    return split


def _internlm2_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """internlm2: llama arithmetic under its own names, a grouped fused
    ``wqkv`` and the w1 / w3 / w2 MLP."""
    lay = "model.layers.{l}."
    lin = dict(per_layer=True, transpose=True)
    specs = [
        WeightSpec("embed_tokens", "model.tok_embeddings.weight"),
        WeightSpec("final_norm", "model.norm.weight"),
        WeightSpec("lm_head", "output.weight", transpose=True, shard_axis="out"),
        WeightSpec("input_norm", lay + "attention_norm.weight", per_layer=True),
        WeightSpec("post_attn_norm", lay + "ffn_norm.weight", per_layer=True),
        WeightSpec("o_proj", lay + "attention.wo.weight", shard_axis="in", **lin),
        WeightSpec("gate_proj", lay + "feed_forward.w1.weight", shard_axis="out", **lin),
        WeightSpec("up_proj", lay + "feed_forward.w3.weight", shard_axis="out", **lin),
        WeightSpec("down_proj", lay + "feed_forward.w2.weight", shard_axis="in", **lin),
    ]
    for j, p in enumerate(("q", "k", "v")):
        specs.append(WeightSpec(f"{p}_proj", lay + "attention.wqkv.weight", shard_axis="out",
                                hf_transform=internlm2_split_qkv(j), **lin))
    return specs


FAMILY_BUILDERS: dict[str, Callable[[ModelConfig], list[WeightSpec]]] = {
    "qwen2": _llama_specs, "qwen3": _llama_specs, "llama": _llama_specs,
    "mistral": _llama_specs, "yi": _llama_specs, "internlm": _llama_specs,
    "internlm2": _internlm2_specs, "phi3": _phi3_specs,
    "gemma": _llama_specs, "gemma2": _llama_specs,
}


def hf_names_for(spec: WeightSpec, num_layers: int) -> list[str]:
    """The concrete HF tensor names a spec expands to, in layer order."""
    if not spec.per_layer:
        return [spec.hf_pattern]
    return [spec.hf_pattern.replace("{l}", str(l)) for l in range(num_layers)]
