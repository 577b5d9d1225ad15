"""Canonical weight naming + HF name maps for the dense llama family.

Port of the llama-family entries of ``rtp_llm_tpu/loader/weight_maps.py``:
the llama table (qwen2, qwen3, llama, mistral, yi, internlm with its
``o_proj`` bias), phi3's fused ``qkv_proj`` / ``gate_up_proj`` rows sliced
apart (``hf_slice``) and internlm2's ``wqkv``, grouped per kv head, split
(``hf_transform``), gemma / gemma2 (the llama table, tied embeddings;
gemma2's sandwich norms ``pre_ffn_norm`` / ``post_ffn_norm``), cohere (the
llama table without ``post_attn_norm``: one norm feeds the parallel
attention and MLP; its q / k norms per head) and starcoder2 (its own table:
LayerNorm weight + bias pairs, ``q/k/v/o_proj.bias``, ``mlp.c_fc`` /
``mlp.c_proj`` and their biases as ``up_proj`` / ``down_proj``), baichuan /
baichuan2 (the llama table with a fused ``W_pack`` cut in thirds), bloom and
falcon's multi-head form (a ``query_key_value`` fused per head as ``[Hq, 3,
D]``, split by ``split_qkv_per_head``; bloom's ``embed_norm``; biases under
``<linear>.bias``; their names with or without the ``transformer.`` prefix,
``OPTIONAL_PREFIX``) and mpt (a ``Wqkv`` cut in thirds, norms and linears
whose biases come only with ``no_bias`` false); falcon's multi-query form
(``query_key_value`` as contiguous ``[q (all heads); k; v]``) and its
new-decoder form (grouped per kv head as ``[Hkv, G + 2, D]``, HF
``_split_heads``, ROADMAP C20; ``ln_attn`` / ``ln_mlp`` as ``input_norm`` /
``post_attn_norm``, C21); gpt_bigcode (``wte``, learned positions ``wpe`` as
``pos_embed``, biased ``ln_1`` / ``ln_2`` / ``ln_f``, a ``c_attn`` cut
contiguously under ``multi_query`` and per head without it, C22, biased
``c_proj`` / ``c_fc``); the partial-rotary families: glm4 (q / k / v with
their biases, ``post_self_attn_layernorm`` / ``post_attention_layernorm`` /
``post_mlp_layernorm`` as gemma2's sandwich ``post_attn_norm`` /
``pre_ffn_norm`` / ``post_ffn_norm``, a fused ``gate_up_proj`` cut in
halves), chatglm (a ``query_key_value`` cut contiguously at ``[q, k, v]``
with its biases, ``dense_h_to_4h`` as ``[gate | up]``), gpt_neox (a
``query_key_value`` fused per head as ``[Hq, 3, D]``, biased LayerNorms and
linears, ``embed_out`` as the head), phi (biased LayerNorms and linears,
``dense`` / ``fc1`` / ``fc2``, the LM head's ``lm_head.bias``) and qwen v1
(``c_attn`` cut in thirds with its biases, ``w2`` the gate and ``w1`` the up
branch of HF's ``QWenMLP``); the mixture-of-experts trunks: qwen2_moe /
qwen3_moe (the llama table's attention; ``mlp.gate`` the router,
``mlp.experts.{e}.gate_proj`` / ``up_proj`` / ``down_proj`` stacked a layer,
qwen2_moe's ``mlp.shared_expert.*`` and ``mlp.shared_expert_gate``, a dense
layer's ``mlp.*_proj``) and mixtral (``block_sparse_moe.gate`` and
``experts.{e}.w1`` / ``w3`` / ``w2`` as gate / up / down). An alias
(``config.model_config.arch_of``) takes its trunk's table.
Canonical layout: linear kernels are ``[in, out]`` (HF stores ``[out, in]``;
transposed at load) and per-layer tensors are stacked on a leading ``[L]``.

  embed_tokens [V,H]; final_norm [H]; lm_head [H,V]
  input_norm / post_attn_norm [L,H] (+ pre_ffn_norm / post_ffn_norm, gemma2)
  q_proj [L,H,Hq*D] (+ q_bias [L,Hq*D]); k_proj / v_proj likewise
  o_proj [L,Hq*D,H] (+ o_proj.bias [L,H], internlm); q_norm / k_norm [L,D]
  (cohere: [L,Hq,D] / [L,Hkv,D])
  gate_proj / up_proj [L,H,I]; down_proj [L,I,H]
  starcoder2: input_norm / post_attn_norm / final_norm with ``.bias``;
  q_proj.bias, k_proj.bias, v_proj.bias, o_proj.bias, up_proj.bias,
  down_proj.bias (optional); bloom, falcon and mpt alike, and bloom's
  embed_norm [H] (+ .bias) on the embeddings
  gpt_bigcode: pos_embed [n_positions, H]; q_bias / k_bias / v_bias
  phi: lm_head.bias [V]
  MoE (over the sparse layers only, L_moe of them; a dense layer's
  gate_proj / up_proj / down_proj over the dense layers only): router
  [L_moe,H,E]; moe_gate / moe_up [L_moe,E,H,I]; moe_down [L_moe,E,I,H];
  shared_gate / shared_up [L_moe,H,Is]; shared_down [L_moe,Is,H];
  shared_expert_gate [L_moe,H,1]
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from rtp_llm_tpu_torch.config.model_config import ModelConfig, arch_of


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
    # a pattern with ``{e}``: one tensor an expert, stacked ``[E, ...]`` a
    # layer; ``layers``: the layers a per-layer stack holds (None: all)
    experts: bool = False
    layers: Optional[tuple] = None


def get_weight_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """The spec table of ``cfg.model_type``'s trunk (``FAMILY_BUILDERS``)."""
    try:
        specs_of = FAMILY_BUILDERS[arch_of(cfg.model_type)]
    except KeyError:
        raise ValueError(f"no weight map for model_type {cfg.model_type!r}") from None
    return specs_of(cfg)


def _llama_specs(cfg: ModelConfig) -> list[WeightSpec]:
    lay = "model.layers.{l}."
    specs = [
        WeightSpec("embed_tokens", "model.embed_tokens.weight"),
        WeightSpec("final_norm", "model.norm.weight"),
        WeightSpec("input_norm", lay + "input_layernorm.weight", per_layer=True),
    ]
    if not cfg.parallel_residual:  # cohere: one norm feeds attention and MLP
        specs.append(WeightSpec("post_attn_norm", lay + "post_attention_layernorm.weight",
                                per_layer=True))
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
    """internlm2's fused ``wqkv`` (and falcon's new-decoder
    ``query_key_value``) holds its rows per kv head as ``[Hkv, g + 2, D]``:
    the group's g query heads, then one k, one v. ``which`` 0 / 1 / 2 picks
    q / k / v."""

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


def _norm_pair(name: str, pattern: str, per_layer: bool = True) -> list[WeightSpec]:
    """A LayerNorm's weight and its bias (optional: a checkpoint may lack
    it, ROADMAP C12)."""
    return [WeightSpec(name, pattern + ".weight", per_layer=per_layer),
            WeightSpec(name + ".bias", pattern + ".bias", per_layer=per_layer, optional=True)]


def _starcoder2_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """starcoder2: the llama layout's names with biased LayerNorms, biased
    linears (each bias optional, under ``<linear>.bias``) and the non-gated
    ``c_fc`` / ``c_proj`` MLP as ``up_proj`` / ``down_proj``."""
    lay = "model.layers.{l}."
    specs = [
        WeightSpec("embed_tokens", "model.embed_tokens.weight"),
        *_norm_pair("final_norm", "model.norm", per_layer=False),
        *_norm_pair("input_norm", lay + "input_layernorm"),
        *_norm_pair("post_attn_norm", lay + "post_attention_layernorm"),
    ]
    linears = [(f"{p}_proj", f"self_attn.{p}_proj", "in" if p == "o" else "out")
               for p in ("q", "k", "v", "o")]
    linears += [("up_proj", "mlp.c_fc", "out"), ("down_proj", "mlp.c_proj", "in")]
    for name, hf, axis in linears:
        specs.append(WeightSpec(name, lay + hf + ".weight", per_layer=True, transpose=True,
                                shard_axis=axis))
        specs.append(WeightSpec(name + ".bias", lay + hf + ".bias", per_layer=True,
                                optional=True))
    if not cfg.tie_word_embeddings:
        specs.append(WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"))
    return specs


def _baichuan_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """baichuan / baichuan2: the llama layout with q / k / v fused as
    ``self_attn.W_pack`` (``[3H, H]``, equal thirds: MHA)."""
    lay = "model.layers.{l}."
    h = cfg.hidden_size
    lin = dict(per_layer=True, transpose=True, shard_axis="out")
    specs = [s for s in _llama_specs(cfg) if s.name not in ("q_proj", "k_proj", "v_proj")]
    for j, p in enumerate(("q", "k", "v")):
        specs.append(WeightSpec(f"{p}_proj", lay + "self_attn.W_pack.weight",
                                hf_slice=(j * h, (j + 1) * h), **lin))
    return specs


def split_qkv_per_head(which: int) -> Callable:
    """bloom's and multi-head falcon's fused ``query_key_value`` holds its
    rows per head as ``[Hq, 3, D]`` (HF ``_split_heads``); ``which`` 0 / 1 /
    2 picks q / k / v (a weight or its bias)."""

    def split(t, cfg):
        n, d = cfg.num_attention_heads, cfg.head_dim
        return t.reshape(n, 3, d, *t.shape[1:])[:, which].reshape(n * d, *t.shape[1:])

    return split


def _biased_linears(lay: str, linears) -> list[WeightSpec]:
    """Each ``(name, hf module, shard axis)`` linear and its optional bias
    under ``<name>.bias``."""
    specs = []
    for name, hf, axis in linears:
        specs.append(WeightSpec(name, lay + hf + ".weight", per_layer=True, transpose=True,
                                shard_axis=axis))
        specs.append(WeightSpec(name + ".bias", lay + hf + ".bias", per_layer=True,
                                optional=True))
    return specs


def _fused_per_head(lay: str) -> list[WeightSpec]:
    """q / k / v (and their biases) of a ``query_key_value`` fused per head."""
    specs = []
    for j, p in enumerate(("q", "k", "v")):
        specs.append(WeightSpec(f"{p}_proj", lay + "self_attention.query_key_value.weight",
                                per_layer=True, transpose=True, shard_axis="out",
                                hf_transform=split_qkv_per_head(j)))
        specs.append(WeightSpec(f"{p}_proj.bias", lay + "self_attention.query_key_value.bias",
                                per_layer=True, optional=True,
                                hf_transform=split_qkv_per_head(j)))
    return specs


def _bloom_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """bloom: biased LayerNorms (the word embeddings' too, ``embed_norm``),
    a per-head fused ``query_key_value``, biased linears, the non-gated
    ``dense_h_to_4h`` / ``dense_4h_to_h`` MLP."""
    lay = "h.{l}."
    specs = [
        WeightSpec("embed_tokens", "word_embeddings.weight"),
        *_norm_pair("embed_norm", "word_embeddings_layernorm", per_layer=False),
        *_norm_pair("final_norm", "ln_f", per_layer=False),
        *_norm_pair("input_norm", lay + "input_layernorm"),
        *_norm_pair("post_attn_norm", lay + "post_attention_layernorm"),
        *_fused_per_head(lay),
        *_biased_linears(lay, (("o_proj", "self_attention.dense", "in"),
                               ("up_proj", "mlp.dense_h_to_4h", "out"),
                               ("down_proj", "mlp.dense_4h_to_h", "in"))),
    ]
    if not cfg.tie_word_embeddings:
        specs.append(WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"))
    return specs


def _fused_cut(lay: str, hf: str, cuts, bias: str = "{}_proj.bias") -> list[WeightSpec]:
    """q / k / v (and their optional biases, named ``bias`` of "q" / "k" /
    "v") of a fused tensor cut into its contiguous ``[q (all heads); k; v]``
    rows at ``cuts``."""
    specs = []
    for j, p in enumerate(("q", "k", "v")):
        cut = (cuts[j], cuts[j + 1])
        specs.append(WeightSpec(f"{p}_proj", lay + hf + ".weight", per_layer=True,
                                transpose=True, shard_axis="out", hf_slice=cut))
        specs.append(WeightSpec(bias.format(p), lay + hf + ".bias", per_layer=True,
                                optional=True, hf_slice=cut))
    return specs


def _falcon_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """falcon: bloom's layout under falcon's names (no embedding norm),
    ``post_attention_layernorm`` only with the sequential residual (one norm
    feeds the parallel attention and MLP), the LM head unless tied. The
    fused ``query_key_value`` by form: per head ``[Hq, 3, D]`` (multi-head),
    contiguous ``[q; k; v]`` (multi-query: one kv head) or per kv group
    ``[Hkv, G + 2, D]`` (new decoder, whose two norms ``ln_attn`` /
    ``ln_mlp`` feed attention and MLP under ``parallel_norms`` "dual")."""
    lay = "h.{l}."
    hq, hkv, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.parallel_norms == "dual":  # the new decoder's ln_attn / ln_mlp
        norms = [*_norm_pair("input_norm", lay + "ln_attn"),
                 *_norm_pair("post_attn_norm", lay + "ln_mlp")]
    else:
        norms = _norm_pair("input_norm", lay + "input_layernorm")
    if hkv == hq:  # the multi-head form
        qkv = _fused_per_head(lay)
    elif hkv == 1:  # multi-query (a new decoder of one kv head lays out alike)
        qkv = _fused_cut(lay, "self_attention.query_key_value",
                         (0, hq * d, (hq + 1) * d, (hq + 2) * d))
    else:  # the new decoder: grouped per kv head
        qkv = []
        for j, p in enumerate(("q", "k", "v")):
            qkv.append(WeightSpec(f"{p}_proj", lay + "self_attention.query_key_value.weight",
                                  per_layer=True, transpose=True, shard_axis="out",
                                  hf_transform=internlm2_split_qkv(j)))
            qkv.append(WeightSpec(f"{p}_proj.bias", lay + "self_attention.query_key_value.bias",
                                  per_layer=True, optional=True,
                                  hf_transform=internlm2_split_qkv(j)))
    specs = [
        WeightSpec("embed_tokens", "word_embeddings.weight"),
        *_norm_pair("final_norm", "ln_f", per_layer=False),
        *norms,
        *qkv,
        *_biased_linears(lay, (("o_proj", "self_attention.dense", "in"),
                               ("up_proj", "mlp.dense_h_to_4h", "out"),
                               ("down_proj", "mlp.dense_4h_to_h", "in"))),
    ]
    if not cfg.parallel_residual:
        specs += _norm_pair("post_attn_norm", lay + "post_attention_layernorm")
    if not cfg.tie_word_embeddings:
        specs.append(WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"))
    return specs


def _gpt_bigcode_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """gpt_bigcode (StarCoder / WizardCoder): ``wte``, learned positions
    ``wpe``, biased ``ln_1`` / ``ln_2`` / ``ln_f``, a fused ``c_attn`` cut
    contiguously under ``multi_query`` (one kv head: ``[q; k; v]``) and per
    head without it (``[Hq, 3, D]``, HF's view; ROADMAP C22), the biased
    ``attn.c_proj`` and non-gated ``mlp.c_fc`` / ``mlp.c_proj``, the LM head
    unless tied. The names are the JAX package's (``q_bias`` ...)."""
    lay = "transformer.h.{l}."
    hq, hkv, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
    if hkv == hq:  # multi_query false
        qkv = []
        for j, p in enumerate(("q", "k", "v")):
            qkv.append(WeightSpec(f"{p}_proj", lay + "attn.c_attn.weight", per_layer=True,
                                  transpose=True, shard_axis="out",
                                  hf_transform=split_qkv_per_head(j)))
            qkv.append(WeightSpec(f"{p}_bias", lay + "attn.c_attn.bias", per_layer=True,
                                  hf_transform=split_qkv_per_head(j)))
    else:
        qkv = _fused_cut(lay, "attn.c_attn", (0, hq * d, (hq + hkv) * d, (hq + 2 * hkv) * d),
                         "{}_bias")
    specs = [
        WeightSpec("embed_tokens", "transformer.wte.weight"),
        WeightSpec("pos_embed", "transformer.wpe.weight"),
        *_norm_pair("final_norm", "transformer.ln_f", per_layer=False),
        *_norm_pair("input_norm", lay + "ln_1"),
        *_norm_pair("post_attn_norm", lay + "ln_2"),
        *qkv,
        *_biased_linears(lay, (("o_proj", "attn.c_proj", "in"),
                               ("up_proj", "mlp.c_fc", "out"),
                               ("down_proj", "mlp.c_proj", "in"))),
    ]
    if not cfg.tie_word_embeddings:
        specs.append(WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"))
    return specs


def _mpt_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """mpt: ``Wqkv`` cut in thirds, ``out_proj``, the non-gated
    ``ffn.up_proj`` / ``ffn.down_proj``, tied embeddings; norm and linear
    biases only where the checkpoint has them (``no_bias`` false)."""
    lay = "transformer.blocks.{l}."
    qd, kvd = cfg.num_attention_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return [
        WeightSpec("embed_tokens", "transformer.wte.weight"),
        *_norm_pair("final_norm", "transformer.norm_f", per_layer=False),
        *_norm_pair("input_norm", lay + "norm_1"),
        *_norm_pair("post_attn_norm", lay + "norm_2"),
        *_biased_linears(lay, (("o_proj", "attn.out_proj", "in"),
                               ("up_proj", "ffn.up_proj", "out"),
                               ("down_proj", "ffn.down_proj", "in"))),
        *_fused_cut(lay, "attn.Wqkv", (0, qd, qd + kvd, qd + 2 * kvd)),
    ]


def _glm4_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """glm4 (GLM-4-0414): the llama names, qkv biases, a fused
    ``gate_up_proj`` cut in halves and glm's sandwich norms under gemma2's
    names: ``post_self_attn_layernorm`` -> ``post_attn_norm`` (on the
    attention output), ``post_attention_layernorm`` -> ``pre_ffn_norm``,
    ``post_mlp_layernorm`` -> ``post_ffn_norm``."""
    lay = "model.layers.{l}."
    i = cfg.intermediate_size
    lin = dict(per_layer=True, transpose=True)
    specs = [
        WeightSpec("embed_tokens", "model.embed_tokens.weight"),
        WeightSpec("final_norm", "model.norm.weight"),
        WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"),
        WeightSpec("input_norm", lay + "input_layernorm.weight", per_layer=True),
        WeightSpec("post_attn_norm", lay + "post_self_attn_layernorm.weight", per_layer=True),
        WeightSpec("pre_ffn_norm", lay + "post_attention_layernorm.weight", per_layer=True),
        WeightSpec("post_ffn_norm", lay + "post_mlp_layernorm.weight", per_layer=True),
        WeightSpec("o_proj", lay + "self_attn.o_proj.weight", shard_axis="in", **lin),
        WeightSpec("gate_proj", lay + "mlp.gate_up_proj.weight", shard_axis="out",
                   hf_slice=(0, i), **lin),
        WeightSpec("up_proj", lay + "mlp.gate_up_proj.weight", shard_axis="out",
                   hf_slice=(i, 2 * i), **lin),
        WeightSpec("down_proj", lay + "mlp.down_proj.weight", shard_axis="in", **lin),
    ]
    for p in ("q", "k", "v"):
        specs.append(WeightSpec(f"{p}_proj", lay + f"self_attn.{p}_proj.weight",
                                shard_axis="out", **lin))
        specs.append(WeightSpec(f"{p}_bias", lay + f"self_attn.{p}_proj.bias", per_layer=True,
                                shard_axis="out", optional=True))
    return specs


def _chatglm_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """chatglm (ChatGLM2 / 3): ``query_key_value`` cut contiguously at
    ``[q (Hq heads); k (Hkv); v (Hkv)]`` (HF's ``mixed_x_layer.split``) with
    its biases, ``dense`` without bias, ``dense_h_to_4h`` as ``[gate | up]``
    (HF's ``swiglu``: ``silu(chunk 0) * chunk 1``), RMSNorms, the
    ``output_layer`` head."""
    lay = "transformer.encoder.layers.{l}."
    qd, kvd = cfg.num_attention_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    i = cfg.intermediate_size
    lin = dict(per_layer=True, transpose=True)
    specs = [
        WeightSpec("embed_tokens", "transformer.embedding.word_embeddings.weight"),
        WeightSpec("final_norm", "transformer.encoder.final_layernorm.weight"),
        WeightSpec("lm_head", "transformer.output_layer.weight", transpose=True,
                   shard_axis="out"),
        WeightSpec("input_norm", lay + "input_layernorm.weight", per_layer=True),
        WeightSpec("post_attn_norm", lay + "post_attention_layernorm.weight", per_layer=True),
        WeightSpec("o_proj", lay + "self_attention.dense.weight", shard_axis="in", **lin),
        WeightSpec("gate_proj", lay + "mlp.dense_h_to_4h.weight", shard_axis="out",
                   hf_slice=(0, i), **lin),
        WeightSpec("up_proj", lay + "mlp.dense_h_to_4h.weight", shard_axis="out",
                   hf_slice=(i, 2 * i), **lin),
        WeightSpec("down_proj", lay + "mlp.dense_4h_to_h.weight", shard_axis="in", **lin),
    ]
    cuts = (0, qd, qd + kvd, qd + 2 * kvd)
    for j, p in enumerate(("q", "k", "v")):
        cut = (cuts[j], cuts[j + 1])
        specs.append(WeightSpec(f"{p}_proj", lay + "self_attention.query_key_value.weight",
                                shard_axis="out", hf_slice=cut, **lin))
        if cfg.attention_bias:
            specs.append(WeightSpec(f"{p}_bias", lay + "self_attention.query_key_value.bias",
                                    per_layer=True, shard_axis="out", hf_slice=cut))
    return specs


def _gpt_neox_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """gpt_neox: ``embed_in``, biased LayerNorms, ``query_key_value`` fused
    per head as ``[Hq, 3, D]`` (HF's view) with its biases, the biased
    ``attention.dense`` and non-gated ``dense_h_to_4h`` / ``dense_4h_to_h``,
    ``embed_out`` as the untied head. The biases take the JAX names
    (``q_bias`` ...)."""
    lay = "gpt_neox.layers.{l}."
    specs = [
        WeightSpec("embed_tokens", "gpt_neox.embed_in.weight"),
        WeightSpec("lm_head", "embed_out.weight", transpose=True, shard_axis="out"),
        *_norm_pair("final_norm", "gpt_neox.final_layer_norm", per_layer=False),
        *_norm_pair("input_norm", lay + "input_layernorm"),
        *_norm_pair("post_attn_norm", lay + "post_attention_layernorm"),
        *_biased_linears(lay, (("o_proj", "attention.dense", "in"),
                               ("up_proj", "mlp.dense_h_to_4h", "out"),
                               ("down_proj", "mlp.dense_4h_to_h", "in"))),
    ]
    for j, p in enumerate(("q", "k", "v")):
        specs.append(WeightSpec(f"{p}_proj", lay + "attention.query_key_value.weight",
                                per_layer=True, transpose=True, shard_axis="out",
                                hf_transform=split_qkv_per_head(j)))
        specs.append(WeightSpec(f"{p}_bias", lay + "attention.query_key_value.bias",
                                per_layer=True, optional=True,
                                hf_transform=split_qkv_per_head(j)))
    return specs


def _phi_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """phi: biased LayerNorms (one a layer: it feeds the parallel attention
    and MLP), biased q / k / v, ``dense`` and the non-gated ``fc1`` /
    ``fc2``, the untied head with its ``lm_head.bias``."""
    lay = "model.layers.{l}."
    specs = [
        WeightSpec("embed_tokens", "model.embed_tokens.weight"),
        WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"),
        WeightSpec("lm_head.bias", "lm_head.bias"),
        *_norm_pair("final_norm", "model.final_layernorm", per_layer=False),
        *_norm_pair("input_norm", lay + "input_layernorm"),
        *_biased_linears(lay, (("o_proj", "self_attn.dense", "in"),
                               ("up_proj", "mlp.fc1", "out"),
                               ("down_proj", "mlp.fc2", "in"))),
    ]
    for p in ("q", "k", "v"):
        specs.append(WeightSpec(f"{p}_proj", lay + f"self_attn.{p}_proj.weight",
                                per_layer=True, transpose=True, shard_axis="out"))
        specs.append(WeightSpec(f"{p}_bias", lay + f"self_attn.{p}_proj.bias", per_layer=True,
                                shard_axis="out"))
    return specs


def _qwen_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """qwen v1: ``wte``, RMSNorms ``ln_1`` / ``ln_2`` / ``ln_f``, the fused
    ``c_attn`` cut in thirds with its biases (the model's only ones),
    ``attn.c_proj``, HF ``QWenMLP``'s ``w1 * silu(w2)``: ``w2`` the gate,
    ``w1`` the up branch, ``mlp.c_proj`` down."""
    lay = "transformer.h.{l}."
    qd = cfg.num_attention_heads * cfg.head_dim
    lin = dict(per_layer=True, transpose=True)
    specs = [
        WeightSpec("embed_tokens", "transformer.wte.weight"),
        WeightSpec("final_norm", "transformer.ln_f.weight"),
        WeightSpec("lm_head", "lm_head.weight", transpose=True, shard_axis="out"),
        WeightSpec("input_norm", lay + "ln_1.weight", per_layer=True),
        WeightSpec("post_attn_norm", lay + "ln_2.weight", per_layer=True),
        WeightSpec("o_proj", lay + "attn.c_proj.weight", shard_axis="in", **lin),
        WeightSpec("gate_proj", lay + "mlp.w2.weight", shard_axis="out", **lin),
        WeightSpec("up_proj", lay + "mlp.w1.weight", shard_axis="out", **lin),
        WeightSpec("down_proj", lay + "mlp.c_proj.weight", shard_axis="in", **lin),
    ]
    for j, p in enumerate(("q", "k", "v")):
        cut = (j * qd, (j + 1) * qd)
        specs.append(WeightSpec(f"{p}_proj", lay + "attn.c_attn.weight", shard_axis="out",
                                hf_slice=cut, **lin))
        specs.append(WeightSpec(f"{p}_bias", lay + "attn.c_attn.bias", per_layer=True,
                                shard_axis="out", hf_slice=cut))
    return specs


def _moe_specs(cfg: ModelConfig) -> list[WeightSpec]:
    """qwen2_moe / qwen3_moe / mixtral: the llama table's attention and
    norms, a dense MLP on the layers ``cfg.is_moe_layer`` leaves dense, the
    router and expert stacks on the others (canonical layout in the module
    docstring)."""
    lay = "model.layers.{l}."
    moe = tuple(i for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    dense = tuple(i for i in range(cfg.num_layers) if i not in moe)
    mlp = ("gate_proj", "up_proj", "down_proj")
    specs = [sp for sp in _llama_specs(cfg) if sp.name not in mlp]
    lin = dict(per_layer=True, transpose=True)
    if dense:
        specs += [WeightSpec(p, lay + f"mlp.{p}.weight", shard_axis="in" if p == mlp[2] else "out",
                             layers=dense, **lin) for p in mlp]
    if arch_of(cfg.model_type) == "mixtral":
        blk = lay + "block_sparse_moe."
        members = (("moe_gate", "w1"), ("moe_up", "w3"), ("moe_down", "w2"))
    else:
        blk = lay + "mlp."
        members = (("moe_gate", "gate_proj"), ("moe_up", "up_proj"), ("moe_down", "down_proj"))
    specs.append(WeightSpec("router", blk + "gate.weight", layers=moe, **lin))
    specs += [WeightSpec(name, blk + f"experts.{{e}}.{hf}.weight", shard_axis="expert",
                         experts=True, layers=moe, **lin) for name, hf in members]
    if cfg.num_shared_experts:
        specs += [WeightSpec("shared_" + p, lay + f"mlp.shared_expert.{p}_proj.weight",
                             shard_axis="in" if p == "down" else "out", layers=moe, **lin)
                  for p in ("gate", "up", "down")]
        specs.append(WeightSpec("shared_expert_gate", lay + "mlp.shared_expert_gate.weight",
                                layers=moe, **lin))
    return specs


# a prefix each name of a family may carry in a checkpoint (HF's
# ``BloomForCausalLM`` writes ``transformer.h.0...``, the published
# bigscience/bloom-* files ``h.0...``); the loader takes either
OPTIONAL_PREFIX = {"bloom": "transformer.", "falcon": "transformer."}


# by trunk (``arch_of``): an alias takes its target's table
FAMILY_BUILDERS: dict[str, Callable[[ModelConfig], list[WeightSpec]]] = {
    "qwen2": _llama_specs, "qwen3": _llama_specs, "llama": _llama_specs,
    "mistral": _llama_specs, "yi": _llama_specs, "internlm": _llama_specs,
    "internlm2": _internlm2_specs, "phi3": _phi3_specs,
    "gemma": _llama_specs, "gemma2": _llama_specs, "cohere": _llama_specs,
    "starcoder2": _starcoder2_specs, "baichuan": _baichuan_specs,
    "baichuan2": _baichuan_specs, "bloom": _bloom_specs, "falcon": _falcon_specs,
    "mpt": _mpt_specs, "gpt_bigcode": _gpt_bigcode_specs, "glm4": _glm4_specs,
    "chatglm": _chatglm_specs, "gpt_neox": _gpt_neox_specs, "phi": _phi_specs,
    "qwen": _qwen_specs, "qwen2_moe": _moe_specs, "qwen3_moe": _moe_specs, "mixtral": _moe_specs,
}


def hf_names_for(spec: WeightSpec, num_layers: int, num_experts: int = 0) -> list[str]:
    """The concrete HF tensor names a spec expands to, in layer order (and
    expert order within a layer, for an expert stack)."""
    if not spec.per_layer:
        return [spec.hf_pattern]
    layers = spec.layers if spec.layers is not None else range(num_layers)
    names = [spec.hf_pattern.replace("{l}", str(l)) for l in layers]
    if spec.experts:
        names = [n.replace("{e}", str(e)) for n in names for e in range(num_experts)]
    return names
