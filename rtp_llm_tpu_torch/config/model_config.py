"""Model architecture configuration (dense llama family).

Port of ``rtp_llm_tpu/config/model_config.py`` restricted to the families
the port serves, all on the llama trunk: qwen2 (qkv bias), llama (optional
attention bias), qwen3 (per-head q/k RMSNorm), mistral (sliding window),
yi, internlm (attention and o_proj biases), internlm2 (grouped fused wqkv)
and phi3 (fused qkv / gate_up, sliding window), gemma and gemma2 (GeGLU,
``(1 + w)`` RMSNorms folded at load, embeddings scaled by ``sqrt(hidden)``,
tied embeddings; gemma2 adds sandwich norms, attention and final-logit
soft-caps, ``query_pre_attn_scalar`` and a window on every
``sliding_window_pattern``-th layer but the last of each period), cohere
(weight-only LayerNorms, a parallel residual, GPT-J pair RoPE over the whole
head, ``logit_scale``, optional per-head q / k LayerNorms) and starcoder2
(biased LayerNorms and linears, a non-gated gelu-tanh MLP), and the ALiBi
families: baichuan / baichuan2 (a fused ``W_pack``; ALiBi instead of RoPE
from hidden 5120, the 13B size, as the JAX package decides it; Baichuan2's
``NormHead``, ``norm_head``), bloom (biased LayerNorms and linears, an
embedding LayerNorm, a non-gated gelu-tanh MLP), mpt (weight-only
LayerNorms unless ``no_bias`` is false, exact GELU) and falcon's multi-head
form (``multi_query`` and ``new_decoder_architecture`` false: falcon-rw-1b
/ -7b; biased LayerNorms, optional linear biases, a sequential or parallel
residual, exact GELU, ALiBi under ``alibi`` with its slopes scaled by
``sm_scale``, ``alibi_scaled``), and the multi-query families:
gpt_bigcode (StarCoder / WizardCoder: learned absolute positions
``use_learned_positions`` instead of RoPE, biased LayerNorms and linears,
one kv head under ``multi_query``), falcon's multi-query form (falcon-7b:
71 query heads on one kv head at head_dim 64) and its new-decoder form
(falcon-40b / -180b: grouped kv heads, the parallel residual with
``ln_attn`` / ``ln_mlp``, ``parallel_norms`` "dual"), and the partial-rotary
families, which rotate only ``rotary_dim = int(head_dim *
partial_rotary_factor)`` dims of each head: glm4 (GLM-4-0414: pairwise RoPE
over half the head, qkv biases, gemma2's sandwich norms without the ``1 +
w``), chatglm (ChatGLM2 / 3: the same RoPE, a GQA-fused ``query_key_value``
with biases, ``[gate | up]`` in one linear), gpt_neox (half-split RoPE over
``rotary_pct`` of the head, biased LayerNorms and linears, the "dual"
parallel residual or the sequential one), phi (Phi-1 / 1.5 / 2: half-split
RoPE, one biased LayerNorm feeding the parallel attention and MLP, biased
linears and LM head, ``lm_head_bias``) and qwen (Qwen v1: a fused
``c_attn`` with the only biases, full-head RoPE), and the mixture-of-experts
trunks: qwen2_moe (qwen2's attention, softmax top-k experts and a gated
shared expert), qwen3_moe (qwen3's attention, top-k experts) and mixtral
(mistral's attention, top-2 of 8 experts). A single dataclass built from a
HuggingFace ``config.json``.

Model-type aliases: the reference's registered names that are spelling or
role variants of a served family (``REFERENCE_TYPE_ALIASES``, rewritten into
``model_type``) or keep their own name on a served family's trunk
(``ARCH_ALIASES``: ``model_type`` stays as given, ``arch_of`` names the
trunk). Only aliases whose target the port serves are listed; any other
name the JAX package knows raises, naming its target.

The sliding window: mistral and phi3 configs carry ``sliding_window``
without qwen2's ``use_sliding_window`` switch, and HF's Mistral / Phi-3
attention applies it whenever it is set. The port does the same; the JAX
package reads it only under ``use_sliding_window`` and serves both with
full attention (ROADMAP.md, section C, C6). StarCoder2 configs carry
``sliding_window`` the same way, and HF's Starcoder2 attention applies it
whenever it is set (C11).

The falcon branch departs from the JAX package where HF's ``FalconForCausalLM``
does (ROADMAP C13-C17): it reads ``tie_word_embeddings``, runs exact GELU
(HF's ``FalconMLP``), and its ALiBi bias is scaled with the scores.
Its new-decoder form reads ``num_ln_in_parallel_attn`` as HF reads it (2
unless set: ``ln_attn`` / ``ln_mlp``, C21). A falcon or gpt_bigcode group
past what the attention kernels take (``decode.max_group``) raises here.

Learned positions (gpt_bigcode): the table holds ``n_positions`` rows, kept
as ``max_position_embeddings``; an engine caps ``max_seq_len`` there
(ROADMAP C, expected divergences: the JAX package clamps a position past
the table to its last row).

gpt_neox reads ``hidden_act`` as HF does: ``gelu_fast`` (GPT-NeoX-20B's) is
the tanh GELU (``TANH_GELUS``); the JAX package passes the name through and
its model runs SiLU for it (ROADMAP C24). Qwen v1's ``use_dynamic_ntk`` /
``use_logn_attn`` are not modelled, as in the JAX package: both act only past
``seq_length``, which is ``max_position_embeddings`` here (ROADMAP C,
expected divergences). Phi's ``qk_layernorm`` (false in every released
checkpoint; the JAX package never reads it) and ChatGLM options outside the
released models' (``rmsnorm`` false, ``add_bias_linear``,
``apply_residual_connection_post_layernorm``, no ``post_layer_norm``) raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

SUPPORTED_TYPES = ("qwen2", "llama", "qwen3", "mistral", "yi", "internlm", "internlm2", "phi3",
                   "gemma", "gemma2", "cohere", "starcoder2", "baichuan", "baichuan2", "bloom",
                   "mpt", "falcon", "gpt_bigcode", "glm4", "chatglm", "gpt_neox", "phi", "qwen",
                   "qwen2_moe", "qwen3_moe", "mixtral")
# the mixture-of-experts trunks (softmax top-k routing, bf16 expert stacks)
# and HF's defaults of each: (experts, experts a token, expert width)
MOE_DEFAULTS = {"qwen2_moe": (60, 4, 1408), "qwen3_moe": (128, 8, 768), "mixtral": (8, 2, 0)}
MOE_TYPES = tuple(MOE_DEFAULTS)
# families whose attention applies a set ``sliding_window`` unconditionally
WINDOW_ALWAYS_TYPES = ("mistral", "phi3", "gemma2", "starcoder2", "mixtral")
# families whose MLP is ``down(act(up(x)))``, no gate (starcoder2's c_fc /
# c_proj)
NON_GATED_TYPES = ("starcoder2", "bloom", "mpt", "falcon", "gpt_bigcode", "gpt_neox", "phi")
# Baichuan2 ships model_type "baichuan"; its vocabulary tells it from
# Baichuan-1's 64000
BAICHUAN2_VOCAB = 125696
# the reference's names rewritten into a served model_type (JAX
# REFERENCE_TYPE_ALIASES, the entries whose target the port serves)
REFERENCE_TYPE_ALIASES = {
    "qwen_2": "qwen2", "qwen_2-mtp": "qwen2", "qwen_2_embedding": "qwen2",
    "cosyvoice_qwen": "qwen2", "qwen_3": "qwen3", "qwen_3_tool": "qwen3",
    "qwen_agent": "qwen", "qwen_tool": "qwen", "chatglm4": "glm4", "gpt_neox_13b": "gpt_neox",
    "qwen_2_moe": "qwen2_moe", "qwen_3_moe": "qwen3_moe", "qwen_3_moe_eagle3": "qwen3_moe",
    "qwen35_moe_mtp": "qwen35_moe",
}
# model types served on another family's trunk, keeping their own name
# (JAX ARCH_ALIASES, the entries whose target the port serves)
ARCH_ALIASES = {"qwen35_dense": "qwen3", "aquila": "llama", "xverse": "llama",
                "starcoder": "gpt_bigcode", "wizardcoder": "gpt_bigcode",
                "chat_glm_2": "chatglm", "chat_glm_3": "chatglm", "chatglm2": "chatglm",
                "chatglm3": "chatglm", "qwen_7b": "qwen", "qwen_13b": "qwen", "qwen_1b8": "qwen",
                "qwen3_coder_moe": "qwen3_moe", "qwen35_moe": "qwen3_moe"}
# the JAX package's other aliases, by their targets, which the port does not
# serve yet: named in the refusal
UNSERVED_ALIASES = {
    "qwen_v2_audio": "qwen2_audio", "qwen3_next_mtp": "qwen3_next",
    "deepseek2": "deepseek_v2", "deepseek3": "deepseek_v3", "deepseek-v3-mtp": "deepseek_v3",
    "glm_5": "glm4_moe", "glm4_moe_lite": "glm4_moe",
    "megatron-bert": "megatron_bert", "xlm-roberta": "roberta",
    "kimi_k2": "deepseek_v3", "kimi_k25": "deepseek_v3", "deepseek_v31": "deepseek_v3",
    "deepseek_v32": "deepseek_v3",
}
# norm_type values: rmsnorm; layernorm_nobias (mean-centred, weight only);
# layernorm (with its bias; a checkpoint without norm biases takes the
# weight-only form, ROADMAP C12)
NORM_TYPES = ("rmsnorm", "layernorm_nobias", "layernorm")
# HF activation_function names of the tanh GELU (gelu_new / gelu_fast are
# its formula); "gelu" is exact
TANH_GELUS = ("gelu_pytorch_tanh", "gelu_new", "gelu_fast", "gelu_tanh")


def arch_of(model_type: str) -> str:
    """The served family whose trunk, weight map and config rules a model
    type takes (itself, or its ``ARCH_ALIASES`` target)."""
    return ARCH_ALIASES.get(model_type, model_type)
# HF quant_method names of pre-quantized W8A8 (SmoothQuant / OmniQuant) checkpoints
SMOOTH_QUANT_METHODS = ("smooth_quant", "smoothquant", "omni_quant", "omniquant")


@dataclasses.dataclass
class ModelConfig:
    model_type: str = "qwen2"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_attention_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # qwen2 uses qkv bias
    use_qk_norm: bool = False  # qwen3-style per-head q/k norms
    sliding_window: int = 0  # 0 = disabled
    dtype: str = "bfloat16"
    eos_token_id: Any = None  # int or list[int]
    # a pre-quantized checkpoint's scheme, from config.json's
    # quantization_config: {"method": "gptq" | "awq", "bits", "group_size", "desc_act"}
    quantization: Optional[dict] = None
    # activation: silu (llama family) | gelu_tanh (gemma)
    hidden_act: str = "silu"
    # gemma: rmsnorm computes x * (1 + w) (folded into w at load); embeddings
    # scaled by sqrt(hidden)
    norm_unit_offset: bool = False
    scale_embeddings: bool = False
    # gemma2: sandwich norms (post-attention norm on the attention output,
    # pre / post ffn norms), logit soft-caps, a query scale of
    # query_pre_attn_scalar ** -0.5 (0: head_dim), and layer i global when
    # (i + 1) % sliding_window_pattern == 0, sliding otherwise
    sandwich_norms: bool = False
    attn_soft_cap: float = 0.0
    final_logit_soft_cap: float = 0.0
    query_pre_attn_scalar: float = 0.0
    sliding_window_pattern: int = 0
    # cohere / starcoder2: the norm of every site (NORM_TYPES; a loaded
    # ``<name>.bias`` selects the biased LayerNorm, as the JAX ``_norm_at``),
    # cohere's parallel residual ``x + attn(ln(x)) + mlp(ln(x))``, GPT-J
    # pair RoPE (pairs (2i, 2i + 1)) and its logits times ``logit_scale``
    # (0: none)
    norm_type: str = "rmsnorm"
    parallel_residual: bool = False
    rope_gptj_pairs: bool = False
    logit_scale: float = 0.0
    # ALiBi instead of RoPE (bloom, baichuan-13B, mpt, falcon under ``alibi``)
    use_alibi: bool = False
    # a parallel residual's norms: "shared" (one norm feeds attention and
    # MLP) or "dual" (the MLP takes ``post_attn_norm`` of the layer's input:
    # falcon's ln_mlp)
    parallel_norms: str = "shared"
    # gpt_bigcode: learned absolute positions (``pos_embed``, ``n_positions``
    # rows) added at embed time; no RoPE
    use_learned_positions: bool = False
    # partial rotary (glm4, chatglm, gpt_neox, phi): only the first
    # int(head_dim * partial_rotary_factor) dims of a head rotate (0: all),
    # in GPT-J pairs (glm4, chatglm) or, with rope_partial_interleaved
    # false, in neox halves (gpt_neox, phi); the rest pass through
    partial_rotary_factor: float = 0.0
    rope_partial_interleaved: bool = True
    # phi: the LM head adds its loaded ``lm_head.bias``
    lm_head_bias: bool = False
    # mixture of experts (qwen2_moe, qwen3_moe, mixtral; 0 experts: dense),
    # the JAX package's fields: softmax top-k routing over ``num_experts``
    # SiLU-gated experts of ``moe_intermediate_size``, the top-k weights
    # renormalised under ``moe_norm_topk_prob``; qwen2_moe adds a shared
    # expert behind a sigmoid gate (``num_shared_experts`` 1; its width is its
    # weights'). Layer i is sparse when (i + 1) is a multiple of
    # ``moe_layer_freq`` (HF's ``decoder_sparse_step``); the others keep a
    # dense MLP of ``intermediate_size``
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0
    moe_norm_topk_prob: bool = True
    moe_layer_freq: int = 1

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer ``i`` routes to experts (HF's rule: the JAX package
        takes ``(i - first) % freq == 0`` instead, ROADMAP C27)."""
        return self.num_experts > 0 and (i + 1) % max(self.moe_layer_freq, 1) == 0

    @property
    def norm_head(self) -> bool:
        """Baichuan2's ``NormHead``: each LM head row is L2-normalised at
        inference (the loader does it once)."""
        arch = arch_of(self.model_type)
        return arch == "baichuan2" or (arch == "baichuan"
                                       and self.vocab_size == BAICHUAN2_VOCAB)

    @property
    def alibi_scaled(self) -> bool:
        """Falcon scales its ALiBi bias with the scores, ``(qk + alibi) *
        inv_norm_factor`` (HF ``FalconAttention``): its slopes are taken
        times ``sm_scale``."""
        return arch_of(self.model_type) == "falcon"

    @property
    def rotary_dim(self) -> int:
        """Dims of a head that RoPE turns (JAX ``LlamaFamilyModel.rotary_dim``)."""
        if not self.partial_rotary_factor:
            return self.head_dim
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def gated_mlp(self) -> bool:
        """Whether the MLP is ``down(act(gate(x)) * up(x))``."""
        return arch_of(self.model_type) not in NON_GATED_TYPES

    def is_swa_layer(self, i: int) -> bool:
        """Whether layer ``i`` slides under a ``sliding_window_pattern``
        (gemma2: even layers slide, odd ones are global)."""
        p = self.sliding_window_pattern
        return bool(self.sliding_window) and bool(p) and (i + 1) % p != 0

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if isinstance(self.eos_token_id, int):
            self.eos_token_id = [self.eos_token_id]
        elif self.eos_token_id is None:
            self.eos_token_id = []

    @property
    def eos_token_ids(self) -> list:
        return list(self.eos_token_id or [])

    @classmethod
    def from_hf_config(cls, hf: dict, model_type: Optional[str] = None) -> "ModelConfig":
        mt = model_type or hf.get("model_type", "qwen2")
        mt = REFERENCE_TYPE_ALIASES.get(mt, mt)
        arch = arch_of(mt)
        if arch not in SUPPORTED_TYPES:
            target = UNSERVED_ALIASES.get(mt, mt)
            raise ValueError(
                f"model_type {mt!r} (family {target!r}) is not ported yet; supported: "
                f"{SUPPORTED_TYPES} and the aliases "
                f"{tuple(REFERENCE_TYPE_ALIASES) + tuple(ARCH_ALIASES)}")
        # bloom names its widths n_head / n_layer (n_embed in older files),
        # mpt d_model / n_heads / n_layers
        n_heads = hf.get("num_attention_heads", hf.get("n_head", hf.get("n_heads", 32)))
        hidden = hf.get("hidden_size", hf.get("n_embed", hf.get("n_embd",
                                                                  hf.get("d_model", 4096))))
        cfg = cls(
            model_type=mt,
            vocab_size=hf.get("vocab_size", 32000),
            hidden_size=hidden,
            intermediate_size=hf.get("intermediate_size", 4 * hidden),
            num_layers=hf.get("num_hidden_layers", hf.get("n_layer", hf.get("n_layers", 32))),
            num_attention_heads=n_heads,
            num_kv_heads=hf.get("num_key_value_heads", n_heads),
            head_dim=hf.get("head_dim") or hidden // n_heads,
            max_position_embeddings=hf.get("max_position_embeddings", 32768),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=hf.get("rope_scaling"),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            eos_token_id=hf.get("eos_token_id"),
        )
        from rtp_llm_tpu_torch.ops.rope import LONGROPE_TYPES, rope_type

        if hf.get("original_max_position_embeddings") and rope_type(
                cfg.rope_scaling) in LONGROPE_TYPES:
            # Phi-3's 128k configs name the switch length at the top level
            cfg.rope_scaling = dict(cfg.rope_scaling, original_max_position_embeddings=hf[
                "original_max_position_embeddings"])
        if arch in MOE_TYPES:
            mixtral = arch == "mixtral"
            experts, top, width = MOE_DEFAULTS[arch]  # HF's config defaults
            cfg.num_experts = hf.get("num_local_experts", hf.get("num_experts", experts))
            cfg.num_experts_per_tok = hf.get("num_experts_per_tok", top)
            cfg.moe_intermediate_size = (cfg.intermediate_size if mixtral
                                         else hf.get("moe_intermediate_size", width))
            # HF's Qwen2Moe / Qwen3Moe configs default to False (the JAX
            # package to True, ROADMAP C28); Mixtral always renormalises
            cfg.moe_norm_topk_prob = True if mixtral else hf.get("norm_topk_prob", False)
            cfg.moe_layer_freq = hf.get("decoder_sparse_step", 1) or 1
            if hf.get("mlp_only_layers"):
                raise NotImplementedError(f"{arch}: mlp_only_layers is not ported (every "
                                          "published checkpoint leaves it empty)")
            if arch == "qwen2_moe" and hf.get("shared_expert_intermediate_size", 5632):
                cfg.num_shared_experts = 1
        if arch in ("qwen2", "qwen2_moe"):
            cfg.attention_bias = True
        elif arch in ("qwen3", "qwen3_moe"):
            cfg.attention_bias = hf.get("attention_bias", False)
            cfg.use_qk_norm = True
        elif arch in ("internlm", "yi"):
            # internlm v1 carries attention biases (its o_proj's too)
            cfg.attention_bias = hf.get("bias", arch == "internlm")
        elif arch == "llama":
            cfg.attention_bias = hf.get("attention_bias", False)
        if arch in ("gemma", "gemma2"):
            cfg.hidden_act = "gelu_tanh"
            cfg.norm_unit_offset = True
            cfg.scale_embeddings = True
            cfg.tie_word_embeddings = hf.get("tie_word_embeddings", True)
        if arch == "gemma2":
            cfg.sandwich_norms = True
            cfg.attn_soft_cap = hf.get("attn_logit_softcapping") or 0.0
            cfg.final_logit_soft_cap = hf.get("final_logit_softcapping") or 0.0
            cfg.query_pre_attn_scalar = hf.get("query_pre_attn_scalar") or 0.0
            cfg.sliding_window_pattern = 2  # every 2nd layer global
        if arch == "cohere":
            cfg.rms_norm_eps = hf.get("layer_norm_eps", 1e-5)
            cfg.norm_type = "layernorm_nobias"
            cfg.parallel_residual = True
            cfg.rope_gptj_pairs = True
            cfg.logit_scale = hf.get("logit_scale", 1.0)
            cfg.use_qk_norm = hf.get("use_qk_norm", False)
            cfg.tie_word_embeddings = hf.get("tie_word_embeddings", True)
        if arch == "starcoder2":
            cfg.rms_norm_eps = hf.get("norm_epsilon", 1e-5)
            cfg.norm_type = "layernorm"
            cfg.attention_bias = hf.get("use_bias", True)
            cfg.hidden_act = "gelu_tanh"
            cfg.tie_word_embeddings = hf.get("tie_word_embeddings", True)
        if arch in ("baichuan", "baichuan2"):
            # 7B uses RoPE, 13B (hidden 5120) ALiBi: the HF config does not
            # mark it (the JAX package's per-size rule)
            cfg.use_alibi = hf.get("use_alibi", cfg.hidden_size >= 5120)
        if arch in ("bloom", "falcon"):
            if hf.get("apply_residual_connection_post_layernorm", False):
                raise NotImplementedError(
                    f"{arch}: apply_residual_connection_post_layernorm is not ported")
            cfg.rms_norm_eps = hf.get("layer_norm_epsilon", 1e-5)
            cfg.norm_type = "layernorm"
            cfg.tie_word_embeddings = hf.get("tie_word_embeddings", True)
        if arch == "bloom":
            cfg.use_alibi = True
            cfg.attention_bias = True
            cfg.hidden_act = "gelu_tanh"
            cfg.intermediate_size = hf.get("intermediate_size") or 4 * hidden
            cfg.num_kv_heads = cfg.num_attention_heads  # MHA, fused qkv
            cfg.vocab_size = hf.get("vocab_size", 250880)
        if arch == "falcon":
            if hf.get("new_decoder_architecture", False):
                # the residual is always parallel (HF FalconDecoderLayer);
                # num_ln_in_parallel_attn None reads as 2 (ln_attn / ln_mlp)
                if not hf.get("parallel_attn", True):
                    raise NotImplementedError(
                        "falcon: the new-decoder form with parallel_attn false is not ported")
                cfg.num_kv_heads = hf.get("num_kv_heads") or n_heads
                if (hf.get("num_ln_in_parallel_attn") or 2) == 2:
                    cfg.parallel_norms = "dual"
                cfg.parallel_residual = True
            else:
                if hf.get("multi_query", True):
                    cfg.num_kv_heads = 1
                cfg.parallel_residual = hf.get("parallel_attn", True)
            cfg.hidden_act = "gelu"  # HF FalconMLP: exact GELU (C15)
            cfg.attention_bias = hf.get("bias", False)
            cfg.use_alibi = hf.get("alibi", False)
            cfg.intermediate_size = hf.get("ffn_hidden_size") or 4 * hidden
        if arch == "gpt_bigcode":
            act = hf.get("activation_function", "gelu_pytorch_tanh")
            if act not in TANH_GELUS + ("gelu",):
                raise NotImplementedError(f"gpt_bigcode: activation_function {act!r} is not "
                                          "ported")
            cfg.rms_norm_eps = hf.get("layer_norm_epsilon", 1e-5)
            cfg.norm_type = "layernorm"
            cfg.num_kv_heads = 1 if hf.get("multi_query", True) else n_heads
            cfg.use_learned_positions = True
            cfg.max_position_embeddings = hf.get("n_positions", 8192)
            cfg.attention_bias = True
            cfg.hidden_act = "gelu_tanh" if act in TANH_GELUS else "gelu"
            cfg.intermediate_size = hf.get("n_inner") or 4 * hidden
            cfg.tie_word_embeddings = hf.get("tie_word_embeddings", True)
        if arch == "glm4":
            cfg.attention_bias = hf.get("attention_bias", True)
            cfg.sandwich_norms = True
            cfg.partial_rotary_factor = hf.get("partial_rotary_factor", 0.5)
        if arch == "qwen":  # Qwen v1: fused c_attn (the only biases), w1 / w2 / c_proj
            cfg.attention_bias = True
            cfg.rms_norm_eps = hf.get("layer_norm_epsilon", 1e-6)
            # HF QWenMLP splits intermediate_size over w1 / w2
            cfg.intermediate_size = hf.get("intermediate_size", 22016) // 2
            cfg.head_dim = hf.get("kv_channels") or cfg.head_dim
            cfg.rope_theta = hf.get("rotary_emb_base", 10000.0)
            cfg.max_position_embeddings = hf.get("seq_length", 8192)
            cfg.rope_scaling = None  # dynamic NTK and logn act past seq_length only
        if arch == "gpt_neox":
            act = hf.get("hidden_act", "gelu")
            if act not in TANH_GELUS + ("gelu",):
                raise NotImplementedError(f"gpt_neox: hidden_act {act!r} is not ported")
            cfg.norm_type = "layernorm"
            cfg.rms_norm_eps = hf.get("layer_norm_eps", 1e-5)
            cfg.parallel_residual = hf.get("use_parallel_residual", True)
            cfg.parallel_norms = "dual"
            cfg.partial_rotary_factor = hf.get("rotary_pct", 0.25)
            cfg.rope_partial_interleaved = False
            cfg.rope_theta = hf.get("rotary_emb_base", hf.get("rope_theta", 10000.0))
            cfg.hidden_act = "gelu_tanh" if act in TANH_GELUS else "gelu"  # C24
            cfg.attention_bias = hf.get("attention_bias", True)
        if arch == "phi":  # phi-1 / 1.5 / 2
            if hf.get("qk_layernorm", False):
                raise NotImplementedError("phi: qk_layernorm is not ported")
            cfg.norm_type = "layernorm"
            cfg.rms_norm_eps = hf.get("layer_norm_eps", 1e-5)
            cfg.parallel_residual = True
            cfg.parallel_norms = "shared"
            cfg.partial_rotary_factor = hf.get("partial_rotary_factor", 0.5)
            cfg.rope_partial_interleaved = False
            cfg.attention_bias = True
            cfg.lm_head_bias = True
            cfg.hidden_act = "gelu_tanh"  # gelu_new
        if arch == "chatglm":  # chatglm2 / 3
            for key, served in (("rmsnorm", True), ("add_bias_linear", False),
                                ("apply_residual_connection_post_layernorm", False),
                                ("post_layer_norm", True)):
                if hf.get(key, served) != served:
                    raise NotImplementedError(f"chatglm: {key}={hf[key]!r} is not ported")
            cfg.rms_norm_eps = hf.get("layernorm_epsilon", 1e-5)
            if hf.get("multi_query_attention", True):
                cfg.num_kv_heads = hf.get("multi_query_group_num", 2)
            cfg.head_dim = hf.get("kv_channels") or cfg.head_dim
            cfg.partial_rotary_factor = 0.5
            cfg.attention_bias = hf.get("add_qkv_bias", True)
            cfg.intermediate_size = hf.get("ffn_hidden_size", cfg.intermediate_size)
            cfg.num_layers = hf.get("num_layers", cfg.num_layers)
            cfg.vocab_size = hf.get("padded_vocab_size", cfg.vocab_size)
            cfg.max_position_embeddings = hf.get("seq_length", 32768)
            cfg.rope_theta = 10000.0 * hf.get("rope_ratio", 1)
        if arch in ("falcon", "gpt_bigcode"):
            # a group the attention kernels do not take (another width
            # raises in their wrappers)
            from rtp_llm_tpu_torch.ops.attention.decode import HEAD_DIMS, max_group

            g, top = cfg.num_attention_heads // cfg.num_kv_heads, max_group(cfg.head_dim)
            if cfg.head_dim in HEAD_DIMS and g > top:
                raise NotImplementedError(
                    f"{arch}: {g} query heads a kv head at head_dim {cfg.head_dim}; the "
                    f"attention kernels take at most {top} there")
        if arch == "mpt":
            ac = hf.get("attn_config") or {}
            for key, served in (("alibi", True), ("alibi_bias_max", 8), ("clip_qkv", None),
                                ("qk_ln", False), ("softmax_scale", None)):
                if ac.get(key, served) != served:
                    raise NotImplementedError(f"mpt: attn_config {key}={ac[key]!r} is not ported")
            no_bias = hf.get("no_bias", True)
            cfg.norm_type = "layernorm_nobias" if no_bias else "layernorm"
            cfg.rms_norm_eps = hf.get("layer_norm_epsilon", 1e-5)
            cfg.use_alibi = True
            cfg.hidden_act = "gelu"
            cfg.attention_bias = not no_bias
            cfg.intermediate_size = int(hf.get("expansion_ratio", 4) * hidden)
            cfg.max_position_embeddings = hf.get("max_seq_len", 2048)
            cfg.tie_word_embeddings = True  # mpt's head is its embedding
        qc = hf.get("quantization_config")
        if qc:
            method = qc.get("quant_method")
            if method in SMOOTH_QUANT_METHODS:
                # pre-quantized W8A8 checkpoints (.qweight / .scales /
                # .smoother / .shift, loader/loader.py)
                cfg.quantization = {"method": method}
            elif method in ("gptq", "awq"):
                cfg.quantization = {
                    "method": method,
                    "bits": qc.get("bits", 4),
                    "group_size": qc.get("group_size", 128),
                    "desc_act": qc.get("desc_act", False),
                }
            else:
                raise NotImplementedError(
                    f"checkpoints quantized with {method!r} are not ported "
                    "(gptq / awq / smooth_quant / omni_quant only)")
        sw = hf.get("sliding_window")
        if sw and (arch in WINDOW_ALWAYS_TYPES or hf.get("use_sliding_window", False)):
            cfg.sliding_window = int(sw)
        return cfg

    @classmethod
    def from_pretrained(cls, model_path: str, model_type: Optional[str] = None) -> "ModelConfig":
        with open(os.path.join(model_path, "config.json")) as f:
            hf = json.load(f)
        return cls.from_hf_config(hf, model_type)


def qwen2_7b_config() -> ModelConfig:
    """Qwen2-7B at its published width (HF ``Qwen/Qwen2-7B`` config.json)."""
    return ModelConfig(
        model_type="qwen2", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_attention_heads=28,
        num_kv_heads=4, head_dim=128, max_position_embeddings=131072,
        rms_norm_eps=1e-6, rope_theta=1000000.0, attention_bias=True,
        eos_token_id=[151643],
    )


def qwen2_1_5b_config() -> ModelConfig:
    """Qwen2-1.5B at its published width (HF ``Qwen/Qwen2-1.5B``
    config.json), its LM head tied to the embedding."""
    return ModelConfig(
        model_type="qwen2", vocab_size=151936, hidden_size=1536,
        intermediate_size=8960, num_layers=28, num_attention_heads=12,
        num_kv_heads=2, head_dim=128, max_position_embeddings=131072,
        rms_norm_eps=1e-6, rope_theta=1000000.0, attention_bias=True,
        tie_word_embeddings=True, eos_token_id=[151643],
    )


def llama3_8b_config() -> ModelConfig:
    """Llama-3-8B at its published width (HF ``meta-llama/Meta-Llama-3-8B``
    config.json)."""
    return ModelConfig(
        model_type="llama", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_attention_heads=32,
        num_kv_heads=8, head_dim=128, max_position_embeddings=8192,
        rms_norm_eps=1e-5, rope_theta=500000.0, attention_bias=False,
        eos_token_id=[128001],
    )


def qwen2_0_5b_config() -> ModelConfig:
    """Qwen2-0.5B at its published width (HF ``Qwen/Qwen2-0.5B``
    config.json): head_dim 64, 14 / 2 heads, its LM head tied to the
    embedding."""
    return ModelConfig(
        model_type="qwen2", vocab_size=151936, hidden_size=896,
        intermediate_size=4864, num_layers=24, num_attention_heads=14,
        num_kv_heads=2, head_dim=64, max_position_embeddings=131072,
        rms_norm_eps=1e-6, rope_theta=1000000.0, attention_bias=True,
        tie_word_embeddings=True, eos_token_id=[151643],
    )


def mistral_7b_config() -> ModelConfig:
    """Mistral-7B-v0.1 at its published width (HF
    ``mistralai/Mistral-7B-v0.1`` config.json), with its 4096-token
    sliding window."""
    return ModelConfig(
        model_type="mistral", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_attention_heads=32,
        num_kv_heads=8, head_dim=128, max_position_embeddings=32768,
        rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096,
        eos_token_id=[2],
    )


def phi3_mini_config() -> ModelConfig:
    """Phi-3-mini-4k at its published width (HF
    ``microsoft/Phi-3-mini-4k-instruct`` config.json): head_dim 96, 32 / 32
    heads, a 2047-token sliding window."""
    return ModelConfig(
        model_type="phi3", vocab_size=32064, hidden_size=3072,
        intermediate_size=8192, num_layers=32, num_attention_heads=32,
        num_kv_heads=32, head_dim=96, max_position_embeddings=4096,
        rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=2047,
        eos_token_id=[32000],
    )


def internlm2_7b_config() -> ModelConfig:
    """InternLM2-7B at its published width (HF ``internlm/internlm2-7b``
    config.json), its ``rope_scaling`` as published: dynamic NTK of factor
    2, which without ``original_max_position_embeddings`` leaves the tables
    unscaled, as the JAX package reads it."""
    return ModelConfig(
        model_type="internlm2", vocab_size=92544, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_attention_heads=32,
        num_kv_heads=8, head_dim=128, max_position_embeddings=32768,
        rms_norm_eps=1e-5, rope_theta=1000000.0,
        rope_scaling={"type": "dynamic", "factor": 2.0}, eos_token_id=[2],
    )


def gemma2_9b_config() -> ModelConfig:
    """Gemma-2-9B at its published width (HF ``google/gemma-2-9b``
    config.json): head_dim 256, 16 / 8 heads, a 4096-token window on even
    layers, attention soft-cap 50, final-logit soft-cap 30, tied embeddings."""
    return ModelConfig(
        model_type="gemma2", vocab_size=256000, hidden_size=3584,
        intermediate_size=14336, num_layers=42, num_attention_heads=16,
        num_kv_heads=8, head_dim=256, max_position_embeddings=8192,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True,
        sliding_window=4096, eos_token_id=[1], hidden_act="gelu_tanh",
        norm_unit_offset=True, scale_embeddings=True, sandwich_norms=True,
        attn_soft_cap=50.0, final_logit_soft_cap=30.0, query_pre_attn_scalar=256.0,
        sliding_window_pattern=2,
    )


def gemma_7b_config() -> ModelConfig:
    """Gemma-7B at its published width (HF ``google/gemma-7b``
    config.json): head_dim 256, 16 / 16 heads (MHA), tied embeddings."""
    return ModelConfig(
        model_type="gemma", vocab_size=256000, hidden_size=3072,
        intermediate_size=24576, num_layers=28, num_attention_heads=16,
        num_kv_heads=16, head_dim=256, max_position_embeddings=8192,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True,
        eos_token_id=[1], hidden_act="gelu_tanh", norm_unit_offset=True,
        scale_embeddings=True,
    )


def starcoder2_7b_config() -> ModelConfig:
    """StarCoder2-7B at its published width (HF ``bigcode/starcoder2-7b``
    config.json): 36 / 4 heads (a group of 9) of head_dim 128, biased
    LayerNorms and linears, a non-gated gelu-tanh MLP, tied embeddings and
    the 4096-token sliding window (C11)."""
    return ModelConfig(
        model_type="starcoder2", vocab_size=49152, hidden_size=4608,
        intermediate_size=18432, num_layers=32, num_attention_heads=36,
        num_kv_heads=4, head_dim=128, max_position_embeddings=16384,
        rms_norm_eps=1e-5, rope_theta=1000000.0, tie_word_embeddings=True,
        attention_bias=True, sliding_window=4096, eos_token_id=[0],
        hidden_act="gelu_tanh", norm_type="layernorm",
    )


def aya_23_8b_config() -> ModelConfig:
    """Aya-23-8B at its published width (HF ``CohereForAI/aya-23-8B``
    config.json): cohere's weight-only LayerNorms, parallel residual, GPT-J
    pair RoPE, logits times 0.125, tied embeddings; 32 / 8 heads."""
    return ModelConfig(
        model_type="cohere", vocab_size=256000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_attention_heads=32,
        num_kv_heads=8, head_dim=128, max_position_embeddings=8192,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=True,
        eos_token_id=[255001], norm_type="layernorm_nobias", parallel_residual=True,
        rope_gptj_pairs=True, logit_scale=0.125,
    )


def command_r_plus_config() -> ModelConfig:
    """Command R+ at its published width (HF
    ``CohereForAI/c4ai-command-r-plus`` config.json): 96 / 8 heads (a group
    of 12), per-head q / k LayerNorms, logits times 0.8333, 64 layers."""
    return ModelConfig(
        model_type="cohere", vocab_size=256000, hidden_size=12288,
        intermediate_size=33792, num_layers=64, num_attention_heads=96,
        num_kv_heads=8, head_dim=128, max_position_embeddings=8192,
        rms_norm_eps=1e-5, rope_theta=75000000.0, tie_word_embeddings=True,
        use_qk_norm=True, eos_token_id=[255001], norm_type="layernorm_nobias",
        parallel_residual=True, rope_gptj_pairs=True, logit_scale=0.8333333333333334,
    )


def baichuan2_13b_config() -> ModelConfig:
    """Baichuan2-13B at its published width (HF
    ``baichuan-inc/Baichuan2-13B-Base`` config.json): 40 / 40 heads of 128,
    ALiBi (hidden 5120), an untied ``NormHead`` over 125696 tokens."""
    return ModelConfig(
        model_type="baichuan", vocab_size=125696, hidden_size=5120,
        intermediate_size=13696, num_layers=40, num_attention_heads=40,
        num_kv_heads=40, head_dim=128, max_position_embeddings=32768,
        rms_norm_eps=1e-6, rope_theta=10000.0, eos_token_id=[2], use_alibi=True,
    )


def bloom_7b1_config() -> ModelConfig:
    """BLOOM-7b1 at its published width (HF ``bigscience/bloom-7b1``
    config.json): 32 heads of 128, 30 layers, biased LayerNorms (the
    embedding's too) and linears, a non-gated gelu-tanh MLP of 16384, tied
    250880-token embeddings, ALiBi."""
    return ModelConfig(
        model_type="bloom", vocab_size=250880, hidden_size=4096,
        intermediate_size=16384, num_layers=30, num_attention_heads=32,
        num_kv_heads=32, head_dim=128, max_position_embeddings=32768,
        rms_norm_eps=1e-5, tie_word_embeddings=True, attention_bias=True,
        eos_token_id=[2], hidden_act="gelu_tanh", norm_type="layernorm", use_alibi=True,
    )


def falcon_rw_1b_config() -> ModelConfig:
    """falcon-rw-1b at its published width (HF ``tiiuae/falcon-rw-1b``
    config.json): 32 heads of 64, 24 layers, biased LayerNorms and linears,
    the sequential residual, exact GELU, tied 50304-token embeddings,
    ALiBi."""
    return ModelConfig(
        model_type="falcon", vocab_size=50304, hidden_size=2048,
        intermediate_size=8192, num_layers=24, num_attention_heads=32,
        num_kv_heads=32, head_dim=64, max_position_embeddings=32768,
        rms_norm_eps=1e-5, tie_word_embeddings=True, attention_bias=True,
        eos_token_id=[2], hidden_act="gelu", norm_type="layernorm", use_alibi=True,
    )


def mpt_7b_config() -> ModelConfig:
    """MPT-7B at its published width (HF ``mosaicml/mpt-7b`` config.json):
    32 heads of 128, 32 layers, weight-only LayerNorms, no linear biases,
    exact GELU, tied 50432-token embeddings, ALiBi."""
    return ModelConfig(
        model_type="mpt", vocab_size=50432, hidden_size=4096,
        intermediate_size=16384, num_layers=32, num_attention_heads=32,
        num_kv_heads=32, head_dim=128, max_position_embeddings=2048,
        rms_norm_eps=1e-5, tie_word_embeddings=True, eos_token_id=[0],
        hidden_act="gelu", norm_type="layernorm_nobias", use_alibi=True,
    )


def starcoder_15b_config() -> ModelConfig:
    """StarCoder-15.5B at its published width (HF ``bigcode/starcoder``
    config.json): gpt_bigcode, 48 query heads on one kv head (multi-query)
    of 128, 40 layers, learned positions over 8192, biased LayerNorms and
    linears, an exact-GELU MLP of 24576, tied 49152-token embeddings."""
    return ModelConfig(
        model_type="gpt_bigcode", vocab_size=49152, hidden_size=6144,
        intermediate_size=24576, num_layers=40, num_attention_heads=48,
        num_kv_heads=1, head_dim=128, max_position_embeddings=8192,
        rms_norm_eps=1e-5, tie_word_embeddings=True, attention_bias=True,
        eos_token_id=[0], hidden_act="gelu", norm_type="layernorm",
        use_learned_positions=True,
    )


def falcon_7b_config() -> ModelConfig:
    """Falcon-7B at its published width (HF ``tiiuae/falcon-7b``
    config.json): the multi-query form, 71 query heads on one kv head of
    64, 32 layers, RoPE, one LayerNorm feeding the parallel attention and
    MLP, no linear biases, exact GELU, tied 65024-token embeddings."""
    return ModelConfig(
        model_type="falcon", vocab_size=65024, hidden_size=4544,
        intermediate_size=18176, num_layers=32, num_attention_heads=71,
        num_kv_heads=1, head_dim=64, max_position_embeddings=32768,
        rms_norm_eps=1e-5, tie_word_embeddings=True, eos_token_id=[11],
        hidden_act="gelu", norm_type="layernorm", parallel_residual=True,
    )


def falcon_40b_config() -> ModelConfig:
    """Falcon-40B at its published width (HF ``tiiuae/falcon-40b``
    config.json): the new-decoder form, 128 query heads on 8 kv heads (G 16)
    of 64, 60 layers, RoPE, ``ln_attn`` / ``ln_mlp`` feeding the parallel
    attention and MLP ("dual"), no linear biases, exact GELU, tied
    65024-token embeddings."""
    return ModelConfig(
        model_type="falcon", vocab_size=65024, hidden_size=8192,
        intermediate_size=32768, num_layers=60, num_attention_heads=128,
        num_kv_heads=8, head_dim=64, max_position_embeddings=32768,
        rms_norm_eps=1e-5, tie_word_embeddings=True, eos_token_id=[11],
        hidden_act="gelu", norm_type="layernorm", parallel_residual=True,
        parallel_norms="dual",
    )


def phi_2_config() -> ModelConfig:
    """Phi-2 at its published width (HF ``microsoft/phi-2`` config.json): 32
    / 32 heads of 80, 32 layers, RoPE in neox halves over the first 32 dims
    (``partial_rotary_factor`` 0.4), one biased LayerNorm feeding the
    parallel attention and MLP, biased linears, a gelu_new MLP of 10240, an
    untied LM head with its bias over 51200 tokens."""
    return ModelConfig(
        model_type="phi", vocab_size=51200, hidden_size=2560,
        intermediate_size=10240, num_layers=32, num_attention_heads=32,
        num_kv_heads=32, head_dim=80, max_position_embeddings=2048,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=True,
        eos_token_id=[50256], hidden_act="gelu_tanh", norm_type="layernorm",
        parallel_residual=True, parallel_norms="shared", partial_rotary_factor=0.4,
        rope_partial_interleaved=False, lm_head_bias=True,
    )


def glm4_9b_config() -> ModelConfig:
    """GLM-4-9B-0414 at its published width (HF ``THUDM/GLM-4-9B-0414``
    config.json): 32 / 2 heads of 128 (G 16), 40 layers, RoPE in GPT-J
    pairs over half the head, qkv biases, sandwich norms, a SwiGLU MLP of
    13696, an untied head over 151552 tokens."""
    return ModelConfig(
        model_type="glm4", vocab_size=151552, hidden_size=4096,
        intermediate_size=13696, num_layers=40, num_attention_heads=32,
        num_kv_heads=2, head_dim=128, max_position_embeddings=32768,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=True,
        eos_token_id=[151329, 151336, 151338], sandwich_norms=True,
        partial_rotary_factor=0.5,
    )


def chatglm3_6b_config() -> ModelConfig:
    """ChatGLM3-6B at its published width (HF ``THUDM/chatglm3-6b``
    config.json): 32 / 2 heads of 128 (``multi_query_group_num`` 2: G 16),
    28 layers, RoPE in GPT-J pairs over half the head, qkv biases, a SwiGLU
    MLP of 13696, an untied head over the padded 65024 tokens, 8192
    positions."""
    return ModelConfig(
        model_type="chatglm", vocab_size=65024, hidden_size=4096,
        intermediate_size=13696, num_layers=28, num_attention_heads=32,
        num_kv_heads=2, head_dim=128, max_position_embeddings=8192,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=True,
        eos_token_id=[2], partial_rotary_factor=0.5,
    )


def gpt_neox_20b_config() -> ModelConfig:
    """GPT-NeoX-20B at its published width (HF ``EleutherAI/gpt-neox-20b``
    config.json): 64 / 64 heads of 96, 44 layers, RoPE in neox halves over
    the first 24 dims (``rotary_pct`` 0.25), biased LayerNorms and linears,
    the "dual" parallel residual, a gelu_fast (tanh GELU) MLP of 24576, an
    untied head over 50432 tokens."""
    return ModelConfig(
        model_type="gpt_neox", vocab_size=50432, hidden_size=6144,
        intermediate_size=24576, num_layers=44, num_attention_heads=64,
        num_kv_heads=64, head_dim=96, max_position_embeddings=2048,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=True,
        eos_token_id=[0], hidden_act="gelu_tanh", norm_type="layernorm",
        parallel_residual=True, parallel_norms="dual", partial_rotary_factor=0.25,
        rope_partial_interleaved=False,
    )


def qwen_7b_config() -> ModelConfig:
    """Qwen-7B (v1) at its published width (HF ``Qwen/Qwen-7B``
    config.json): 32 heads of 128 (``kv_channels``), 32 layers, full-head
    RoPE, a fused ``c_attn`` with biases, 11008 a SwiGLU branch
    (``intermediate_size`` 22016 over w1 / w2), an untied head over 151936
    tokens, ``seq_length`` 8192; the config names no eos token (its
    tokenizer's ``<|endoftext|>`` ends a text)."""
    return ModelConfig(
        model_type="qwen", vocab_size=151936, hidden_size=4096,
        intermediate_size=11008, num_layers=32, num_attention_heads=32,
        num_kv_heads=32, head_dim=128, max_position_embeddings=8192,
        rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=True,
    )


def qwen1_5_moe_a2_7b_config() -> ModelConfig:
    """Qwen1.5-MoE-A2.7B at its published width (HF ``Qwen/Qwen1.5-MoE-A2.7B``
    config.json): 24 layers, 16 / 16 heads of 128, qkv biases, 60 experts of
    1408 a layer, 4 a token, the top-4 weights not renormalised, a shared
    expert of 5632 behind its sigmoid gate, an untied head over 151936
    tokens."""
    return ModelConfig(
        model_type="qwen2_moe", vocab_size=151936, hidden_size=2048,
        intermediate_size=5632, num_layers=24, num_attention_heads=16,
        num_kv_heads=16, head_dim=128, max_position_embeddings=8192,
        rms_norm_eps=1e-6, rope_theta=1000000.0, attention_bias=True,
        eos_token_id=[151643], num_experts=60, num_experts_per_tok=4,
        moe_intermediate_size=1408, num_shared_experts=1, moe_norm_topk_prob=False,
    )


def qwen3_30b_a3b_config(yarn: bool = False) -> ModelConfig:
    """Qwen3-30B-A3B at its published width (HF ``Qwen/Qwen3-30B-A3B``
    config.json): 48 layers, 32 / 4 heads of 128 (G 8), per-head q / k
    RMSNorms, 128 experts of 768 a layer, 8 a token, renormalised, an untied
    head over 151936 tokens, 40960 positions. ``yarn``: the published
    long-context setting, a ``yarn`` ``rope_scaling`` of factor 4 over the
    original 32768 positions (131072 served)."""
    return ModelConfig(
        model_type="qwen3_moe", vocab_size=151936, hidden_size=2048,
        intermediate_size=6144, num_layers=48, num_attention_heads=32,
        num_kv_heads=4, head_dim=128,
        max_position_embeddings=131072 if yarn else 40960,
        rms_norm_eps=1e-6, rope_theta=1000000.0, use_qk_norm=True,
        rope_scaling=({"rope_type": "yarn", "factor": 4.0,
                       "original_max_position_embeddings": 32768} if yarn else None),
        eos_token_id=[151645], num_experts=128, num_experts_per_tok=8,
        moe_intermediate_size=768, moe_norm_topk_prob=True,
    )


def mixtral_8x7b_config() -> ModelConfig:
    """Mixtral-8x7B at its published width (HF
    ``mistralai/Mixtral-8x7B-v0.1`` config.json): 32 layers, 32 / 8 heads of
    128, 8 experts of 14336 a layer, 2 a token, renormalised, no sliding
    window, an untied head over 32000 tokens."""
    return ModelConfig(
        model_type="mixtral", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_attention_heads=32,
        num_kv_heads=8, head_dim=128, max_position_embeddings=32768,
        rms_norm_eps=1e-5, rope_theta=1000000.0, eos_token_id=[2],
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=14336,
        moe_norm_topk_prob=True,
    )
