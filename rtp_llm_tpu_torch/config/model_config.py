"""Model architecture configuration (dense llama family).

Port of ``rtp_llm_tpu/config/model_config.py`` restricted to the families
the port serves, all on the llama trunk: qwen2 (qkv bias), llama (optional
attention bias), qwen3 (per-head q/k RMSNorm), mistral (sliding window),
yi, internlm (attention and o_proj biases), internlm2 (grouped fused wqkv)
and phi3 (fused qkv / gate_up, sliding window), gemma and gemma2 (GeGLU,
``(1 + w)`` RMSNorms folded at load, embeddings scaled by ``sqrt(hidden)``,
tied embeddings; gemma2 adds sandwich norms, attention and final-logit
soft-caps, ``query_pre_attn_scalar`` and a window on every
``sliding_window_pattern``-th layer but the last of each period). A single
dataclass built from a HuggingFace ``config.json``.

The sliding window: mistral and phi3 configs carry ``sliding_window``
without qwen2's ``use_sliding_window`` switch, and HF's Mistral / Phi-3
attention applies it whenever it is set. The port does the same; the JAX
package reads it only under ``use_sliding_window`` and serves both with
full attention (ROADMAP.md, section C, C6).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

SUPPORTED_TYPES = ("qwen2", "llama", "qwen3", "mistral", "yi", "internlm", "internlm2", "phi3",
                   "gemma", "gemma2")
# families whose attention applies a set ``sliding_window`` unconditionally
WINDOW_ALWAYS_TYPES = ("mistral", "phi3", "gemma2")
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
        if mt not in SUPPORTED_TYPES:
            raise ValueError(
                f"model_type {mt!r} is not ported yet; supported: "
                f"{SUPPORTED_TYPES}")
        n_heads = hf.get("num_attention_heads", 32)
        hidden = hf.get("hidden_size", 4096)
        cfg = cls(
            model_type=mt,
            vocab_size=hf.get("vocab_size", 32000),
            hidden_size=hidden,
            intermediate_size=hf.get("intermediate_size", 4 * hidden),
            num_layers=hf.get("num_hidden_layers", 32),
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
        if mt == "qwen2":
            cfg.attention_bias = True
        elif mt == "qwen3":
            cfg.attention_bias = hf.get("attention_bias", False)
            cfg.use_qk_norm = True
        elif mt in ("internlm", "yi"):
            # internlm v1 carries attention biases (its o_proj's too)
            cfg.attention_bias = hf.get("bias", mt == "internlm")
        elif mt == "llama":
            cfg.attention_bias = hf.get("attention_bias", False)
        if mt in ("gemma", "gemma2"):
            cfg.hidden_act = "gelu_tanh"
            cfg.norm_unit_offset = True
            cfg.scale_embeddings = True
            cfg.tie_word_embeddings = hf.get("tie_word_embeddings", True)
        if mt == "gemma2":
            cfg.sandwich_norms = True
            cfg.attn_soft_cap = hf.get("attn_logit_softcapping") or 0.0
            cfg.final_logit_soft_cap = hf.get("final_logit_softcapping") or 0.0
            cfg.query_pre_attn_scalar = hf.get("query_pre_attn_scalar") or 0.0
            cfg.sliding_window_pattern = 2  # every 2nd layer global
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
        if sw and (mt in WINDOW_ALWAYS_TYPES or hf.get("use_sliding_window", False)):
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
