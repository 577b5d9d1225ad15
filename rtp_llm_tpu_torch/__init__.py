"""rtp_llm_tpu_torch — the PyTorch/CUDA port of rtp_llm_tpu.

The same serving stack as the JAX package beside it (OpenAI-compatible
frontend, continuous batching over a paged prefix-reusable KV cache, HF
checkpoint loading), written in PyTorch for one NVIDIA Hopper GPU. Module
names and layout follow ``rtp_llm_tpu`` so each module's counterpart is easy
to find; the JAX package stays the reference the port is tested against.

This slice covers the dense llama-family trunk (qwen2 / llama / qwen3) with
bf16 or f32 weights. Paged decode and prefill attention run as hand-written
CUDA kernels (``csrc/``); everything else is plain PyTorch. Entry points run
on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
