"""4-bit weight quantization: packed GPTQ/AWQ checkpoint ingestion and the
load-time int4 / fp4 transforms (port of ``rtp_llm_tpu/quant``, 4-bit routes).
"""

from rtp_llm_tpu_torch.quant.weight_only import make_quant_transform

__all__ = ["make_quant_transform"]
