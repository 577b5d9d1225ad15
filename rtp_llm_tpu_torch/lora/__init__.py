"""LoRA adapters: the static merge at load and dynamic multi-LoRA at run time
(port of ``rtp_llm_tpu/lora``)."""

from rtp_llm_tpu_torch.lora.lora import (
    LoraAdapter, LoraManager, apply_dynamic_lora, load_peft_adapter, merge_lora,
)

__all__ = ["LoraAdapter", "LoraManager", "apply_dynamic_lora", "load_peft_adapter",
           "merge_lora"]
