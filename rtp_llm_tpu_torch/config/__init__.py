from rtp_llm_tpu_torch.config.engine_config import (
    CacheConfig, EngineConfig, KernelConfig, QuantConfig, QuantMethod, SchedulerConfig,
    ServerConfig, SpeculativeConfig,
)
from rtp_llm_tpu_torch.config.generate_config import GenerateConfig
from rtp_llm_tpu_torch.config.model_config import ModelConfig

__all__ = ["CacheConfig", "EngineConfig", "KernelConfig", "QuantConfig", "QuantMethod",
           "SchedulerConfig", "ServerConfig", "SpeculativeConfig", "GenerateConfig", "ModelConfig"]
