"""Engine configuration groups (subset).

Port of the ``CacheConfig`` and ``SchedulerConfig`` groups of
``rtp_llm_tpu/config/engine_config.py`` with the knobs this slice's engine
reads, plus the aggregate ``EngineConfig``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CacheConfig:
    """Paged KV cache sizing."""

    block_size: int = 64  # tokens per KV block
    num_blocks: int = 0  # 0 = auto-size from free device memory after weights
    reserve_runtime_mem_mb: int = 1024  # device memory headroom for activations
    memory_utilization: float = 0.9
    enable_prefix_cache: bool = True


@dataclasses.dataclass
class SchedulerConfig:
    """FIFO continuous-batching scheduler knobs."""

    max_batch_size: int = 64  # decode slots
    # padded prefill lengths; prompts beyond the largest prefill in chunks of it
    prefill_buckets: tuple = (128, 512, 2048, 8192)
    max_seq_len: int = 8192
    max_queue_size: int = 1024
    # admission: require this fraction of peak blocks free before scheduling
    watermark_frac: float = 0.01
    # with decodes running, cap the prompt tokens admitted per step so one
    # prefill cannot stall decode for long; at least one stream is admitted
    max_prefill_tokens_per_step: int = 2048


@dataclasses.dataclass
class EngineConfig:
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | float32
    seed: int = 0
