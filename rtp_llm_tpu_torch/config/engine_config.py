"""Engine configuration groups (subset).

Port of the ``QuantConfig``, ``CacheConfig``, ``SchedulerConfig``,
``KernelConfig`` and ``SpeculativeConfig`` groups of
``rtp_llm_tpu/config/engine_config.py`` with the knobs the port's engine
reads, plus the aggregate ``EngineConfig`` (with the engine-wide trie of
constrained decode, ``tree_decode_config_path``).
"""

from __future__ import annotations

import dataclasses
import enum


class QuantMethod(str, enum.Enum):
    """Load-time weight quantization schemes. The enum names every scheme of
    the JAX package; ``quant/weight_only.py`` says which are ported."""

    NONE = "none"
    WEIGHT_ONLY_INT8 = "int8"
    WEIGHT_ONLY_INT4 = "int4"  # symmetric groupwise, packed 2 per byte
    FP8 = "fp8"
    FP4 = "fp4"  # e2m1 groupwise (group 32), packed 2 per byte
    W8A8 = "w8a8"
    W4A8 = "w4a8"


@dataclasses.dataclass
class QuantConfig:
    method: QuantMethod = QuantMethod.NONE
    group_size: int = 128  # for int4 groupwise
    # per-channel int8 for the LM head, whatever the trunk's method (the
    # head is otherwise left in bf16)
    quantize_lm_head: bool = False
    # fp8 scales: >0 one per (block x block) tile, 0 one per tensor (per
    # layer for a stacked linear), -1 one per out channel
    fp8_block_size: int = 128
    # KV pool storage: bfloat16 | float32 | int8 (per-(slot, kv-head) bf16
    # scales beside the data) | fp8 (e4m3, storage only: no scales)
    kv_cache_dtype: str = "bfloat16"

    def __post_init__(self):
        if isinstance(self.method, str):
            self.method = QuantMethod(self.method)

    @property
    def is_quantized(self) -> bool:
        return self.method != QuantMethod.NONE


@dataclasses.dataclass
class CacheConfig:
    """Paged KV cache sizing."""

    block_size: int = 64  # tokens per KV block
    num_blocks: int = 0  # 0 = auto-size from free device memory after weights
    reserve_runtime_mem_mb: int = 1024  # device memory headroom for activations
    memory_utilization: float = 0.9
    enable_prefix_cache: bool = True
    # sliding-window block recycling for uniform-SWA models (mistral, phi3):
    # a stream's blocks wholly below the attention window are reused for its
    # new tokens or freed, bounding it at ceil(window / block_size) + 2
    # blocks. Turns prefix reuse off (a recycled block's contents no longer
    # match its logical positions). Also on when enable_prefix_cache is off.
    swa_recycle: bool = False


@dataclasses.dataclass
class SchedulerConfig:
    """FIFO continuous-batching scheduler knobs."""

    max_batch_size: int = 64  # decode slots
    # kept for the JAX config's shape: the port prefills at each prompt's own
    # length and reads only the largest entry, twice: the chunk length of a
    # prompt longer than it, and the cap on the real tokens of a packed
    # prefill group (the JAX engine pads such a group to [4, bucket])
    prefill_buckets: tuple = (128, 512, 2048, 8192)
    max_seq_len: int = 8192
    max_queue_size: int = 1024
    # admission: require this fraction of peak blocks free before scheduling
    watermark_frac: float = 0.01
    # with decodes running, cap the prompt tokens admitted per step so one
    # prefill cannot stall decode for long; at least one stream is admitted
    max_prefill_tokens_per_step: int = 2048
    # PD-fusion ratio control: admit at most max_prefills_per_step streams a
    # step, and with decodes running run decode_steps_per_prefill
    # decode-only steps between prefill rounds. 0 = unlimited / no spacing.
    max_prefills_per_step: int = 0
    decode_steps_per_prefill: int = 0
    # SLA admission guard: abort a new stream ("overloaded", HTTP 429) when
    # the projected queue wait exceeds this many ms. 0 = off.
    ttft_slo_ms: int = 0
    # multi-step decode: N fused decode+sample bodies in one captured CUDA
    # graph, read back as [N, B] tokens at once. Stops are evaluated every N
    # tokens; the overshoot tokens are discarded and their KV rows lie past
    # the accepted length, never offered to the prefix cache.
    decode_steps: int = 1
    # defer per-layer decode KV writes into one batched scatter after the
    # forward (attention folds the current token in as one more column)
    defer_kv_writes: bool = False
    # pipeline decode windows: dispatch window k+1 before reading back window
    # k, so the host's stop checks and scheduling run under the device's
    # work. Streams see a window's tokens one step later.
    async_decode: bool = True


@dataclasses.dataclass
class KernelConfig:
    """Kernel selection knobs."""

    # run 4-bit linears through gw_gemm_pipe instead of gw_gemm: the same
    # product with each k-tile's decode skewed against the previous one's
    # products (from 128 rows a warp-specialised kernel: one warpgroup decodes
    # into shared-memory slots, two multiply them on wgmma)
    int4_pipeline: bool = False


SPECULATIVE_METHODS = ("none", "prompt_lookup", "vanilla", "eagle")


@dataclasses.dataclass
class SpeculativeConfig:
    """Speculative decoding: K proposals a stream, verified by the target
    model in one T = K+1 window (``engine/engine.py``).

    method: none | prompt_lookup (n-gram lookup in the stream's own tokens,
    ``engine/speculative.py``) | vanilla (a small draft model proposes K
    greedy tokens, ``engine/draft.py``) | eagle (a one-layer feature-level
    head, EAGLE or EAGLE3, ``engine/eagle.py``). The JAX package's ``mtp``
    needs a DeepSeek model, which the port does not have."""

    method: str = "none"
    draft_tokens: int = 4  # K: proposals verified a step
    ngram_min: int = 2
    ngram_max: int = 4
    sp_model_path: str = ""  # draft model / EAGLE head checkpoint directory

    def __post_init__(self):
        if self.method == "mtp":
            raise NotImplementedError(
                "MTP needs the DeepSeek model, not ported yet (ROADMAP A11)")
        if self.method not in SPECULATIVE_METHODS:
            raise ValueError(f"unknown speculative method {self.method!r} "
                             f"({' / '.join(SPECULATIVE_METHODS)})")

    @property
    def enabled(self) -> bool:
        return self.method != "none" and self.draft_tokens > 0


@dataclasses.dataclass
class ServerConfig:
    """What the server does at load (the JAX ``ServerConfig``'s field the
    port has)."""

    # static LoRA adapters merged into the weights at load, before fusion:
    # "name=path[,name2=path2...]" (a bare path takes its directory's name)
    lora_adapters: str = ""


@dataclasses.dataclass
class EngineConfig:
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    speculative: SpeculativeConfig = dataclasses.field(default_factory=SpeculativeConfig)
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    seed: int = 0
    # trie-constrained decode config JSON (``engine/logits_processors.py``);
    # "" = off
    tree_decode_config_path: str = ""

    # the field groups ``config/server_args.py`` exposes as
    # ``--<group>-<field>`` / ``RTP_<GROUP>_<FIELD>``
    GROUPS = ("quant", "kernel", "cache", "scheduler", "speculative", "server")
