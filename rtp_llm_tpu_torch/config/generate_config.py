"""Per-request generation config.

Port of ``rtp_llm_tpu/config/generate_config.py`` restricted to the controls
this slice's sampler and stream honour: length limits, temperature / top-k /
top-p sampling, repetition / presence / frequency penalties, stop tokens and
stop strings. A request that sets one of the reference's other controls to
a value that would change its answer is refused (``NOT_PORTED``), so that it
never gets an answer with the control silently left out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

# Fields of the reference's GenerateConfig that the port does not honour yet,
# with the test for a value that asks for them. ``seed`` is accepted: the
# reference reads a request's seed only when it returns hidden states. The
# think-mode token ids and ``timeline_dir`` qualify refused fields and mean
# nothing alone.
NOT_PORTED: Dict[str, Callable[[Any], bool]] = {
    "logit_bias": bool,
    "no_repeat_ngram_size": lambda v: v > 0,
    "num_beams": lambda v: v > 1,
    "variable_num_beams": bool,
    "top_logprobs": lambda v: v > 0,
    "return_hidden_states": bool,
    "calculate_loss": bool,
    "max_thinking_tokens": lambda v: v > 0,
    "adapter_name": bool,
    "gen_timeline": lambda v: v > 0,
}


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 512
    min_new_tokens: int = 0
    # sampling
    temperature: float = 1.0
    top_k: int = 0  # 0 => disabled (full softmax)
    top_p: float = 1.0
    do_sample: bool = True  # False => greedy
    # penalties
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # stopping
    stop_words: List[str] = dataclasses.field(default_factory=list)
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    ignore_eos: bool = False
    num_return_sequences: int = 1
    # returns
    return_logprobs: bool = False
    timeout_ms: int = 0  # 0 = no timeout

    def __post_init__(self):
        self.validate()

    def validate(self):
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        if self.num_return_sequences != 1:
            raise ValueError("num_return_sequences > 1 is not ported yet")
        if self.temperature == 0.0:
            # reference semantics: temperature 0 == greedy
            self.do_sample = False
            self.temperature = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "GenerateConfig":
        """Build from a request json, ignoring unknown keys (OpenAI extras);
        raises ValueError for a control of ``NOT_PORTED`` that is asked for."""
        if isinstance(d.get("extra_configs"), dict):
            d = {**d["extra_configs"],
                 **{k: v for k, v in d.items()
                    if k != "extra_configs" and v is not None}}
        for name, asks in NOT_PORTED.items():
            if d.get(name) is not None and asks(d[name]):
                raise ValueError(f"{name} is not ported yet")
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {k: v for k, v in d.items() if k in fields and v is not None}
        if d.get("max_tokens") is not None:
            kwargs.setdefault("max_new_tokens", d["max_tokens"])
        if d.get("max_completion_tokens") is not None:
            kwargs["max_new_tokens"] = d["max_completion_tokens"]
        if d.get("stop") is not None:
            stop = d["stop"]
            kwargs.setdefault("stop_words", [stop] if isinstance(stop, str) else list(stop))
        if d.get("n") is not None:
            kwargs.setdefault("num_return_sequences", d["n"])
        if isinstance(d.get("logprobs"), bool):
            kwargs.setdefault("return_logprobs", d["logprobs"])
        return cls(**kwargs)
