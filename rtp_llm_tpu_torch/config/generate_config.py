"""Per-request generation config.

Port of ``rtp_llm_tpu/config/generate_config.py``: length limits,
temperature / top-k / top-p sampling, repetition / presence / frequency
penalties, logit bias, n-gram bans, think budgets, stop tokens and stop
strings, ``num_return_sequences`` fan-out (the frontend's), beam search
(``num_beams``, ``variable_num_beams``), a LoRA adapter (``adapter_name``)
and the returns (logprobs, ``top_logprobs``, hidden states, the prompt
loss). A request that asks for the reference's remaining control
(per-request timelines) is refused (``NOT_PORTED``), so that it never gets
an answer with the control silently left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

# Fields of the reference's GenerateConfig that the port does not honour yet,
# with the test for a value that asks for them. ``seed`` is accepted: the
# reference reads a request's seed only when it returns hidden states.
# ``timeline_dir`` qualifies a refused field and means nothing alone.
NOT_PORTED: Dict[str, Callable[[Any], bool]] = {
    "gen_timeline": lambda v: v > 0,
}


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 512
    min_new_tokens: int = 0
    no_repeat_ngram_size: int = 0  # ban repeating n-grams (0 = off)
    logit_bias: Optional[dict] = None  # token_id -> additive bias (OpenAI)
    # sampling
    temperature: float = 1.0
    top_k: int = 0  # 0 => disabled (full softmax)
    top_p: float = 1.0
    do_sample: bool = True  # False => greedy
    seed: Optional[int] = None  # generate_with_hidden's sampler only
    # penalties
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # stopping
    stop_words: List[str] = dataclasses.field(default_factory=list)
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    ignore_eos: bool = False
    # fan-out: independent streams, one choice each (the frontend's)
    num_return_sequences: int = 1
    # beam search: num_beams > 1 keeps that many beams; the width once i
    # tokens exist is variable_num_beams[min(i-1, len-1)]; empty = constant
    num_beams: int = 1
    variable_num_beams: List[int] = dataclasses.field(default_factory=list)
    # dynamic LoRA adapter registered with the engine (None = the base model)
    adapter_name: Optional[str] = None
    # returns
    return_logprobs: bool = False
    top_logprobs: int = 0  # turns on the logprob pass; the lists come back empty
    return_hidden_states: bool = False
    # teacher-forced prompt loss: 1 = mean NLL over the prompt, 2 = per token
    calculate_loss: int = 0
    # think-mode budget: once the model has emitted think_start_token_id,
    # after max_thinking_tokens tokens think_end_token_id is forced
    max_thinking_tokens: int = 0  # 0 = unlimited / disabled
    think_start_token_id: Optional[int] = None
    think_end_token_id: Optional[int] = None
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
        if self.num_return_sequences < 1:
            raise ValueError("num_return_sequences must be >= 1")
        # the controls the engine reads in its loop: a bad value here would
        # fail a step, and with it every stream in the batch
        if not isinstance(self.num_beams, int) or self.num_beams < 1:
            raise ValueError(f"num_beams must be an integer >= 1, got {self.num_beams!r}")
        if not isinstance(self.variable_num_beams, list) or not all(
                isinstance(v, int) and v >= 1 for v in self.variable_num_beams):
            raise ValueError("variable_num_beams must be a list of integers >= 1, "
                             f"got {self.variable_num_beams!r}")
        if self.adapter_name is not None and not isinstance(self.adapter_name, str):
            raise ValueError(f"adapter_name must be a string, got {self.adapter_name!r}")
        for name in ("no_repeat_ngram_size", "max_thinking_tokens", "top_logprobs",
                     "calculate_loss"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"{name} must be an integer >= 0, got {v!r}")
        for name in ("think_start_token_id", "think_end_token_id"):
            v = getattr(self, name)
            if v is not None and not isinstance(v, int):
                raise ValueError(f"{name} must be a token id, got {v!r}")
        if self.logit_bias is not None:
            if not isinstance(self.logit_bias, dict):
                raise ValueError("logit_bias must map token ids to biases")
            for t, b in self.logit_bias.items():
                try:
                    int(t)
                    ok = math.isfinite(float(b))
                except (TypeError, ValueError):
                    ok = False
                if not ok:
                    raise ValueError(f"logit_bias must map token ids to finite biases, "
                                     f"got {t!r}: {b!r}")
        if self.temperature == 0.0:
            # reference semantics: temperature 0 == greedy
            self.do_sample = False
            self.temperature = 1.0

    @property
    def max_num_beams(self) -> int:
        return (max(self.variable_num_beams) if self.variable_num_beams
                else self.num_beams)

    def beam_width_at(self, out_len: int) -> int:
        """Beam width once ``out_len`` output tokens exist (reference:
        GenerateStream::numBeams). out_len 0 is always width 1."""
        if out_len <= 0:
            return 1
        if not self.variable_num_beams:
            return self.num_beams
        idx = min(out_len - 1, len(self.variable_num_beams) - 1)
        return self.variable_num_beams[idx]

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
