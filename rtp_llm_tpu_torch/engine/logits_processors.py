"""Host-side logits processors: trie-constrained ("tree") decode.

Port of ``rtp_llm_tpu/engine/logits_processors.py``. A TreeDecodeConfig JSON
defines a trie over token ids: once ``start_token_id`` is generated, each
next token must come from ``prefix_dict[path]`` (path = the ids generated
since the start token, joined by ``sep``) until ``end_token_id`` closes the
region.

The per-stream trie walk is small host state (this module); the masking runs
inside the device sampler through a fixed-shape ``[B, MAX_ALLOW]``
allow-list (``ops/sampling.py``), the mechanism the no-repeat-ngram bans use.
Steps with a trie run synchronously, since the allow-list depends on the
latest token.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

MAX_ALLOW = 64  # fixed device-side allow-list width


@dataclasses.dataclass
class TreeDecodeConfig:
    start_token_id: int = 225
    end_token_id: int = 2
    sep: str = "_"
    prefix_dict: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str) -> "TreeDecodeConfig":
        with open(path) as f:
            d = json.load(f)
        return cls(
            start_token_id=int(d.get("start_token_id", 225)),
            end_token_id=int(d.get("end_token_id", 2)),
            sep=d.get("sep", "_"),
            prefix_dict={k: [int(t) for t in v]
                         for k, v in d.get("prefix_dict", {}).items()},
        )


class TreeDecodeState:
    """Per-stream trie walk. ``allowed()`` returns the candidate set for the
    NEXT token (None = unconstrained); ``update(tok)`` advances on each
    token."""

    def __init__(self, config: TreeDecodeConfig):
        self.cfg = config
        self.active = False
        self.path: List[int] = []

    def update(self, token: int):
        cfg = self.cfg
        if not self.active:
            if token == cfg.start_token_id:
                self.active = True
                self.path = []
            return
        if token == cfg.end_token_id:
            self.active = False
            self.path = []
            return
        self.path.append(int(token))

    def allowed(self) -> Optional[List[int]]:
        if not self.active:
            return None
        key = self.cfg.sep.join(str(t) for t in self.path)
        cands = self.cfg.prefix_dict.get(key)
        if cands is None:
            # dead end: only the end token may close the region
            return [self.cfg.end_token_id]
        out = list(cands[: MAX_ALLOW - 1])
        if self.cfg.end_token_id not in out:
            out.append(self.cfg.end_token_id)
        return out
