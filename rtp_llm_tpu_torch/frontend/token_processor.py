"""Incremental, stop-word-aware detokenization.

Port of ``rtp_llm_tpu/frontend/token_processor.py``: streams stable text as
tokens arrive, holding back (a) incomplete UTF-8 / partial-merge suffixes and
(b) prefixes of configured stop strings so a stop word never leaks into the
output.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


class IncrementalDetokenizer:
    def __init__(self, tokenizer, stop_strings: Optional[List[str]] = None,
                 skip_special_tokens: bool = True):
        self.tok = tokenizer
        self.stop_strings = [s for s in (stop_strings or []) if s]
        self.skip_special = skip_special_tokens
        self.token_ids: List[int] = []
        self._emitted = 0  # chars of decoded text already emitted
        self._stopped = False

    def _decode_all(self) -> str:
        return self.tok.decode(self.token_ids, skip_special_tokens=self.skip_special,
                               clean_up_tokenization_spaces=False)

    def push(self, new_token_ids: List[int]) -> Tuple[str, bool]:
        """Feed tokens; returns (new_stable_text, hit_stop_string)."""
        if self._stopped:
            return "", True
        self.token_ids.extend(int(t) for t in new_token_ids)
        text = self._decode_all()
        # hold back an incomplete UTF-8 tail (replacement char at the end)
        safe_end = len(text.rstrip("�"))
        for s in self.stop_strings:
            idx = text.find(s)
            if idx != -1:
                self._stopped = True
                out = text[self._emitted: idx]
                self._emitted = idx
                return out, True
        # hold back any suffix that could grow into a stop string
        hold = 0
        for s in self.stop_strings:
            for k in range(min(len(s) - 1, safe_end - self._emitted), 0, -1):
                if text[safe_end - k: safe_end] == s[:k]:
                    hold = max(hold, k)
                    break
        emit_end = safe_end - hold
        if emit_end <= self._emitted:
            return "", False
        out = text[self._emitted: emit_end]
        self._emitted = emit_end
        return out, False

    def finalize(self) -> str:
        """Flush remaining held-back text (minus any stop string)."""
        if self._stopped:
            return ""
        text = self._decode_all().rstrip("�")
        out = text[self._emitted:]
        self._emitted = len(text)
        return out

    @property
    def full_text(self) -> str:
        text = self._decode_all()
        for s in self.stop_strings:
            idx = text.find(s)
            if idx != -1:
                return text[:idx]
        return text
