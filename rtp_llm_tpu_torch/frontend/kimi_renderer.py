"""Kimi K2 / K2.5 chat renderer.

Port of ``rtp_llm_tpu/frontend/kimi_renderer.py``.

Reference: rtp_llm/openai/renderers/kimik2_renderer.py — beyond the HF chat
template, K2 needs (a) ``<|im_end|>`` as an extra stop word, and (b) tool
call ids normalized to the ``functions.{name}:{index}`` wire format the
template and the model's tool-call section tokens expect
(kimik2_renderer.py:60-145: ids are prefixed with ``functions.`` when bare,
validated against the pattern, and every used id must have a matching tool
response). Output-side tool parsing is handled by the registered
``kimi_k2`` detector (frontend/tool_detectors.py).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from rtp_llm_tpu_torch.frontend.chat_renderer import (
    ChatRenderer, RenderedPrompt, register_renderer,
)

_ID_PATTERN = re.compile(r"^functions\.[\w.-]+:\d+$")


class KimiK2Renderer(ChatRenderer):
    def render(
        self,
        messages: List[Dict[str, Any]],
        tools: Optional[List[dict]] = None,
        add_generation_prompt: bool = True,
        chat_template_kwargs: Optional[dict] = None,
    ) -> RenderedPrompt:
        # Ids the model emitted are already functions.{name}:{idx}; ids a
        # client invented (e.g. OpenAI-style "call_<uuid>") are rebuilt
        # deterministically from the function name + a running call index,
        # with tool responses remapped through the same table — raising on
        # foreign ids would break every round-trip the server itself
        # started before this normalization existed.
        remap: Dict[str, str] = {}
        used, returned = set(), set()
        call_index = 0
        fixed = []
        for m in messages:
            m = dict(m)
            if m.get("tool_calls"):
                calls = []
                for tc in m["tool_calls"]:
                    tc = dict(tc)
                    fname = (tc.get("function") or {}).get("name", "tool")
                    old = tc.get("id")
                    wire = old if old and _ID_PATTERN.match(old) \
                        else f"functions.{fname}:{call_index}"
                    if old is not None and old != wire:
                        remap[old] = wire
                    tc["id"] = wire
                    used.add(wire)
                    call_index += 1
                    calls.append(tc)
                m["tool_calls"] = calls
            if m.get("tool_call_id") is not None:
                tid = m["tool_call_id"]
                m["tool_call_id"] = remap.get(tid, tid)
                returned.add(m["tool_call_id"])
            fixed.append(m)
        missing = used - returned
        if missing:
            raise ValueError(
                "missing tool responses for: " + ", ".join(sorted(missing)))
        return super().render(fixed, tools, add_generation_prompt,
                              chat_template_kwargs)

    def extra_stop_words(self) -> List[str]:
        return ["<|im_end|>"]


for _mt in ("kimi_k2", "kimi_k25", "kimi_linear"):
    register_renderer(_mt, KimiK2Renderer)
