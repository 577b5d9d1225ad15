"""Generated-text post-processors: tool calls + reasoning extraction (port of
``rtp_llm_tpu/frontend/output_parsers.py``).

Analog of the reference's renderer-side parsers (rtp_llm/openai/renderers/ —
qwen tool/agent renderers, reasoning_tool_parsing, deepseek/kimi variants):
model output is scanned for the family's structured segments and converted to
OpenAI response fields:

  * qwen/hermes style  : <tool_call>{"name":..., "arguments":...}</tool_call>
  * reasoning ("think"): <think> ... </think>  -> message.reasoning_content
"""

from __future__ import annotations

import dataclasses
import json
import re
import uuid
from typing import List, Optional, Tuple

from rtp_llm_tpu_torch.frontend.tool_detectors import ToolDetector

_TOOL_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)
_THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)


@dataclasses.dataclass
class ParsedOutput:
    content: str
    reasoning_content: Optional[str] = None
    tool_calls: Optional[List[dict]] = None

    @property
    def finish_reason(self) -> Optional[str]:
        return "tool_calls" if self.tool_calls else None


def parse_reasoning(text: str) -> Tuple[Optional[str], str]:
    """Extract <think> blocks; returns (reasoning, remaining_text).

    Handles the open-ended case (model started thinking, output cut before
    </think>): everything after <think> counts as reasoning."""
    blocks = _THINK_RE.findall(text)
    rest = _THINK_RE.sub("", text)
    open_idx = rest.find("<think>")
    if open_idx != -1:
        blocks.append(rest[open_idx + len("<think>"):])
        rest = rest[:open_idx]
    reasoning = "\n".join(b.strip() for b in blocks if b.strip()) or None
    return reasoning, rest


def parse_tool_calls(text: str) -> Tuple[Optional[List[dict]], str]:
    """Extract qwen/hermes <tool_call> JSON blocks into OpenAI tool_calls."""
    calls = []
    for raw in _TOOL_RE.findall(text):
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError:
            continue
        name = obj.get("name")
        if not name:
            continue
        args = obj.get("arguments", obj.get("parameters", {}))
        calls.append({
            "id": "call_" + uuid.uuid4().hex[:24],
            "type": "function",
            "function": {
                "name": name,
                "arguments": json.dumps(args, ensure_ascii=False)
                if not isinstance(args, str) else args,
            },
        })
    rest = _TOOL_RE.sub("", text).strip()
    return (calls or None), rest


def parse_output(text: str, enable_thinking: bool = True,
                 enable_tools: bool = True, detector=None) -> ParsedOutput:
    """detector: a frontend.tool_detectors.ToolDetector for the model
    family's tool wire format (None = hermes/qwen default)."""
    reasoning = None
    if enable_thinking:
        reasoning, text = parse_reasoning(text)
    tool_calls = None
    if enable_tools:
        if detector is not None:
            tool_calls, text = detector.parse(text)
        else:
            tool_calls, text = parse_tool_calls(text)
    return ParsedOutput(
        content=text.strip(), reasoning_content=reasoning, tool_calls=tool_calls
    )


class StreamingOutputParser:
    """Incremental version of ``parse_output`` for SSE streaming.

    Reference analog: the streaming think/tool renderers
    (rtp_llm/openai/renderers/reasoning_tool_*): each text delta is split into
    a ``reasoning_content`` delta and a ``content`` delta, with partial tags
    held back until they can be classified; ``<tool_call>`` regions are
    buffered whole and returned as parsed tool calls at finalize.
    """

    def __init__(self, enable_thinking: bool = True, enable_tools: bool = True,
                 detector=None):
        self.enable_thinking = enable_thinking
        self.enable_tools = enable_tools
        self.detector = detector or ToolDetector()
        self._bot = self.detector.bot_token
        self._tags = ("<think>", "</think>", self._bot)
        self._maxtag = max(len(t) for t in self._tags)
        self._mode = "content"  # content | think | tool
        self._buf = ""          # undecided tail (possible partial tag)
        self._tool_buf = ""     # everything from the first tool marker on

    def _holdback(self, text: str) -> Tuple[str, str]:
        """Split text into (emit, hold) where hold is the longest suffix that
        could still grow into one of the tags."""
        for n in range(min(len(text), self._maxtag), 0, -1):
            tail = text[-n:]
            if any(t.startswith(tail) for t in self._tags):
                return text[:-n], text[-n:]
        return text, ""

    def push(self, delta: str) -> Tuple[str, str]:
        """Returns (reasoning_delta, content_delta) ready to emit now."""
        self._buf += delta
        reasoning_out, content_out = [], []
        while True:
            if self._mode == "tool":
                self._tool_buf += self._buf
                self._buf = ""
                break
            tag = "</think>" if self._mode == "think" else "<think>"
            sink = reasoning_out if self._mode == "think" else content_out
            idx = self._buf.find(tag) if self.enable_thinking else -1
            tool_idx = self._buf.find(self._bot) if self.enable_tools else -1
            if tool_idx != -1 and (idx == -1 or tool_idx < idx) \
                    and self._mode != "think":
                sink.append(self._buf[:tool_idx])
                self._tool_buf = self._buf[tool_idx:]
                self._buf = ""
                self._mode = "tool"
                continue
            if idx == -1:
                emit, self._buf = self._holdback(self._buf)
                sink.append(emit)
                break
            sink.append(self._buf[:idx])
            self._buf = self._buf[idx + len(tag):]
            self._mode = "content" if self._mode == "think" else "think"
        return "".join(reasoning_out), "".join(content_out)

    def finalize(self) -> Tuple[str, str, Optional[List[dict]]]:
        """Flush held text. Returns (reasoning, content, tool_calls)."""
        reasoning, content = "", ""
        if self._buf:
            if self._mode == "think":
                reasoning = self._buf  # unclosed think: counts as reasoning
            else:
                content = self._buf
            self._buf = ""
        tool_calls = None
        if self._tool_buf:
            tool_calls, rest = self.detector.parse(self._tool_buf)
            content += rest
            self._tool_buf = ""
        return reasoning, content, tool_calls
