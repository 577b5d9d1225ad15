"""Model-family tool-call detectors (port of
``rtp_llm_tpu/frontend/tool_detectors.py``).

Analog of the reference's function-call detector registry
(rtp_llm/openai/renderers/sglang_helpers/function_call/*_detector.py): each
model family emits tool calls in its own wire format; a detector turns the
generated text into OpenAI ``tool_calls`` entries plus the remaining normal
text. The prompt side is handled by the model's own chat template (HF
tokenizer), so only the *output* protocol needs per-family code.

Formats covered (reference file in parens):
  hermes / qwen2.5   : <tool_call>{json}</tool_call>        (qwen25_detector)
  qwen3_coder        : <tool_call><function=name><parameter=k>v</parameter>
                       ...</function></tool_call>       (qwen3_coder_detector)
  glm4_moe (glm4.5+) : <tool_call>name<arg_key>k</arg_key>
                       <arg_value>v</arg_value>...</tool_call>
                                                         (glm4_moe_detector)
  deepseek_v31       : <｜tool▁calls▁begin｜><｜tool▁call▁begin｜>name
                       <｜tool▁sep｜>args<｜tool▁call▁end｜>…
                       <｜tool▁calls▁end｜>            (deepseekv31_detector)
  kimi_k2            : <|tool_calls_section_begin|><|tool_call_begin|>
                       functions.name:idx<|tool_call_argument_begin|>{json}
                       <|tool_call_end|><|tool_calls_section_end|>
                                                           (kimik2_detector)
"""

from __future__ import annotations

import json
import re
import uuid
from typing import List, Optional, Tuple


def _mk_call(name: str, arguments) -> dict:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments, ensure_ascii=False)
    return {
        "id": "call_" + uuid.uuid4().hex[:24],
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


class ToolDetector:
    """Base: hermes/qwen json-in-tags format."""

    name = "hermes"
    bot_token = "<tool_call>"  # first marker of a tool region (stream buffer)

    _RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)

    def parse(self, text: str) -> Tuple[Optional[List[dict]], str]:
        calls = []
        for raw in self._RE.findall(text):
            try:
                obj = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if obj.get("name"):
                calls.append(_mk_call(
                    obj["name"], obj.get("arguments", obj.get("parameters", {}))
                ))
        rest = self._RE.sub("", text).strip()
        return (calls or None), rest


class Qwen3CoderDetector(ToolDetector):
    name = "qwen3_coder"

    _FUNC = re.compile(r"<function=(.*?)</function>", re.DOTALL)
    _PARAM = re.compile(
        r"<parameter=(.*?)(?:</parameter>|(?=<parameter=)|(?=</function>)|$)",
        re.DOTALL,
    )

    def parse(self, text: str):
        calls = []
        for block in self._RE.findall(text):
            for func in self._FUNC.findall(block + "</function>"):
                head, _, body = func.partition(">")
                fname = head.strip()
                args = {}
                for p in self._PARAM.findall(body):
                    k, _, v = p.partition(">")
                    args[k.strip()] = _coerce(v.strip())
                if fname:
                    calls.append(_mk_call(fname, args))
        rest = self._RE.sub("", text).strip()
        return (calls or None), rest


def _coerce(v: str):
    """qwen3-coder parameters are typed by content (reference detector uses
    the tool schema; literal-eval style coercion covers the common cases)."""
    try:
        return json.loads(v)
    except (json.JSONDecodeError, ValueError):
        return v


class Glm4MoeDetector(ToolDetector):
    name = "glm4_moe"

    _DETAIL = re.compile(r"<tool_call>(.*?)(<arg_key>.*)?</tool_call>",
                         re.DOTALL)
    _ARG = re.compile(
        r"<arg_key>(.*?)</arg_key>(?:\\n|\s)*<arg_value>(.*?)</arg_value>",
        re.DOTALL,
    )

    def parse(self, text: str):
        calls = []
        for block in self._RE.findall(text):
            m = self._DETAIL.search(block)
            if not m:
                continue
            fname = m.group(1).strip()
            args = {k.strip(): _coerce(v.strip())
                    for k, v in self._ARG.findall(m.group(2) or "")}
            if fname:
                calls.append(_mk_call(fname, args))
        rest = self._RE.sub("", text).strip()
        return (calls or None), rest

    _RE = re.compile(r"<tool_call>.*?</tool_call>", re.DOTALL)


class DeepseekV31Detector(ToolDetector):
    name = "deepseek_v31"
    bot_token = "<｜tool▁calls▁begin｜>"

    _CALL = re.compile(
        r"<｜tool▁call▁begin｜>(.*?)<｜tool▁sep｜>(.*?)<｜tool▁call▁end｜>",
        re.DOTALL,
    )
    _REGION = re.compile(
        r"<｜tool▁calls▁begin｜>.*?(?:<｜tool▁calls▁end｜>|$)", re.DOTALL
    )

    def parse(self, text: str):
        calls = [
            _mk_call(nm.strip(), args.strip())
            for nm, args in self._CALL.findall(text)
            if nm.strip()
        ]
        rest = self._REGION.sub("", text).strip()
        return (calls or None), rest


class KimiK2Detector(ToolDetector):
    name = "kimi_k2"
    bot_token = "<|tool_calls_section_begin|>"

    _CALL = re.compile(
        r"<\|tool_call_begin\|>\s*(?P<id>[\w\.]+:\d+)\s*"
        r"<\|tool_call_argument_begin\|>(?P<args>.*?)<\|tool_call_end\|>",
        re.DOTALL,
    )
    _REGION = re.compile(
        r"<\|tool_calls_section_begin\|>.*?(?:<\|tool_calls_section_end\|>|$)",
        re.DOTALL,
    )

    def parse(self, text: str):
        calls = []
        for m in self._CALL.finditer(text):
            fid = m.group("id")  # functions.{name}:{idx}
            fname = fid.split(":")[0]
            if fname.startswith("functions."):
                fname = fname[len("functions."):]
            call = _mk_call(fname, m.group("args").strip())
            # keep kimi's wire id (functions.{name}:{idx}): the chat
            # template expects the SAME id echoed back in the tool
            # round-trip (kimi_renderer validates the format)
            call["id"] = fid if fid.startswith("functions.") \
                else "functions." + fid
            calls.append(call)
        rest = self._REGION.sub("", text).strip()
        return (calls or None), rest


_DETECTORS = {
    "hermes": ToolDetector,
    "qwen3_coder": Qwen3CoderDetector,
    "glm4_moe": Glm4MoeDetector,
    "deepseek_v31": DeepseekV31Detector,
    "kimi_k2": KimiK2Detector,
}


def register_detector(name: str, cls) -> None:
    """Registry hook for renderer modules that ship their own detector
    (reference: renderer_factory_register)."""
    _DETECTORS[name] = cls


def map_model_type(model_type: str, detector_name: str) -> None:
    _MODEL_MAP[model_type] = detector_name

# model_type -> detector name (families not listed use hermes, which matches
# qwen/llama hermes-style templates)
_MODEL_MAP = {
    "qwen3_coder": "qwen3_coder",
    "glm4_moe": "glm4_moe",
    "glm4v_moe": "glm4_moe",
    "chatglm45": "glm4_moe",
    "deepseek_v31": "deepseek_v31",
    "deepseek_v32": "deepseek_v31",
    "deepseek_v3": "deepseek_v31",
    "kimi_k2": "kimi_k2",
    "kimi_k25": "kimi_k2",
}


def get_tool_detector(model_type: str = "", detector: str = "") -> ToolDetector:
    key = detector or _MODEL_MAP.get(model_type, "hermes")
    return _DETECTORS.get(key, ToolDetector)()
