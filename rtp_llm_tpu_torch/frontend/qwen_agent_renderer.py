"""Qwen agent / tool-call renderer: the dashscope fncall protocol.

Port of ``rtp_llm_tpu/frontend/qwen_agent_renderer.py``.

Reference: rtp_llm/openai/renderers/qwen_agent_renderer.py +
qwen_agent/llm/function_calling.py:340-440 — when a request carries tools,
the prompt grows a "# Tools" system section describing each function and the
command grammar, assistant tool calls render as

    ✿FUNCTION✿: <name>
    ✿ARGS✿: <json args>

tool results splice back as ``✿RESULT✿: ...`` followed by ``✿RETURN✿:``,
and generation stops on ✿RESULT✿/✿RETURN✿ so the server can intercept the
call. Requests without tools fall through to the model's own chat template
(same split the reference makes, qwen_agent_renderer.py:70-76).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from rtp_llm_tpu_torch.frontend.chat_renderer import (
    ChatRenderer, RenderedPrompt, register_renderer,
)
from rtp_llm_tpu_torch.frontend.tool_detectors import ToolDetector, _mk_call

FN_NAME = "✿FUNCTION✿"
FN_ARGS = "✿ARGS✿"
FN_RESULT = "✿RESULT✿"
FN_EXIT = "✿RETURN✿"

FN_CALL_TEMPLATE_EN = """# Tools

## You have access to the following tools:

{tool_descs}

## When you need to call a tool, please insert the following command in \
your reply, which can be called zero or multiple times according to your \
needs:

%s: The tool to use, should be one of [{tool_names}]
%s: The input of the tool
%s: Tool results
%s: Reply based on tool results. Images need to be rendered as ![](url)""" % (
    FN_NAME, FN_ARGS, FN_RESULT, FN_EXIT,
)


def _tool_desc(fn: dict) -> str:
    name = fn.get("name", "")
    desc = fn.get("description", "")
    params = json.dumps(fn.get("parameters", {}), ensure_ascii=False)
    return (f"### {name}\n\n{name}: {desc} Parameters: {params} "
            "Format the arguments as a JSON object.")


class QwenAgentRenderer(ChatRenderer):
    """fncall prompts for qwen-family agent/tool model types."""

    def render(
        self,
        messages: List[Dict[str, Any]],
        tools: Optional[List[dict]] = None,
        add_generation_prompt: bool = True,
        chat_template_kwargs: Optional[dict] = None,
    ) -> RenderedPrompt:
        if not tools:
            return super().render(messages, None, add_generation_prompt,
                                  chat_template_kwargs)
        fns = [t.get("function", t) for t in tools]
        tool_system = FN_CALL_TEMPLATE_EN.format(
            tool_descs="\n\n".join(_tool_desc(f) for f in fns),
            tool_names=",".join(f.get("name", "") for f in fns),
        )
        out: List[Dict[str, Any]] = []
        for m in messages:
            role = m.get("role")
            if role == "system":
                out.append(dict(m))
            elif role == "assistant" and m.get("tool_calls"):
                parts = [m.get("content") or ""]
                for tc in m["tool_calls"]:
                    f = tc.get("function", tc)
                    args = f.get("arguments", "")
                    if not isinstance(args, str):
                        args = json.dumps(args, ensure_ascii=False)
                    parts.append(f"{FN_NAME}: {f.get('name', '')}\n"
                                 f"{FN_ARGS}: {args}")
                out.append({"role": "assistant",
                            "content": "\n".join(p for p in parts if p)})
            elif role in ("tool", "function"):
                # tool results splice into the PRECEDING assistant turn
                # (function_calling.py:95-102): ✿RESULT✿ then an open
                # ✿RETURN✿ the model completes
                result = m.get("content") or ""
                text = f"\n{FN_RESULT}: {result}\n{FN_EXIT}: "
                if out and out[-1]["role"] == "assistant":
                    out[-1]["content"] += text
                else:
                    out.append({"role": "assistant", "content": text})
            else:
                out.append(dict(m))
        # inject the tool section into (or as) the system message
        if out and out[0]["role"] == "system":
            out[0]["content"] = (out[0].get("content") or "") + "\n\n" + tool_system
        else:
            out.insert(0, {"role": "system", "content": tool_system})
        # an open ✿RETURN✿ assistant turn means the model continues that
        # turn rather than opening a new one
        continue_final = bool(out and out[-1]["role"] == "assistant"
                              and out[-1]["content"].endswith(f"{FN_EXIT}: "))
        kwargs = dict(chat_template_kwargs or {})
        if continue_final:
            ids = self.tok.apply_chat_template(
                out, add_generation_prompt=False, continue_final_message=True,
                tokenize=True, **kwargs)
        else:
            ids = self.tok.apply_chat_template(
                out, add_generation_prompt=add_generation_prompt,
                tokenize=True, **kwargs)
        if hasattr(ids, "input_ids"):
            ids = ids.input_ids
        return RenderedPrompt(
            token_ids=list(ids),
            stop_words=[FN_RESULT, FN_EXIT] + self.extra_stop_words(),
            stop_token_ids=self.extra_stop_token_ids(),
        )


class QwenAgentDetector(ToolDetector):
    """Parse ✿FUNCTION✿/✿ARGS✿ command blocks out of a completion
    (reference: function_calling.py:268-320 postprocess)."""

    name = "qwen_agent"
    bot_token = FN_NAME

    def parse(self, text: str) -> Tuple[Optional[List[dict]], str]:
        if FN_NAME not in text:
            return None, text
        head, *blocks = text.split(f"{FN_NAME}:")
        calls = []
        for blk in blocks:
            blk = blk.split(FN_RESULT)[0].split(FN_EXIT)[0]
            if f"{FN_ARGS}:" in blk:
                name, args = blk.split(f"{FN_ARGS}:", 1)
            else:
                name, args = blk, ""
            calls.append(_mk_call(name.strip(), args.strip()))
        return (calls or None), head.strip()


from rtp_llm_tpu_torch.frontend.tool_detectors import (  # noqa: E402
    map_model_type, register_detector,
)

register_detector("qwen_agent", QwenAgentDetector)
for _mt in ("qwen_agent", "qwen_tool", "qwen_3_tool"):
    register_renderer(_mt, QwenAgentRenderer)
    map_model_type(_mt, "qwen_agent")
