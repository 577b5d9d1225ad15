"""GLM-4 chat renderer: <|role|> special-token protocol + tool system text.

Port of ``rtp_llm_tpu/frontend/glm4_renderer.py``.

Reference: rtp_llm/openai/renderers/chatglm4_renderer.py — messages render as
``[gMASK]<sop>`` then per-turn ``<|role|>\\n{content}`` using the
tokenizer's special role tokens (system/user/assistant/observation), tool
definitions inject a GLM-4 system block, tool results take the
``observation`` role, and generation opens with ``<|assistant|>``. Stops on
<|user|>/<|observation|> so multi-turn tool loops hand control back.

The reference builds ids through its custom tiktoken wrapper; this renderer
speaks the same wire protocol through the generic HF tokenizer interface
(convert_tokens_to_ids + encode), so any GLM-4 checkpoint whose tokenizer
exposes the role special tokens serves identically. Checkpoints without
them fall back to the bundled chat template.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from rtp_llm_tpu_torch.frontend.chat_renderer import (
    ChatRenderer, RenderedPrompt, register_renderer,
)

_TOOL_SYSTEM = (
    "你是一个名为 GLM-4 的人工智能助手。你是基于智谱AI训练的语言模型 "
    "GLM-4 模型开发的，你的任务是针对用户的问题和要求提供适当的答复和支持。"
)


class Glm4Renderer(ChatRenderer):
    ROLES = ("system", "user", "assistant", "observation")

    def _tid(self, tok_str: str) -> Optional[int]:
        tid = self.tok.convert_tokens_to_ids(tok_str)
        unk = getattr(self.tok, "unk_token_id", None)
        if tid is None or tid < 0 or tid == unk:
            return None
        return int(tid)

    def _has_role_tokens(self) -> bool:
        return all(self._tid(f"<|{r}|>") is not None
                   for r in ("user", "assistant"))

    def _encode(self, text: str) -> List[int]:
        return list(self.tok.encode(text, add_special_tokens=False))

    def render(
        self,
        messages: List[Dict[str, Any]],
        tools: Optional[List[dict]] = None,
        add_generation_prompt: bool = True,
        chat_template_kwargs: Optional[dict] = None,
    ) -> RenderedPrompt:
        if not self._has_role_tokens():
            return super().render(messages, tools, add_generation_prompt,
                                  chat_template_kwargs)
        ids: List[int] = []
        for pre in ("[gMASK]", "<sop>"):
            t = self._tid(pre)
            if t is not None:
                ids.append(t)

        def add_turn(role: str, content: str):
            ids.append(self._tid(f"<|{role}|>"))
            ids.extend(self._encode("\n" + content))

        if tools:
            # tool definitions render as a GLM-4 system block
            # (chatglm4_renderer.py:70-80)
            content = _TOOL_SYSTEM
            for t in tools:
                fn = t.get("function", t)
                content += (f"\n\n## {fn.get('name', '')}\n\n"
                            f"{json.dumps(fn, ensure_ascii=False)}")
                content += "\n在调用上述函数时，请使用 Json 格式表示调用的参数。"
            add_turn("system", content)
        for m in messages:
            role = m.get("role", "user")
            content = m.get("content") or ""
            if role in ("tool", "function"):
                role = "observation"
            elif role == "assistant" and m.get("tool_calls"):
                parts = [content] if content else []
                for tc in m["tool_calls"]:
                    fn = tc.get("function", tc)
                    args = fn.get("arguments", "")
                    if not isinstance(args, str):
                        args = json.dumps(args, ensure_ascii=False)
                    parts.append(f"{fn.get('name', '')}\n{args}")
                content = "\n".join(parts)
            elif role not in self.ROLES:
                role = "user"
            add_turn(role, content)
        if add_generation_prompt:
            ids.append(self._tid("<|assistant|>"))
        stop_ids = [t for t in (self._tid("<|user|>"),
                                self._tid("<|observation|>"),
                                self._tid("<|endoftext|>")) if t is not None]
        return RenderedPrompt(
            token_ids=ids,
            stop_words=["<|user|>", "<|observation|>"],
            stop_token_ids=stop_ids,
        )


for _mt in ("glm4", "chatglm4", "glm4_moe", "glm4_moe_lite", "glm_5",
            "chatglm45"):
    register_renderer(_mt, Glm4Renderer)
