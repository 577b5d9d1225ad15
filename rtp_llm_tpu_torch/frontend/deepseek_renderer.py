"""DeepSeek V3.1/V3.2 chat renderer: thinking-mode template plumbing.

Port of ``rtp_llm_tpu/frontend/deepseek_renderer.py``.

Reference: rtp_llm/openai/renderers/deepseekv31_renderer.py — the template
keys on a ``thinking`` variable; ``enable_thinking`` (the qwen-style request
field) maps onto it. V3.1 does not support deep thinking during tool calls
(deepseekv31_renderer.py:116-159) so tools force thinking OFF there; V3.2
interleaves thinking with tool calls, so it keeps the caller's choice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from rtp_llm_tpu_torch.frontend.chat_renderer import (
    ChatRenderer, RenderedPrompt, register_renderer,
)


class DeepseekV31Renderer(ChatRenderer):
    #: V3.1 templates cannot think during tool calls; V3.2 subclass clears it
    disable_thinking_with_tools = True

    def render(
        self,
        messages: List[Dict[str, Any]],
        tools: Optional[List[dict]] = None,
        add_generation_prompt: bool = True,
        chat_template_kwargs: Optional[dict] = None,
    ) -> RenderedPrompt:
        kwargs = dict(chat_template_kwargs or {})
        if "thinking" not in kwargs and "enable_thinking" in kwargs:
            kwargs["thinking"] = bool(kwargs["enable_thinking"])
        kwargs.pop("enable_thinking", None)
        if tools and self.disable_thinking_with_tools:
            kwargs["thinking"] = False
        return super().render(messages, tools, add_generation_prompt, kwargs)


class DeepseekV32Renderer(DeepseekV31Renderer):
    disable_thinking_with_tools = False


for _mt in ("deepseek_v31", "deepseek_v3", "deepseek3", "deepseek-v3-mtp"):
    register_renderer(_mt, DeepseekV31Renderer)
register_renderer("deepseek_v32", DeepseekV32Renderer)
