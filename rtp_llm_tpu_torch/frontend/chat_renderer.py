"""Chat prompt rendering (port of ``rtp_llm_tpu/frontend/chat_renderer.py``).

Analog of the reference's renderer framework (rtp_llm/openai/renderers/
custom_renderer.py:304 + renderer_factory.py): turns OpenAI-style messages
into prompt token ids plus per-request stop material. The default renderer
uses the model's own HF chat template (which covers qwen/llama/deepseek chat
formats), with the legacy conversation templates (``legacy_templates.py``)
for tokenizers that have none; the model-specific tool-call / reasoning
renderers (deepseek, glm4, kimi, qwen agent) layer on top via the registry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class RenderedPrompt:
    token_ids: List[int]
    stop_words: List[str]
    stop_token_ids: List[int]


class ChatRenderer:
    """HF-chat-template based default renderer."""

    def __init__(self, tokenizer, model_type: str = ""):
        self.tok = tokenizer
        self.model_type = model_type

    def render(
        self,
        messages: List[Dict[str, Any]],
        tools: Optional[List[dict]] = None,
        add_generation_prompt: bool = True,
        chat_template_kwargs: Optional[dict] = None,
    ) -> RenderedPrompt:
        kwargs = dict(chat_template_kwargs or {})
        if tools:
            kwargs["tools"] = tools
        # tokenizers shipping no chat template (legacy checkpoints:
        # llama-2, baichuan, internlm v1, falcon-instruct, ...) fall back
        # to the hand-specified conversation templates (reference:
        # LlamaTemplateRenderer, llama_template.py). Real template errors
        # on tokenizers that DO have one must surface, not degrade.
        if not getattr(self.tok, "chat_template", None) and not hasattr(
                self.tok, "default_chat_template"):
            try:
                ids = self.tok.apply_chat_template(
                    messages,
                    add_generation_prompt=add_generation_prompt,
                    tokenize=True,
                    **kwargs,
                )
            except (ValueError, AttributeError, TypeError):
                return self._render_legacy(messages)
        else:
            ids = self.tok.apply_chat_template(
                messages,
                add_generation_prompt=add_generation_prompt,
                tokenize=True,
                **kwargs,
            )
        if hasattr(ids, "input_ids"):  # some tokenizers return BatchEncoding
            ids = ids.input_ids
        return RenderedPrompt(
            token_ids=list(ids),
            stop_words=self.extra_stop_words(),
            stop_token_ids=self.extra_stop_token_ids(),
        )

    def _render_legacy(self, messages) -> RenderedPrompt:
        from rtp_llm_tpu_torch.frontend.legacy_templates import (
            TEMPLATES, render_legacy, template_for,
        )

        tpl = template_for(self.model_type) or TEMPLATES["default"]
        ids, stops = render_legacy(self.tok, tpl, messages)
        return RenderedPrompt(
            token_ids=ids,
            stop_words=stops + self.extra_stop_words(),
            stop_token_ids=self.extra_stop_token_ids(),
        )

    def extra_stop_words(self) -> List[str]:
        # qwen-family chat ends turns with <|im_end|>
        if self.model_type.startswith("qwen"):
            return ["<|im_end|>"]
        return []

    def extra_stop_token_ids(self) -> List[int]:
        out = []
        for tok_str in ("<|im_end|>", "<|eot_id|>"):
            tid = self.tok.convert_tokens_to_ids(tok_str) if hasattr(
                self.tok, "convert_tokens_to_ids") else None
            if tid is not None and tid >= 0 and tid != getattr(self.tok, "unk_token_id", None):
                out.append(int(tid))
        return out


_RENDERERS: dict = {}


def register_renderer(model_type: str, factory):
    """Registry hook (reference: renderer_factory.py)."""
    _RENDERERS[model_type] = factory


def _load_builtin_renderers():
    """Import renderer modules for their registration side effects
    (reference: renderer_factory imports every renderers/ module)."""
    import rtp_llm_tpu_torch.frontend.deepseek_renderer  # noqa: F401
    import rtp_llm_tpu_torch.frontend.glm4_renderer  # noqa: F401
    import rtp_llm_tpu_torch.frontend.kimi_renderer  # noqa: F401
    import rtp_llm_tpu_torch.frontend.qwen_agent_renderer  # noqa: F401


def create_renderer(tokenizer, model_type: str = "") -> ChatRenderer:
    if not _RENDERERS:
        _load_builtin_renderers()
    factory = _RENDERERS.get(model_type, ChatRenderer)
    return factory(tokenizer, model_type)
