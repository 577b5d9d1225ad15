"""Chat prompt rendering (port of the default renderer of
``rtp_llm_tpu/frontend/chat_renderer.py``): OpenAI-style messages to prompt
token ids through the tokenizer's own HF chat template, plus per-request stop
material. The legacy templates and the model-specific tool / reasoning
renderers are not ported.
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

    def render(self, messages: List[Dict[str, Any]], tools: Optional[List[dict]] = None,
               add_generation_prompt: bool = True,
               chat_template_kwargs: Optional[dict] = None) -> RenderedPrompt:
        kwargs = dict(chat_template_kwargs or {})
        if tools:
            kwargs["tools"] = tools
        ids = self.tok.apply_chat_template(
            messages, add_generation_prompt=add_generation_prompt, tokenize=True,
            **kwargs)
        if hasattr(ids, "input_ids"):  # some tokenizers return BatchEncoding
            ids = ids.input_ids
        return RenderedPrompt(token_ids=list(ids), stop_words=self.extra_stop_words(),
                              stop_token_ids=self.extra_stop_token_ids())

    def extra_stop_words(self) -> List[str]:
        # qwen-family chat ends turns with <|im_end|>
        return ["<|im_end|>"] if self.model_type.startswith("qwen") else []

    def extra_stop_token_ids(self) -> List[int]:
        out = []
        for tok_str in ("<|im_end|>", "<|eot_id|>"):
            tid = self.tok.convert_tokens_to_ids(tok_str)
            if tid is not None and tid >= 0 and tid != getattr(self.tok, "unk_token_id", None):
                out.append(int(tid))
        return out
