"""Legacy conversation templates for checkpoints without an HF chat template.

Port of ``rtp_llm_tpu/frontend/legacy_templates.py``.

TPU-port-neutral analog of the reference's LLaMA-Factory-derived template
registry (rtp_llm/openai/renderers/llama_template.py — register_template
entries for llama2/vicuna/baichuan/internlm/falcon/... ) used by
LlamaTemplateRenderer (llama_template_renderer.py:30). Older checkpoints
(llama-2 chat, baichuan, internlm v1, falcon-instruct, legacy deepseek)
ship tokenizers with no ``chat_template`` — applying the HF template raises,
so rendering falls back to these hand-specified turn formats.

Each template is four format strings + stop words; rendering builds one
prompt string (system + alternating user/assistant turns + generation
prefix) and tokenizes it once. This deliberately avoids the reference's
turn-by-turn ``encode_oneturn`` machinery: one tokenizer call on the full
string is equivalent for these plain-text templates and far simpler.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class ConversationTemplate:
    """A legacy turn format.

    ``system_fmt`` wraps the system message (or ``default_system`` if none),
    ``user_fmt`` / ``assistant_fmt`` wrap one turn each, ``assistant_prefix``
    opens the turn the model is asked to complete. ``{content}`` is
    substituted in each.
    """

    name: str
    user_fmt: str
    assistant_fmt: str
    system_fmt: str = ""
    default_system: str = ""
    assistant_prefix: str = ""
    prefix: str = ""          # fixed prompt head (e.g. "<s>")
    stop_words: tuple = ()
    use_bos: bool = False     # prepend tokenizer BOS token id

    def build_prompt(self, messages: List[Dict[str, Any]]) -> str:
        system = self.default_system
        turns = []
        for m in messages:
            role = m.get("role")
            content = m.get("content") or ""
            if not isinstance(content, str):
                # multimodal parts: concatenate the text pieces
                content = "".join(
                    p.get("text", "") for p in content
                    if isinstance(p, dict) and p.get("type") == "text")
            if role == "system":
                system = content
            elif role in ("user", "tool"):
                turns.append(("user", content))
            elif role == "assistant":
                turns.append(("assistant", content))
        out = self.prefix
        if system and self.system_fmt:
            out += self.system_fmt.format(content=system)
        for role, content in turns:
            fmt = self.user_fmt if role == "user" else self.assistant_fmt
            out += fmt.format(content=content)
        return out + self.assistant_prefix


# formats are from the models' public prompt conventions (llama-2 [INST]
# blocks, vicuna USER/ASSISTANT, internlm <|User|>/<|Bot|>, baichuan2
# reserved tokens, falcon-instruct User/Assistant, legacy deepseek-chat)
TEMPLATES: dict[str, ConversationTemplate] = {}


def _add(t: ConversationTemplate, *aliases: str) -> None:
    TEMPLATES[t.name] = t
    for a in aliases:
        TEMPLATES[a] = t


_add(ConversationTemplate(
    name="llama2",
    system_fmt="<<SYS>>\n{content}\n<</SYS>>\n\n",
    user_fmt="[INST] {content} [/INST]",
    assistant_fmt=" {content} </s><s>",
    use_bos=True,
), "llama", "llama2_zh")
# llama2's system block nests inside the FIRST [INST]; handled in render()

_add(ConversationTemplate(
    name="vicuna",
    system_fmt="{content}\n\n",
    default_system=("A chat between a curious user and an artificial "
                    "intelligence assistant. The assistant gives helpful, "
                    "detailed, and polite answers to the user's questions."),
    user_fmt="USER: {content} ",
    assistant_fmt="ASSISTANT: {content}</s>",
    assistant_prefix="ASSISTANT:",
    use_bos=True,
), "default")

_add(ConversationTemplate(
    name="baichuan2",
    system_fmt="{content}",
    user_fmt="<reserved_106>{content}",
    assistant_fmt="<reserved_107>{content}",
    assistant_prefix="<reserved_107>",
), "baichuan", "baichuan2-13b", "baichuan_13b")

_add(ConversationTemplate(
    name="internlm",
    user_fmt="<|User|>:{content}<eoh>\n",
    assistant_fmt="<|Bot|>:{content}<eoa>\n",
    assistant_prefix="<|Bot|>:",
    stop_words=("<eoa>",),
    use_bos=True,
))

_add(ConversationTemplate(
    name="internlm2",
    system_fmt="<|im_start|>system\n{content}<|im_end|>\n",
    user_fmt="<|im_start|>user\n{content}<|im_end|>\n",
    assistant_fmt="<|im_start|>assistant\n{content}<|im_end|>\n",
    assistant_prefix="<|im_start|>assistant\n",
    stop_words=("<|im_end|>",),
    use_bos=True,
))

_add(ConversationTemplate(
    name="falcon",
    system_fmt="{content}\n",
    user_fmt="User: {content}\nFalcon:",
    assistant_fmt=" {content}\n",
    stop_words=("\nUser:",),
))

_add(ConversationTemplate(
    name="deepseek",
    system_fmt="{content}\n\n",
    user_fmt="User: {content}\n\n",
    assistant_fmt="Assistant: {content}<｜end▁of▁sentence｜>",
    assistant_prefix="Assistant:",
    use_bos=True,
))

_add(ConversationTemplate(
    name="deepseekcoder",
    system_fmt="{content}\n",
    default_system=(
        "You are an AI programming assistant, utilizing the Deepseek Coder "
        "model, developed by Deepseek Company, and you only answer "
        "questions related to computer science."),
    user_fmt="### Instruction:\n{content}\n",
    assistant_fmt="### Response:\n{content}\n<|EOT|>\n",
    assistant_prefix="### Response:\n",
    stop_words=("<|EOT|>",),
))

_add(ConversationTemplate(
    name="chatml",
    system_fmt="<|im_start|>system\n{content}<|im_end|>\n",
    default_system="You are a helpful assistant.",
    user_fmt="<|im_start|>user\n{content}<|im_end|>\n",
    assistant_fmt="<|im_start|>assistant\n{content}<|im_end|>\n",
    assistant_prefix="<|im_start|>assistant\n",
    stop_words=("<|im_end|>",),
), "qwen", "yi", "starchat", "bluelm")

_add(ConversationTemplate(
    name="alpaca",
    system_fmt="{content}\n\n",
    default_system=("Below is an instruction that describes a task. "
                    "Write a response that appropriately completes the "
                    "request.\n\n"),
    user_fmt="### Instruction:\n{content}\n\n",
    assistant_fmt="### Response:\n{content}\n\n",
    assistant_prefix="### Response:\n",
))

_add(ConversationTemplate(
    name="zephyr",
    system_fmt="<|system|>\n{content}</s>\n",
    default_system="You are a friendly chatbot.",
    user_fmt="<|user|>\n{content}</s>\n",
    assistant_fmt="<|assistant|>\n{content}</s>\n",
    assistant_prefix="<|assistant|>\n",
))


def template_for(model_type: str) -> Optional[ConversationTemplate]:
    """Best template for a model type (exact name, then prefix match)."""
    if model_type in TEMPLATES:
        return TEMPLATES[model_type]
    # longest name wins so "internlm2_chat" matches internlm2, not internlm
    best = None
    for name, t in TEMPLATES.items():
        if model_type.startswith(name) and (
                best is None or len(name) > len(best[0])):
            best = (name, t)
    return best[1] if best else None


def render_legacy(tokenizer, template: ConversationTemplate,
                  messages: List[Dict[str, Any]]) -> tuple:
    """(token_ids, stop_words) for a legacy-template conversation."""
    if template.name == "llama2":
        # the system block nests inside the first [INST]
        sys_txt = ""
        rest = []
        for m in messages:
            if m.get("role") == "system" and not rest:
                sys_txt = m.get("content") or ""
            else:
                rest.append(dict(m))
        if sys_txt and rest and rest[0].get("role") == "user":
            rest[0]["content"] = (
                template.system_fmt.format(content=sys_txt)
                + (rest[0].get("content") or ""))
        prompt = dataclasses.replace(template, system_fmt="").build_prompt(
            rest)
    else:
        prompt = template.build_prompt(messages)
    ids = tokenizer(prompt, add_special_tokens=False)
    if hasattr(ids, "input_ids"):
        ids = ids.input_ids
    ids = list(ids)
    bos = getattr(tokenizer, "bos_token_id", None)
    if template.use_bos and bos is not None and (not ids or ids[0] != bos):
        ids = [int(bos)] + ids
    return ids, list(template.stop_words)
