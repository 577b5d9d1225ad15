"""The port's tool detectors, output parsers, chat renderers and legacy
templates against the JAX package's, on the CPU.

* Detectors and ``parse_output``: the cases of ``tests/test_output_parsers.py``
  and ``tests/test_renderers.py`` and a corpus with ``<think>``, an unclosed
  ``<think>``, several tool calls and malformed JSON, for every detector:
  equal results, tool call ids aside (kimi's wire ids included).
* ``StreamingOutputParser``: for every split point of each text, ``push``
  then ``finalize`` gives the JAX parser's chunks, and their join equals the
  full parse up to whitespace (the full parse strips and joins think blocks
  with newlines; the streamed text is not stripped).
* Renderers: every registered model type and every legacy template alias,
  with and without tools, a tool round trip and ``enable_thinking``: token
  ids and stop material equal the JAX ``create_renderer(...).render(...)``'s
  (the fake tokenizer with the added tokens of ``tests/test_renderers.py``,
  the same tokenizer without a chat template for the legacy aliases, and the
  stub tokenizers of that file).
"""

import copy
import re

import pytest

from rtp_llm_tpu.frontend import chat_renderer as jchat
from rtp_llm_tpu.frontend import legacy_templates as jlegacy
from rtp_llm_tpu.frontend import output_parsers as jparsers
from rtp_llm_tpu.frontend import tool_detectors as jdet
from rtp_llm_tpu.frontend.tokenizer_factory import TokenizerFactory
from rtp_llm_tpu.loader.fake_checkpoint import write_fake_tokenizer
from rtp_llm_tpu_torch.frontend import chat_renderer as tchat
from rtp_llm_tpu_torch.frontend import legacy_templates as tlegacy
from rtp_llm_tpu_torch.frontend import output_parsers as tparsers
from rtp_llm_tpu_torch.frontend import tool_detectors as tdet

import torch

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

# model types by detector (each family's own format), and the default
DETECTORS = {"hermes": "qwen2", "qwen3_coder": "qwen3_coder", "glm4_moe": "glm4_moe",
             "deepseek_v31": "deepseek_v31", "kimi_k2": "kimi_k2", "qwen_agent": "qwen_tool"}
DS = ("<｜tool▁calls▁begin｜>", "<｜tool▁call▁begin｜>", "<｜tool▁sep｜>",
      "<｜tool▁call▁end｜>", "<｜tool▁calls▁end｜>")
CORPUS = {
    "think": "<think>step 1\nstep 2</think>The answer is 4.",
    "unclosed-think": "prefix<think>still going",
    "two-thinks": "<think>a</think>mid<think>b</think>end",
    "plain": "plain answer",
    "lt-in-text": "just text < here <t",
    "hermes": ('I will check the weather.\n<tool_call>\n'
               '{"name": "get_weather", "arguments": {"city": "Paris"}}\n</tool_call>'),
    "hermes-two": ('<tool_call>{"name": "a", "arguments": {}}</tool_call>'
                   '<tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>'),
    "hermes-malformed": "<tool_call>not json</tool_call>ok",
    "hermes-params": '<tool_call>{"name": "p", "parameters": {"q": [1, 2]}}</tool_call> tail',
    "think-then-tool": ('<think>user wants weather</think>Checking.'
                        '<tool_call>{"name": "w", "arguments": {}}</tool_call>'),
    "think-unclosed-tool": '<think>hmm <tool_call>{"name": "x", "arguments": {}}</tool_call>',
    "qwen3-coder": ("<tool_call><function=read_file><parameter=path>/tmp/x.txt</parameter>"
                    "<parameter=limit>10</parameter></function></tool_call>"),
    "glm4": ("<tool_call>get_weather\n<arg_key>city</arg_key>\n<arg_value>Beijing</arg_value>\n"
             "<arg_key>days</arg_key>\n<arg_value>3</arg_value></tool_call>"),
    "glm4-noargs": "<tool_call>get_time</tool_call>",
    "deepseek": (f"I will check.{DS[0]}{DS[1]}get_weather{DS[2]}{{\"city\": \"Hangzhou\"}}"
                 f"{DS[3]}{DS[1]}b{DS[2]}{{\"x\":1}}{DS[3]}{DS[4]}"),
    "deepseek-unclosed": f"ok {DS[0]}{DS[1]}f{DS[2]}{{\"a\":1}}{DS[3]}",
    "kimi": ("Let me call it.<|tool_calls_section_begin|><|tool_call_begin|>functions.get_time:0"
             '<|tool_call_argument_begin|>{"tz": "UTC"}<|tool_call_end|>'
             "<|tool_call_begin|>functions.f:1<|tool_call_argument_begin|>{}<|tool_call_end|>"
             "<|tool_calls_section_end|>"),
    "qwen-agent": 'let me check\n✿FUNCTION✿: get_weather\n✿ARGS✿: {"city": "sf"}\n',
    "qwen-agent-two": ("✿FUNCTION✿: a\n✿ARGS✿: {}\n✿RESULT✿: r\n✿FUNCTION✿: b\n"
                       '✿ARGS✿: {"x": 2}'),
}
CASES = [(d, t) for d in DETECTORS for t in CORPUS]


def _det(mod, name):
    if name == "qwen_agent":  # registered by its renderer module
        (jchat if mod is jdet else tchat)._load_builtin_renderers()
    return mod.get_tool_detector(DETECTORS[name])


def _calls(calls, keep_ids):
    return None if calls is None else [
        c if keep_ids else {k: v for k, v in c.items() if k != "id"} for c in calls]


def _parsed(p, keep_ids):
    return (p.content, p.reasoning_content, _calls(p.tool_calls, keep_ids), p.finish_reason)


@pytest.mark.parametrize("det,text", CASES, ids=[f"{d}-{t}" for d, t in CASES])
def test_detector_and_parse_output_match(det, text):
    """``detector.parse`` and ``parse_output`` equal the reference's; kimi
    keeps its deterministic wire ids, equal too."""
    keep = det == "kimi_k2"
    s = CORPUS[text]
    ours, ref = _det(tdet, det), _det(jdet, det)
    assert type(ours).__name__ == type(ref).__name__ and ours.bot_token == ref.bot_token
    (oc, orest), (rc, rrest) = ours.parse(s), ref.parse(s)
    assert (_calls(oc, keep), orest) == (_calls(rc, keep), rrest)
    for kw in ({}, {"enable_thinking": False}, {"enable_tools": False}):
        assert _parsed(tparsers.parse_output(s, detector=ours, **kw), keep) == _parsed(
            jparsers.parse_output(s, detector=ref, **kw), keep)
    assert _parsed(tparsers.ParsedOutput(*tparsers.parse_reasoning(s)[::-1]), keep) == _parsed(
        jparsers.ParsedOutput(*jparsers.parse_reasoning(s)[::-1]), keep)
    oc, orest = tparsers.parse_tool_calls(s)
    rc, rrest = jparsers.parse_tool_calls(s)
    assert (_calls(oc, False), orest) == (_calls(rc, False), rrest)


def _stream(mod, det, pieces):
    p = mod.StreamingOutputParser(detector=det)
    out = [p.push(x) for x in pieces]
    r, c, calls = p.finalize()
    return out, (r, c, calls)


def _squash(s):
    return re.sub(r"\s+", "", s or "")


@pytest.mark.parametrize("det,text", CASES, ids=[f"{d}-{t}" for d, t in CASES])
def test_streaming_parser_matches_at_every_split(det, text):
    keep = det == "kimi_k2"
    s = CORPUS[text]
    ours, ref = _det(tdet, det), _det(jdet, det)
    full = jparsers.parse_output(s, detector=ref)
    for k in range(len(s) + 1):
        pieces = [s[:k], s[k:]]
        (o_chunks, (o_r, o_c, o_calls)), (r_chunks, (r_r, r_c, r_calls)) = (
            _stream(tparsers, ours, pieces), _stream(jparsers, ref, pieces))
        assert o_chunks == r_chunks, k
        assert (o_r, o_c, _calls(o_calls, keep)) == (r_r, r_c, _calls(r_calls, keep)), k
        reasoning = "".join(r for r, _ in o_chunks) + o_r
        content = "".join(c for _, c in o_chunks) + o_c
        assert _squash(reasoning) == _squash(full.reasoning_content), k
        assert _squash(content) == _squash(full.content), k
        assert _calls(o_calls, False) == _calls(full.tool_calls, False), k


def test_streaming_char_by_char_and_options_match():
    for det in DETECTORS:
        ours, ref = _det(tdet, det), _det(jdet, det)
        for s in CORPUS.values():
            for kw in ({"enable_thinking": False}, {"enable_tools": False}, {}):
                po = tparsers.StreamingOutputParser(detector=ours, **kw)
                pr = jparsers.StreamingOutputParser(detector=ref, **kw)
                assert [po.push(ch) for ch in s] == [pr.push(ch) for ch in s]
                (a, b, c), (x, y, z) = po.finalize(), pr.finalize()
                assert (a, b, _calls(c, False)) == (x, y, _calls(z, False))


def test_detector_registry_matches():
    tchat._load_builtin_renderers()
    jchat._load_builtin_renderers()
    assert set(tdet._DETECTORS) == set(jdet._DETECTORS)
    assert tdet._MODEL_MAP == jdet._MODEL_MAP
    for mt in list(jdet._MODEL_MAP) + ["llama", "qwen2", ""]:
        ours, ref = tdet.get_tool_detector(mt), jdet.get_tool_detector(mt)
        assert type(ours).__name__ == type(ref).__name__


# ---- renderers ----

TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "look up weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]
CONVERSATIONS = {
    "plain": ([{"role": "system", "content": "w9"}, {"role": "user", "content": "w1 w2"},
               {"role": "assistant", "content": "w3"}, {"role": "user", "content": "w4"}], None),
    "tools": ([{"role": "user", "content": "w1"}], TOOLS),
    "tool-round-trip": ([
        {"role": "user", "content": "weather in sf?"},
        {"role": "assistant", "tool_calls": [{"id": "get_weather:0", "type": "function",
                                              "function": {"name": "get_weather",
                                                           "arguments": '{"city": "sf"}'}}]},
        {"role": "tool", "tool_call_id": "get_weather:0", "content": "sunny"}], TOOLS),
    "thinking-on": ([{"role": "user", "content": "w5"}], None),
    "thinking-off": ([{"role": "user", "content": "w5"}], TOOLS),
}


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    """(with a chat template, without one) as ``tests/test_renderers.py``
    builds them."""
    path = str(tmp_path_factory.mktemp("tok"))
    write_fake_tokenizer(path, 128)
    out = []
    for _ in range(2):
        tok = TokenizerFactory.create(path)
        tok.add_tokens(["✿FUNCTION✿", "✿ARGS✿", "✿RESULT✿", "✿RETURN✿",
                        "get_weather", "sunny"])
        out.append(tok)
    out[1].chat_template = None
    return out


def _registered():
    jchat._load_builtin_renderers()
    tchat._load_builtin_renderers()
    assert set(tchat._RENDERERS) == set(jchat._RENDERERS)
    return sorted(jchat._RENDERERS) + ["qwen2", "llama"]


def _render(mod, tok, model_type, conv):
    messages, tools = CONVERSATIONS[conv]
    kwargs = ({"enable_thinking": conv == "thinking-on"} if conv.startswith("thinking")
              else None)
    r = mod.create_renderer(tok, model_type).render(copy.deepcopy(messages), tools=tools,
                                                    chat_template_kwargs=kwargs)
    return r.token_ids, r.stop_words, r.stop_token_ids


RENDER_CASES = [(mt, c) for mt in _registered() for c in CONVERSATIONS]


@pytest.mark.parametrize("model_type,conv", RENDER_CASES,
                         ids=[f"{m}-{c}" for m, c in RENDER_CASES])
def test_renderer_matches(toks, model_type, conv):
    assert type(tchat.create_renderer(toks[0], model_type)).__name__ == type(
        jchat.create_renderer(toks[0], model_type)).__name__
    assert _render(tchat, toks[0], model_type, conv) == _render(jchat, toks[0], model_type, conv)


LEGACY = sorted(jlegacy.TEMPLATES) + ["internlm2_chat", "mystery_model"]
LEGACY_CASES = [(a, c) for a in LEGACY for c in ("plain", "tool-round-trip")]


@pytest.mark.parametrize("alias,conv", LEGACY_CASES, ids=[f"{a}-{c}" for a, c in LEGACY_CASES])
def test_legacy_template_matches(toks, alias, conv):
    """A tokenizer without a chat template falls back to the legacy
    templates; the template chosen and its ids and stops equal the
    reference's."""
    assert sorted(tlegacy.TEMPLATES) == sorted(jlegacy.TEMPLATES)
    ours, ref = tlegacy.template_for(alias), jlegacy.template_for(alias)
    assert (ours and ours.name) == (ref and ref.name)
    if alias in jchat._RENDERERS or alias in tchat._RENDERERS:
        return  # a registered renderer, not the default one
    assert _render(tchat, toks[1], alias, conv) == _render(jchat, toks[1], alias, conv)


class _Recorder:
    """A tokenizer that records what the chat template is given (the stubs
    of ``tests/test_renderers.py``)."""

    def __init__(self):
        self.calls = []

    def apply_chat_template(self, messages, add_generation_prompt=True, tokenize=True, **kw):
        self.calls.append((copy.deepcopy(messages), kw))
        return [1, 2, 3]

    def convert_tokens_to_ids(self, t):
        return -1


class _GlmTok:
    unk_token_id = 0
    _special = {"[gMASK]": 1, "<sop>": 2, "<|system|>": 3, "<|user|>": 4,
                "<|assistant|>": 5, "<|observation|>": 6, "<|endoftext|>": 7}

    def convert_tokens_to_ids(self, t):
        return self._special.get(t, 0)

    def encode(self, text, add_special_tokens=False):
        return [100 + (ord(c) % 50) for c in text]


STUB_TYPES = ["deepseek_v31", "deepseek_v32", "deepseek3", "kimi_k2", "kimi_linear", "glm4",
              "chatglm45", "qwen_3_tool"]


@pytest.mark.parametrize("model_type", STUB_TYPES)
@pytest.mark.parametrize("conv", sorted(CONVERSATIONS))
def test_renderer_stubs_match(model_type, conv):
    """What each renderer hands the chat template (messages and kwargs:
    ``thinking`` from ``enable_thinking``, dropped with tools on V3.1, kimi's
    wire ids), or the GLM-4 role-token ids, equal the reference's."""
    if model_type.startswith("glm") or model_type.startswith("chatglm"):
        assert _render(tchat, _GlmTok(), model_type, conv) == _render(
            jchat, _GlmTok(), model_type, conv)
        return
    got = []
    for mod in (tchat, jchat):
        tok = _Recorder()
        try:
            out = _render(mod, tok, model_type, conv)
        except ValueError as e:  # kimi: a tool call without its response
            out = str(e)
        got.append((out, tok.calls))
    assert got[0] == got[1]


def test_kimi_missing_tool_response_raises_alike():
    msgs = [{"role": "user", "content": "weather?"},
            {"role": "assistant", "tool_calls": [{"id": "get_weather:0", "type": "function",
                                                  "function": {"name": "get_weather",
                                                               "arguments": "{}"}}]}]
    for mod in (tchat, jchat):
        with pytest.raises(ValueError, match="missing tool responses"):
            mod.create_renderer(_Recorder(), "kimi_k2").render(msgs, tools=TOOLS)
