"""In-process HTTP round trips against the port's standard-library server on
the CPU: /health, /worker_status, /v1/completions with token ids (plain and
SSE, with prefix reuse), /v1/chat/completions with a tiny tokenizer, the
400s a server without a tokenizer gives for text, the 400 for the
reference's request control that the port does not honour yet, and 200
with its effect for each control the port serves (beam search and a LoRA
adapter among them)."""

import json
import urllib.error
import urllib.request

import pytest

from rtp_llm_tpu.config.generate_config import GenerateConfig as JaxGenerateConfig
from rtp_llm_tpu.loader.fake_checkpoint import (
    tiny_config, write_fake_checkpoint, write_fake_tokenizer,
)
from rtp_llm_tpu_torch.config import GenerateConfig
from rtp_llm_tpu_torch.config import CacheConfig, EngineConfig, QuantConfig, SchedulerConfig
from rtp_llm_tpu_torch.config.model_config import ModelConfig
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.frontend.openai_api import build_app
from rtp_llm_tpu_torch.frontend.tokenizer_factory import TokenizerFactory
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel

import torch

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each


def _engine(ckpt):
    cfg = ModelConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    econf = EngineConfig(
        cache=CacheConfig(block_size=4, num_blocks=128),
        scheduler=SchedulerConfig(max_batch_size=4, max_seq_len=256,
                                  prefill_buckets=(16, 64)),
        quant=QuantConfig(kv_cache_dtype="float32"))
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"),
                     CheckpointLoader(cfg, device="cpu").load(ckpt), econf, device="cpu")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_fake_checkpoint(str(tmp_path_factory.mktemp("srv")), tiny_config("qwen2"))


@pytest.fixture(scope="module")
def served(ckpt, tmp_path_factory):
    tok = TokenizerFactory.create(write_fake_tokenizer(str(tmp_path_factory.mktemp("tok"))))
    app = build_app(_engine(ckpt), tok)
    port = app.start("127.0.0.1", 0)
    yield f"http://127.0.0.1:{port}", app
    app.stop()


@pytest.fixture(scope="module")
def served_no_tok(ckpt):
    app = build_app(_engine(ckpt), None)
    port = app.start("127.0.0.1", 0)
    yield f"http://127.0.0.1:{port}"
    app.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body, raw=False):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            data = r.read()
            return r.status, (data if raw else json.loads(data))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


GREEDY = {"max_tokens": 8, "temperature": 0, "ignore_eos": True}


def test_health_and_worker_status(served):
    base, _ = served
    assert _get(base + "/health") == (200, {"status": "ok"})
    status, ws = _get(base + "/worker_status")
    assert status == 200 and ws["alive"] and ws["kv_total_blocks"] == 128


def test_completions_token_ids_match_engine(served, ckpt):
    base, _ = served
    prompt = [5, 9, 42, 7, 11, 3]
    status, out = _post(base + "/v1/completions", {"prompt": prompt, **GREEDY})
    assert status == 200
    choice = out["choices"][0]
    assert choice["finish_reason"] == "length"
    assert out["usage"]["completion_tokens"] == 8
    assert out["usage"]["prompt_tokens"] == len(prompt)
    want = _engine(ckpt).generate(prompt, GenerateConfig(
        max_new_tokens=8, do_sample=False, ignore_eos=True)).output_token_ids
    assert choice["token_ids"] == want
    assert isinstance(choice["text"], str)


def test_prefix_reuse_over_http(served):
    base, _ = served
    shared = list(range(1, 41))
    _post(base + "/v1/completions", {"prompt": shared + [50, 51], **GREEDY})
    status, out = _post(base + "/v1/completions", {"prompt": shared + [60, 61, 62], **GREEDY})
    assert status == 200
    assert out["usage"]["prompt_tokens_details"]["cached_tokens"] > 0


def test_sse_stream_matches_plain(served):
    base, _ = served
    body = {"prompt": [7, 7, 1, 2], **GREEDY}
    _, plain = _post(base + "/v1/completions", body)
    status, raw = _post(base + "/v1/completions", {**body, "stream": True}, raw=True)
    assert status == 200
    events = [ln[len("data: "):] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    toks = [t for c in chunks for t in c["choices"][0]["token_ids"]]
    assert toks == plain["choices"][0]["token_ids"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert chunks[-1]["usage"]["completion_tokens"] == 8


def test_chat_completions_with_tokenizer(served):
    base, _ = served
    status, out = _post(base + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "w1 w2 w3"}], **GREEDY})
    assert status == 200
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    assert out["usage"]["completion_tokens"] >= 1
    status, out = _post(base + "/v1/completions", {"prompt": "w4 w5", **GREEDY})
    assert status == 200 and out["usage"]["prompt_tokens"] == 2


def test_without_tokenizer_text_routes_answer_400(served_no_tok):
    base = served_no_tok
    assert _post(base + "/v1/completions", {"prompt": "hello", **GREEDY})[0] == 400
    assert _post(base + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}]})[0] == 400
    status, out = _post(base + "/v1/completions", {"prompt": [1, 2, 3], **GREEDY})
    assert status == 200 and len(out["choices"][0]["token_ids"]) == 8
    assert out["choices"][0]["text"] == ""


def test_bad_requests(served):
    base, _ = served
    assert _post(base + "/v1/completions", {"max_tokens": 3})[0] == 400
    assert _post(base + "/v1/completions", {"prompt": [1], "top_p": 0})[0] == 400
    assert _post(base + "/v1/nope", {})[0] == 404
    too_long = {"prompt": list(range(1, 300)), "max_tokens": 1}
    assert _post(base + "/v1/completions", too_long)[0] == 400


# a value of each reference control the port refuses, one that the reference
# would act on
NOT_PORTED = {"gen_timeline": 2}


@pytest.mark.parametrize("field", sorted(NOT_PORTED))
def test_unported_control_answers_400(served, field):
    """The JAX GenerateConfig keeps the control; the port's refuses it, and
    a request that sets it is answered 400 instead of 200 without it."""
    value = NOT_PORTED[field]
    assert getattr(JaxGenerateConfig.from_dict({field: value}), field) == value
    with pytest.raises(ValueError, match=f"{field} is not ported yet"):
        GenerateConfig.from_dict({field: value})
    with pytest.raises(ValueError, match=f"{field} is not ported yet"):
        GenerateConfig.from_dict({"extra_configs": {field: value}})
    base, _ = served
    status, out = _post(base + "/v1/completions", {"prompt": [1, 2, 3], field: value, **GREEDY})
    assert status == 400 and "not ported yet" in json.dumps(out)


# the controls that answered 400 until beam search and LoRA were ported, each
# with a value that changes the answer
BEAM_AND_LORA = {"num_beams": 3, "variable_num_beams": [1, 2, 3], "adapter_name": "lora-a"}


@pytest.fixture(scope="module")
def lora_path(tmp_path_factory):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_lora import write_fake_adapter

    return write_fake_adapter(str(tmp_path_factory.mktemp("srv_lora") / "a"), seed=1)


@pytest.mark.parametrize("route", ["/v1/completions", "/v1/chat/completions"])
@pytest.mark.parametrize("field", sorted(BEAM_AND_LORA))
def test_beam_and_lora_controls_answer_200_with_their_effect(served, ckpt, lora_path, field,
                                                             route):
    """``num_beams``, ``variable_num_beams`` and ``adapter_name`` (an adapter
    added through ``/v1/loras``) answer 200 on both routes with the tokens
    the engine gives the same prompt under that control."""
    from rtp_llm_tpu_torch.lora import LoraManager

    base, app = served
    value = BEAM_AND_LORA[field]
    if field == "adapter_name":
        _post(base + "/v1/loras", {"name": value, "path": lora_path})
    body = ({"prompt": [5, 9, 42, 7]} if route == "/v1/completions"
            else {"messages": [{"role": "user", "content": "w1 w2 w3"}]})
    status, out = _post(base + route, {**body, field: value, **GREEDY})
    assert status == 200
    ids = (body["prompt"] if route == "/v1/completions" else app.chat_ids(body)[0])
    engine = _engine(ckpt)
    if field == "adapter_name":
        mgr = LoraManager(engine.model.cfg.num_layers)
        mgr.add_adapter(lora_path, name=value)
        engine.set_lora_manager(mgr)
    cfg = dict(max_new_tokens=8, do_sample=False, ignore_eos=True)
    want = engine.generate(ids, GenerateConfig(**cfg, **{field: value}))
    plain = engine.generate(ids, GenerateConfig(**cfg))
    assert out["choices"][0]["token_ids"] == want.output_token_ids
    if field == "adapter_name":
        assert want.output_token_ids != plain.output_token_ids
    else:
        assert want.beam_hypotheses is not None


def _repeats(ids, n):
    grams = [tuple(ids[i: i + n]) for i in range(len(ids) - n + 1)]
    return len(grams) != len(set(grams))


def _bias_effect(out, _):
    return all(t == 5 for t in out["choices"][0]["token_ids"])


def _ngram_effect(out, plain):
    # greedy [1, 2, 3] repeats 32 without the bans
    return (_repeats([1, 2, 3] + plain["choices"][0]["token_ids"], 2)
            and not _repeats([1, 2, 3] + out["choices"][0]["token_ids"], 2))


def _think_effect(out, plain):
    # thinking opens at the first token; the end token is forced after the
    # budget, a few positions later (the async window lags one)
    got, want = out["choices"][0]["token_ids"], plain["choices"][0]["token_ids"]
    return 100 not in want and 100 in got[2:8] and got[0] == want[0]


def _top_logprobs_effect(out, _):
    content = out["choices"][0]["logprobs"]["content"]
    return len(content) == 8 and all(e["top_logprobs"] == [] and isinstance(e["logprob"], float)
                                     for e in content)


def _hidden_effect(out, plain):
    ch = out["choices"][0]
    hid = ch["hidden_states"]
    return (ch["token_ids"] == plain["choices"][0]["token_ids"] and len(hid) == 8
            and all(len(h) == 64 for h in hid))


def _loss_effect(out, plain):
    return (isinstance(out["loss"], list) and len(out["loss"]) == 2
            and out["choices"][0]["token_ids"] == plain["choices"][0]["token_ids"])


def _n_effect(out, _):
    return [c["index"] for c in out["choices"]] == [0, 1, 2] and all(
        len(c["token_ids"]) == 8 for c in out["choices"])


# (request fields, route, effect(response, the same request without them))
PORTED = {
    "logit_bias": ({"logit_bias": {"5": 100.0}}, "/v1/completions", _bias_effect),
    "no_repeat_ngram_size": ({"no_repeat_ngram_size": 2}, "/v1/completions", _ngram_effect),
    "max_thinking_tokens": ({"max_thinking_tokens": 2, "think_start_token_id": 116,
                             "think_end_token_id": 100}, "/v1/completions", _think_effect),
    "top_logprobs": ({"top_logprobs": 2, "logprobs": True}, "/v1/chat/completions",
                     _top_logprobs_effect),
    "return_hidden_states": ({"return_hidden_states": True}, "/v1/completions", _hidden_effect),
    "calculate_loss": ({"calculate_loss": 2}, "/v1/completions", _loss_effect),
    "n": ({"n": 3, "temperature": 0.9}, "/v1/completions", _n_effect),
}


@pytest.mark.parametrize("field", sorted(PORTED))
def test_ported_control_answers_200_with_effect(served, field):
    """The JAX GenerateConfig and the port's take the control alike, the
    server answers 200, and the answer shows the control's effect beside the
    same request without it."""
    fields, route, effect = PORTED[field]
    jax_cfg, cfg = JaxGenerateConfig.from_dict(fields), GenerateConfig.from_dict(fields)
    name = "num_return_sequences" if field == "n" else field
    assert getattr(cfg, name) == getattr(jax_cfg, name) == fields[field]
    for other in fields:
        if other != field and hasattr(jax_cfg, other):
            assert getattr(cfg, other) == getattr(jax_cfg, other)
    base, _ = served
    prompt = ({"messages": [{"role": "user", "content": "w1 w2"}]} if "chat" in route
              else {"prompt": [1, 2, 3]})
    status, plain = _post(base + route, {**prompt, **GREEDY})
    status, out = _post(base + route, {**prompt, **GREEDY, **fields})
    assert status == 200, out
    assert effect(out, plain), (out, plain)


# requests naming a token id outside the tiny vocabulary (128), or a
# control value the engine's loop could not read
BAD_REQUESTS = {
    "prompt-id": {"prompt": [1, 2, 128]},
    "logit_bias-key": {"logit_bias": {"128": 5.0}},
    "logit_bias-not-an-id": {"logit_bias": {"abc": 5.0}},
    "think_end_token_id": {"max_thinking_tokens": 1, "think_start_token_id": 5,
                           "think_end_token_id": 1000},
    "hidden-prompt-id": {"prompt": [1, 2, 500], "return_hidden_states": True},
    "loss-prompt-id": {"prompt": [1, 2, 500], "calculate_loss": 1},
    "streamed-logit_bias-key": {"logit_bias": {"9999": 1.0}, "stream": True},
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_token_ids_answer_400_and_the_server_serves_on(served, case):
    """Answered 400 at the request, before any step runs it; the next
    request is served as before (a bad id on the card would have failed the
    device and every stream with it)."""
    base, _ = served
    body = {"prompt": [1, 2, 3], **GREEDY}
    status, before = _post(base + "/v1/completions", body)
    assert status == 200
    status, out = _post(base + "/v1/completions", {**body, **BAD_REQUESTS[case]})
    assert status == 400, out
    status, after = _post(base + "/v1/completions", body)
    assert status == 200 and after["choices"][0]["token_ids"] == before["choices"][0]["token_ids"]
    assert _get(base + "/health") == (200, {"status": "ok"})


def test_chat_with_tools_answers_400(served, tmp_path):
    """Named for the 400 a chat with ``tools`` got before tool-call parsing
    was ported. Such a chat now answers 200; with its answer forced to a
    think block and a tool call (the trie and piece tokenizer of
    ``test_torch_frontend.py``) the call comes back in ``tool_calls``."""
    from test_torch_frontend import CHAT, TOOLS, PieceTokenizer, _message, _trie_file, _want_message

    from rtp_llm_tpu_torch.engine.logits_processors import TreeDecodeConfig
    from rtp_llm_tpu_torch.frontend.chat_renderer import create_renderer

    base, app = served
    for tools in (TOOLS, []):
        status, out = _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "w1 w2"}], "tools": tools, **GREEDY})
        assert status == 200 and "tool_calls" not in out["choices"][0]["message"]
    eng, tok, renderer = app.runner.engine, app.tok, app.renderer
    with eng.device_lock:
        eng.tree_config = TreeDecodeConfig.from_file(_trie_file(str(tmp_path / "trie.json")))
    app.tok = PieceTokenizer()
    app.renderer = create_renderer(app.tok, "qwen2")
    try:
        status, out = _post(base + "/v1/chat/completions", {**CHAT, "tools": TOOLS})
    finally:
        with eng.device_lock:
            eng.tree_config = None
        app.tok, app.renderer = tok, renderer
    assert status == 200 and out["choices"][0]["finish_reason"] == "tool_calls"
    assert _message(out["choices"][0]) == _want_message()


def test_openai_extras_and_defaults_still_answer_200(served):
    """OpenAI extras the port ignores, the reference fields it accepts, and
    the controls at their defaults."""
    base, _ = served
    body = {"prompt": [1, 2, 3], "user": "u1", "seed": 7, "think_start_token_id": 5,
            "think_end_token_id": 6, "timeline_dir": "", "num_beams": 1, "top_logprobs": 0,
            "logit_bias": None, "gen_timeline": 0, **GREEDY}
    status, out = _post(base + "/v1/completions", body)
    assert status == 200 and len(out["choices"][0]["token_ids"]) == 8
