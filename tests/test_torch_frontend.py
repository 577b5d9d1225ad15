"""The port's frontend against the JAX package, on the CPU.

* Chat output parsing over HTTP (the C5 repair): a think + tool-call answer
  forced through a trie (its start token pinned by ``logit_bias``) on the
  tiny checkpoint, with a piece tokenizer whose pieces split the tags.
  Non-streamed and streamed, with and without ``tools``, ``n`` = 1 and 2 and
  the hidden-states choice: the message equals what the JAX ``parse_output``
  makes of the same text (tool call ids aside), the streamed deltas join to
  the same fields, no ``content`` delta holds a piece of a tag, and the
  JAX server answers ``n`` = 1 alike. The reference's raw ``n`` > 1 choices
  are pinned as its fault.
* The routes: ``POST /``, ``/tokenizer/encode``, ``/v1/models``,
  ``/status``, ``/cache_status`` (against the JAX manager's journal),
  ``/metrics``, ``/set_log_level``, ``/pause`` / ``/restart``, the profiler
  routes and ``/update_weights`` (tokens after the update equal the JAX
  engine's after its own, every weight tensor keeps its storage, a wrong
  shape answers 400); the reference's prefix cache surviving an update is
  pinned as its fault.
* The metrics registry, the access log, the KV manager's hash journal and
  the env + flag config surface against their JAX counterparts.
"""

import asyncio
import json
import logging
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rtp_llm_tpu.cache.kv_cache_manager import KVCacheManager as JKVManager
from rtp_llm_tpu.config.engine_config import CacheConfig as JCache
from rtp_llm_tpu.config.engine_config import EngineConfig as JEngineConfig
from rtp_llm_tpu.config.engine_config import SchedulerConfig as JSched
from rtp_llm_tpu.config.server_args import parse_engine_config as jparse_engine_config
from rtp_llm_tpu.engine import LlmEngine as JEngine
from rtp_llm_tpu.frontend.output_parsers import parse_output as jparse_output
from rtp_llm_tpu.loader import CheckpointLoader as JLoader
from rtp_llm_tpu.loader.fake_checkpoint import tiny_config, write_fake_checkpoint
from rtp_llm_tpu.models import create_model
from rtp_llm_tpu.utils.access_logger import AccessLogger as JAccessLogger
from rtp_llm_tpu.utils.metrics import MetricsRegistry as JMetricsRegistry
from rtp_llm_tpu_torch.cache.kv_cache_manager import KVCacheManager
from rtp_llm_tpu_torch.cli import config_from_args, parse_args
from rtp_llm_tpu_torch.config import CacheConfig, EngineConfig, QuantConfig, SchedulerConfig
from rtp_llm_tpu_torch.config.model_config import ModelConfig
from rtp_llm_tpu_torch.config.server_args import iter_fields, parse_engine_config
from rtp_llm_tpu_torch.engine import LlmEngine
from rtp_llm_tpu_torch.frontend import openai_api, output_parsers
from rtp_llm_tpu_torch.frontend.openai_api import build_app
from rtp_llm_tpu_torch.loader import CheckpointLoader
from rtp_llm_tpu_torch.models import LlamaFamilyModel
from rtp_llm_tpu_torch.utils.access_logger import AccessLogger
from rtp_llm_tpu_torch.utils.metrics import MetricsRegistry

BS, NB, BATCH, MSL = 4, 256, 4, 96
# the forced answer: a think block, then one hermes tool call, in pieces
# that split every tag
PIECES = {100: "<thi", 101: "nk>The user", 102: " wants the weather", 103: "</th",
          104: "ink><tool", 105: '_call>{"name": "get_', 106: 'weather", "arguments": ',
          107: '{"city": "Paris"}}</tool_', 108: "call>"}
FORCED = list(PIECES)
FORCED_TEXT = "".join(PIECES.values())
END = 99  # the trie's end token, kept out by a -100 bias
TAGS = ("<think>", "</think>", "<tool_call>", "</tool_call>")
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "look up weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]
CHAT = {"messages": [{"role": "user", "content": "w1 w2 w3"}], "max_tokens": len(FORCED),
        "temperature": 0, "ignore_eos": True,
        "logit_bias": {str(FORCED[0]): 100.0, str(END): -100.0}}
GREEDY = {"max_tokens": 6, "temperature": 0, "ignore_eos": True}


class PieceTokenizer:
    """Ids in ``PIECES`` decode to their text, the others to " w<id>";
    encode reads "w<id>" words and whole pieces. The chat template is the
    last message's text."""

    unk_token_id = None

    def encode(self, text, add_special_tokens=True):
        ids, rest = [], text
        by_text = {v: k for k, v in PIECES.items()}
        while rest.strip():
            rest = rest.lstrip()
            piece = next((p for p in sorted(by_text, key=len, reverse=True)
                          if rest.startswith(p)), None)
            if piece is not None:
                ids.append(by_text[piece])
                rest = rest[len(piece):]
                continue
            word, _, rest = rest.partition(" ")
            if word[:1] == "w" and word[1:].isdigit():
                ids.append(int(word[1:]))
        return ids

    def decode(self, ids, **kw):
        return "".join(PIECES.get(int(t), f" w{int(t)}") for t in ids)

    def convert_ids_to_tokens(self, ids):
        return [PIECES.get(int(t), f"w{int(t)}") for t in ids]

    def apply_chat_template(self, messages, add_generation_prompt=True, tokenize=True, **kw):
        return self.encode(messages[-1]["content"])

    def convert_tokens_to_ids(self, token):
        return None


def _trie_file(path):
    prefix = {"_".join(str(t) for t in FORCED[1: i + 1]): [FORCED[i + 1]]
              for i in range(len(FORCED) - 1)}
    with open(path, "w") as f:
        json.dump({"start_token_id": FORCED[0], "end_token_id": END, "sep": "_",
                   "prefix_dict": prefix}, f)
    return path


def _port_engine(ckpt, tree_path=""):
    cfg = ModelConfig.from_pretrained(ckpt)
    cfg.dtype = "float32"
    econf = EngineConfig(
        cache=CacheConfig(block_size=BS, num_blocks=NB),
        scheduler=SchedulerConfig(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64)),
        quant=QuantConfig(kv_cache_dtype="float32"), tree_decode_config_path=tree_path)
    return LlmEngine(LlamaFamilyModel(cfg, device="cpu"),
                     CheckpointLoader(cfg, device="cpu").load(ckpt), econf, device="cpu")


def _jax_engine(ckpt, tree_path=""):
    cfg = tiny_config("qwen2", dtype="float32")
    econf = JEngineConfig(
        cache=JCache(block_size=BS, test_num_blocks=NB),
        scheduler=JSched(max_batch_size=BATCH, max_seq_len=MSL, prefill_buckets=(16, 64)),
        tree_decode_config_path=tree_path)
    econf.quant.kv_cache_dtype = "float32"
    return JEngine(create_model(cfg), JLoader(cfg).load(ckpt), econf)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(post / get to the port, post to the JAX app, the port app, the JAX
    runner, the checkpoints) over one checkpoint, the piece tokenizer and
    the forcing trie."""
    from aiohttp.test_utils import TestClient, TestServer

    from rtp_llm_tpu.frontend.openai_api import OpenAIApp as JApp
    from rtp_llm_tpu.server.engine_runner import EngineRunner as JRunner

    root = tmp_path_factory.mktemp("frontend")
    ckpt = write_fake_checkpoint(str(root / "a"), tiny_config("qwen2"))
    ckpt_b = write_fake_checkpoint(str(root / "b"), tiny_config("qwen2"), seed=99)
    trie = _trie_file(str(root / "trie.json"))
    app = build_app(_port_engine(ckpt, trie), PieceTokenizer(), model_name="tiny")
    base = f"http://127.0.0.1:{app.start('127.0.0.1', 0)}"
    runner = JRunner(_jax_engine(ckpt, trie)).start()
    japp = JApp(runner, PieceTokenizer(), model_name="tiny", model_type="qwen2",
                enable_access_log=False)
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(japp.build_app()), loop=loop)
    loop.run_until_complete(client.start_server())

    def port(route, body=None, raw=False, headers=None):
        req = urllib.request.Request(
            base + route, data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                data = r.read()
                return r.status, (data if raw else json.loads(data))
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def jax(route, body=None, raw=False):
        async def go():
            r = await (client.post(route, json=body) if body is not None else client.get(route))
            return r.status, await (r.read() if raw else r.json())
        return loop.run_until_complete(go())

    yield dict(port=port, jax=jax, app=app, runner=runner, ckpt=ckpt, ckpt_b=ckpt_b,
               root=root)
    loop.run_until_complete(client.close())
    loop.close()
    runner.stop()
    app.stop()


def _sse(raw):
    events = [ln[len("data: "):] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _no_ids(calls):
    return [{k: v for k, v in c.items() if k not in ("id", "index")} for c in calls or []]


def _want_message():
    """The message the JAX ``parse_output`` makes of the forced text."""
    parsed = jparse_output(FORCED_TEXT)
    assert parsed.tool_calls and parsed.reasoning_content and not parsed.content
    return {"role": "assistant", "content": parsed.content or None,
            "reasoning_content": parsed.reasoning_content,
            "tool_calls": _no_ids(parsed.tool_calls)}


def _message(choice):
    m = dict(choice["message"])
    m["tool_calls"] = _no_ids(m.get("tool_calls"))
    return m


def _streamed(chunks, index=0):
    """(role, reasoning, content, tool calls, finish, content deltas) of one
    choice's chunks."""
    role, reasoning, content, calls, fin, deltas = None, "", "", [], None, []
    for c in chunks:
        ch = c["choices"][0]
        if ch["index"] != index:
            continue
        d = ch["delta"]
        role = role or d.get("role")
        reasoning += d.get("reasoning_content") or ""
        if d.get("content"):
            content += d["content"]
            deltas.append(d["content"])
        calls += d.get("tool_calls") or []
        fin = ch["finish_reason"] or fin
    return role, reasoning, content, calls, fin, deltas


@pytest.mark.parametrize("tools", [True, False], ids=["tools", "no-tools"])
def test_forced_think_and_tool_call_parse_as_the_reference(apps, tools):
    """C5: the port answers with ``reasoning_content``, ``tool_calls`` and
    ``finish_reason: "tool_calls"`` equal to the JAX ``parse_output`` of the
    same text and to the JAX server's own answer, with or without
    ``tools``."""
    body = {**CHAT, **({"tools": TOOLS} if tools else {})}
    status, out = apps["port"]("/v1/chat/completions", body)
    assert status == 200, out
    ch = out["choices"][0]
    assert ch["token_ids"] == FORCED
    assert _message(ch) == _want_message()
    assert ch["finish_reason"] == "tool_calls"
    assert json.loads(ch["message"]["tool_calls"][0]["function"]["arguments"]) == {"city": "Paris"}
    jstatus, jout = apps["jax"]("/v1/chat/completions", body)
    assert jstatus == 200
    assert _message(jout["choices"][0]) == _message(ch)
    assert jout["choices"][0]["finish_reason"] == "tool_calls"


def test_streamed_chat_joins_to_the_parsed_fields(apps):
    """The role chunk first, reasoning and no content deltas, one
    ``tool_calls`` delta and ``finish_reason: "tool_calls"``; the JAX
    stream joins to the same fields."""
    body = {**CHAT, "tools": TOOLS, "stream": True}
    want = _want_message()
    for post in (apps["port"], apps["jax"]):
        status, raw = post("/v1/chat/completions", body, raw=True)
        assert status == 200
        chunks = _sse(raw)
        assert chunks[0]["choices"][0]["delta"] == {"role": "assistant", "content": ""}
        role, reasoning, content, calls, fin, deltas = _streamed(chunks)
        assert (role, reasoning, content, fin) == ("assistant", want["reasoning_content"],
                                                  "", "tool_calls")
        assert deltas == [] and _no_ids(calls) == want["tool_calls"]


def test_port_stream_carries_every_token_once(apps):
    status, raw = apps["port"]("/v1/chat/completions", {**CHAT, "stream": True}, raw=True)
    chunks = _sse(raw)
    assert [t for c in chunks for t in c["choices"][0]["token_ids"]] == FORCED
    assert chunks[-1]["usage"]["completion_tokens"] == len(FORCED)


@pytest.mark.parametrize("fault", ["parser_bypassed", "zero_holdback"])
def test_planted_parser_faults_fail_the_checks(apps, fault, monkeypatch):
    """The checks above catch a bypassed parser (raw text in ``content``)
    and a holdback of zero (a piece of a tag in a ``content`` delta)."""
    app = apps["app"]
    if fault == "parser_bypassed":
        class Raw:
            def push(self, text):
                return "", text

            def finalize(self):
                return "", "", None
        monkeypatch.setattr(app, "parse", lambda text: output_parsers.ParsedOutput(content=text))
        monkeypatch.setattr(app, "stream_parser", Raw)
    else:
        monkeypatch.setattr(output_parsers.StreamingOutputParser, "_holdback",
                            lambda self, text: (text, ""))
    _, out = apps["port"]("/v1/chat/completions", CHAT)
    _, raw = apps["port"]("/v1/chat/completions", {**CHAT, "stream": True}, raw=True)
    _, reasoning, content, calls, fin, deltas = _streamed(_sse(raw))
    leaked = [d for d in deltas if any(t[:k] in d for t in TAGS for k in range(2, len(t) + 1))]
    if fault == "parser_bypassed":
        assert _message(out["choices"][0]) != _want_message() and leaked
    else:
        assert _message(out["choices"][0]) == _want_message()  # the full parse is untouched
        assert leaked and content != ""


def test_n2_and_hidden_choices_are_parsed_and_the_reference_leaves_them_raw(apps):
    """Every chat choice goes through the parser in the port. The JAX
    server parses only ``n`` = 1 (``openai_api.py:360-395``,
    ``:103-183``, ``:327-358``): its ``n`` = 2 choices, streamed and not,
    and its hidden-states choice carry the raw text, tags included."""
    want = _want_message()
    body = {**CHAT, "n": 2}
    _, out = apps["port"]("/v1/chat/completions", body)
    assert [c["index"] for c in out["choices"]] == [0, 1]
    assert all(_message(c) == want and c["finish_reason"] == "tool_calls" for c in out["choices"])
    _, jout = apps["jax"]("/v1/chat/completions", body)
    assert [c["message"]["content"] for c in jout["choices"]] == [FORCED_TEXT] * 2
    assert all("tool_calls" not in c["message"] for c in jout["choices"])

    _, raw = apps["port"]("/v1/chat/completions", {**body, "stream": True}, raw=True)
    chunks = _sse(raw)
    for i in (0, 1):
        _, reasoning, content, calls, fin, _ = _streamed(chunks, i)
        assert (reasoning, content, fin) == (want["reasoning_content"], "", "tool_calls")
        assert _no_ids(calls) == want["tool_calls"]
    _, raw = apps["jax"]("/v1/chat/completions", {**body, "stream": True}, raw=True)
    assert all(_streamed(_sse(raw), i)[2] == FORCED_TEXT for i in (0, 1))

    # the teacher-forced loop takes the raw argmax (no bias, no trie): its
    # words decode with a leading space, which only the parser strips
    hid = {**CHAT, "return_hidden_states": True}
    _, out = apps["port"]("/v1/chat/completions", hid)
    text = PieceTokenizer().decode(out["choices"][0]["token_ids"])
    assert text.startswith(" ") and len(out["choices"][0]["hidden_states"]) == 9
    assert out["choices"][0]["message"]["content"] == jparse_output(text).content
    _, jout = apps["jax"]("/v1/chat/completions", hid)
    assert jout["choices"][0]["message"]["content"] == text


def test_chat_with_tools_and_unforced_text_is_plain_content(apps):
    """A chat with ``tools`` whose answer calls nothing: 200, its text in
    ``content``, no ``tool_calls``, the JAX server's content."""
    body = {"messages": [{"role": "user", "content": "w7 w8"}], "tools": TOOLS, **GREEDY}
    status, out = apps["port"]("/v1/chat/completions", body)
    assert status == 200
    msg = out["choices"][0]["message"]
    assert "tool_calls" not in msg and out["choices"][0]["finish_reason"] == "length"
    assert msg["content"] == apps["jax"]("/v1/chat/completions", body)[1]["choices"][0][
        "message"]["content"]


# ---- routes ----

def test_post_root_is_completions(apps):
    body = {"prompt": [5, 9, 42, 7], **GREEDY}
    s1, a = apps["port"]("/", body)
    s2, b = apps["port"]("/v1/completions", body)
    assert s1 == s2 == 200 and a["choices"][0]["token_ids"] == b["choices"][0]["token_ids"]
    assert a["choices"][0]["text"] == apps["jax"]("/", body)[1]["choices"][0]["text"]


def test_chat_completions_alias(apps):
    body = {"messages": [{"role": "user", "content": "w5 w6"}], **GREEDY}
    s1, a = apps["port"]("/chat/completions", body)
    s2, b = apps["port"]("/v1/chat/completions", body)
    assert s1 == s2 == 200 and a["choices"][0]["token_ids"] == b["choices"][0]["token_ids"]
    assert a["choices"][0]["message"] == apps["jax"]("/chat/completions", body)[1][
        "choices"][0]["message"]


def test_tokenizer_encode_models_and_status(apps):
    body = {"prompt": "w3 w4 <think>"}
    assert apps["port"]("/tokenizer/encode", body) == apps["jax"]("/tokenizer/encode", body)
    status, models = apps["port"]("/v1/models")
    _, jmodels = apps["jax"]("/v1/models")
    assert status == 200 and models["data"][0]["id"] == jmodels["data"][0]["id"] == "tiny"
    assert set(models["data"][0]) == set(jmodels["data"][0])
    assert apps["port"]("/status") == apps["jax"]("/status") == (200, {"status": "ok"})


def test_set_log_level(apps):
    root = logging.getLogger()
    level = root.level
    try:
        assert apps["port"]("/set_log_level", {"level": "warning"}) == (
            200, {"status": "ok", "level": "WARNING"})
        assert root.level == logging.WARNING
    finally:
        root.setLevel(level)


def test_cache_status_versions(apps):
    """The version advances when a request's blocks enter the prefix cache,
    and ``from_version`` lists the added hashes (those a JAX manager
    journals for the same tokens)."""
    port = apps["port"]
    status, before = port("/cache_status")
    assert status == 200 and set(before) >= {"version", "block_size", "total_blocks",
                                             "free_blocks", "prefix_cache_entries"}
    prompt = [11, 12, 13, 14, 15, 16, 17, 18, 19]
    _, out = port("/v1/completions", {"prompt": prompt, **GREEDY})
    time.sleep(0.05)
    _, after = port("/cache_status")
    assert after["version"] > before["version"]
    _, diff = port(f"/cache_status?from_version={before['version']}")
    seq = prompt + out["choices"][0]["token_ids"]
    ref = JKVManager(16, BS, backend="python")
    ref.free(ref.allocate(seq), seq[:-1])  # the stream's KV covers all but its last token
    assert diff["added"] == ref.cache_hash_diff(0)["added"] and diff["removed"] == []
    assert port("/cache_status?from_version=x")[0] == 400


def test_metrics_count_served_tokens_and_requests(apps):
    """``engine.tokens_generated`` grows by the decode tokens served,
    ``frontend.requests`` and the TTFT count by the requests; Prometheus
    text by default, JSON on ``?format=json`` or ``Accept``."""
    port, app = apps["port"], apps["app"]

    def snap():
        with app.runner.engine.device_lock:  # the step that served a request has ended
            return port("/metrics?format=json")[1]

    s0 = snap()
    outs = [port("/v1/completions", {"prompt": [3, 4, 5 + i], **GREEDY})[1] for i in range(3)]
    s1 = snap()
    served = sum(len(o["choices"][0]["token_ids"]) - 1 for o in outs)  # first tokens: prefill
    c0, c1 = s0["counters"], s1["counters"]
    assert c1["engine.tokens_generated"] - c0.get("engine.tokens_generated", 0) == served
    assert c1["frontend.requests"] - c0.get("frontend.requests", 0) == 3
    h0 = s0["histograms"].get("frontend.ttft_ms", {"count": 0})["count"]
    assert s1["histograms"]["frontend.ttft_ms"]["count"] - h0 == 3
    assert s1["gauges"]["engine.kv_free_blocks"] > 0
    status, text = port("/metrics", raw=True)
    assert status == 200 and b"rtp_engine_tokens_generated_total" in text
    assert b"# TYPE rtp_frontend_ttft_ms summary" in text
    assert port("/metrics", headers={"Accept": "application/json"})[1]["counters"]


def test_pause_holds_a_request_until_restart(apps):
    port, app = apps["port"], apps["app"]
    eng = app.runner.engine
    assert port("/pause", {}) == (200, {"status": "paused"})
    got = {}
    try:
        steps = eng.step_count
        import threading

        t = threading.Thread(target=lambda: got.update(
            out=port("/v1/completions", {"prompt": [21, 22, 23], **GREEDY})))
        t.start()
        time.sleep(0.5)
        assert eng.step_count == steps and "out" not in got
    finally:
        assert port("/restart", {}) == (200, {"status": "running"})
    t.join(60)
    assert got["out"][0] == 200 and len(got["out"][1]["choices"][0]["token_ids"]) == 6


def test_profile_routes_write_a_chrome_trace(apps):
    port = apps["port"]
    trace_dir = str(apps["root"] / "trace")
    assert port("/stop_profile", {})[0] == 409
    assert port("/start_profile", {"dir": trace_dir}) == (
        200, {"status": "started", "dir": trace_dir})
    assert port("/start_profile", {"dir": trace_dir})[0] == 409
    port("/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 2, "temperature": 0})
    status, out = port("/stop_profile", {})
    assert status == 200 and os.path.dirname(out["trace"]) == trace_dir
    with open(out["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_update_weights_copies_into_the_live_tensors(apps):
    """After ``/update_weights`` the port's greedy tokens equal the JAX
    engine's after its own update to the same checkpoint (a prompt not seen
    before); every weight tensor keeps its storage. A checkpoint of another
    shape answers 400 and the engine serves on. Last: back to the first
    checkpoint."""
    port, app, runner = apps["port"], apps["app"], apps["runner"]
    eng = app.runner.engine
    ptrs = {k: t.data_ptr() for k, t in eng.weights.items() if isinstance(t, torch.Tensor)}
    prompt = {"prompt": [31, 32, 33, 34, 35, 36], **GREEDY}
    _, before = port("/v1/completions", prompt)
    try:
        assert port("/update_weights", {"model_path": apps["ckpt_b"]}) == (
            200, {"status": "updated", "model_path": apps["ckpt_b"]})
        runner.update_weights(apps["ckpt_b"])
        body = {"prompt": [41, 42, 43, 44, 45, 46, 47], **GREEDY}
        _, got = port("/v1/completions", body)
        _, want = apps["jax"]("/v1/completions", body)
        assert got["choices"][0]["text"] == want["choices"][0]["text"]
        fresh = _port_engine(apps["ckpt_b"]).generate(
            body["prompt"], openai_api.GenerateConfig(max_new_tokens=6, do_sample=False,
                                                      ignore_eos=True))
        assert got["choices"][0]["token_ids"] == fresh.output_token_ids
        assert {k: t.data_ptr() for k, t in eng.weights.items()
                if isinstance(t, torch.Tensor)} == ptrs

        small = write_fake_checkpoint(str(apps["root"] / "small"),
                                      tiny_config("qwen2", intermediate_size=64))
        status, err = port("/update_weights", {"model_path": small})
        assert status == 400 and "does not match" in err["error"]["message"]
        assert port("/update_weights", {})[0] == 400
        assert port("/v1/completions", body)[1]["choices"][0]["token_ids"] == (
            got["choices"][0]["token_ids"])
    finally:
        assert port("/update_weights", {"model_path": apps["ckpt"]})[0] == 200
        runner.update_weights(apps["ckpt"])
    assert port("/v1/completions", prompt)[1]["choices"][0]["token_ids"] == (
        before["choices"][0]["token_ids"])


def test_reference_update_keeps_stale_prefix_blocks(tmp_path):
    """A fault of the reference: its ``update_weights``
    (``server/engine_runner.py:84-117``) keeps the prefix cache, so a prompt
    served before the update reuses KV rows of the old weights. The port
    invalidates the cache (``KVCacheManager.invalidate_prefix_cache``): its
    answer equals a fresh engine's on the new weights."""
    from rtp_llm_tpu.config.generate_config import GenerateConfig as JGen
    from rtp_llm_tpu.server.engine_runner import EngineRunner as JRunner
    from rtp_llm_tpu_torch.config import GenerateConfig
    from rtp_llm_tpu_torch.server.engine_runner import EngineRunner

    a = write_fake_checkpoint(str(tmp_path / "a"), tiny_config("qwen2"))
    b = write_fake_checkpoint(str(tmp_path / "b"), tiny_config("qwen2"), seed=99)
    prompt = list(range(50, 63))  # 3 full blocks to reuse
    kw = dict(max_new_tokens=4, do_sample=False, ignore_eos=True, return_logprobs=True)
    results = {}
    for name, make, gen_cls, runner_cls in (("jax", _jax_engine, JGen, JRunner),
                                            ("port", _port_engine, GenerateConfig, EngineRunner)):
        eng = make(a)
        eng.generate(prompt, gen_cls(**kw))
        runner_cls(eng).update_weights(b)
        after = eng.generate(prompt, gen_cls(**kw))
        fresh = make(b).generate(prompt, gen_cls(**kw))
        results[name] = (after.reuse_len, np.abs(np.subtract(after.output_logprobs,
                                                             fresh.output_logprobs)).max())
    assert results["jax"][0] == 12 and results["jax"][1] > 1e-3
    assert results["port"][0] == 0 and results["port"][1] < 1e-4


# ---- metrics, access log, cache journal, config ----

def test_metrics_registry_matches_the_reference():
    ours, ref = MetricsRegistry(), JMetricsRegistry()
    for reg in (ours, ref):
        r = np.random.default_rng(0)
        for i in range(50):
            reg.inc("engine.tokens_generated", int(r.integers(1, 9)))
            reg.set_gauge("engine.kv_free_blocks", float(r.integers(0, 100)))
            reg.observe("frontend.ttft_ms", float(r.uniform(1, 50)))
        reg.inc("scheduler.sla_rejections")
    a, b = ours.snapshot(), ref.snapshot()
    a.pop("uptime_s"), b.pop("uptime_s")
    assert a == b

    def body(text):
        return [ln for ln in text.splitlines() if "uptime" not in ln]
    assert body(ours.prometheus_text()) == body(ref.prometheus_text())


def test_access_log_lines_match_the_reference(tmp_path):
    logs = {}
    for name, cls in (("port", AccessLogger), ("jax", JAccessLogger)):
        path = str(tmp_path / f"{name}.log")
        log = cls(path, logger_name=f"test_access_{name}")
        log.log_query("r1", "/v1/completions", {"prompt_tokens": 3, "stream": False})
        log.log_success("r1", "/v1/completions", 12.345, 3, 6, first_token_ms=4.567)
        log.log_exception("r2", "/v1/chat/completions", "boom")
        for _ in range(100):
            if os.path.exists(path) and len(open(path).read().splitlines()) == 3:
                break
            time.sleep(0.02)
        logs[name] = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                      for ln in open(path).read().splitlines()]
    assert logs["port"] == logs["jax"] and [r["type"] for r in logs["port"]] == [
        "query", "success", "exception"]


def test_kv_journal_matches_the_reference():
    """The same allocations and frees (inserts, then evictions under pool
    pressure) through the port's manager and the JAX python one: the same
    versions and the same diff from every version."""
    ours, ref = KVCacheManager(10, BS), JKVManager(10, BS, backend="python")
    rng = np.random.default_rng(3)
    for step in range(12):
        toks = [int(t) for t in rng.integers(0, 50, int(rng.integers(5, 14)))]
        for mgr in (ours, ref):
            alloc = mgr.allocate(toks)
            assert alloc is not None
            mgr.free(alloc, toks)
        assert ours.hash_version == ref.hash_version
    for v in range(ours.hash_version + 1):
        assert ours.cache_hash_diff(v) == ref.cache_hash_diff(v)
    assert ours.hash_version > 5 and ours.cache_hash_diff(0)["removed"]
    v, cached = ours.hash_version, len(ours.prefix_cache)
    ours.invalidate_prefix_cache()
    assert len(ours.prefix_cache) == 0 and len(ours.cache_hash_diff(v)["removed"]) == cached


def test_invalidated_allocations_are_not_cached():
    mgr = KVCacheManager(16, BS)
    toks = list(range(1, 10))
    old = mgr.allocate(toks)
    mgr.invalidate_prefix_cache()
    mgr.free(old, toks)
    assert len(mgr.prefix_cache) == 0 and mgr.pool.free_blocks == 15
    new = mgr.allocate(toks)
    mgr.free(new, toks)
    assert len(mgr.prefix_cache) == 2


CONFIG_CASES = {
    "defaults": ([], {}),
    "flags": (["--scheduler-max-batch-size", "8", "--cache-block-size", "16",
               "--quant-method", "int4", "--scheduler-prefill-buckets", "16,64",
               "--cache-enable-prefix-cache", "false", "--seed", "7",
               "--speculative-method", "prompt_lookup"], {}),
    "env": ([], {"RTP_SCHEDULER_DECODE_STEPS": "4", "RTP_QUANT_KV_CACHE_DTYPE": "int8",
                 "RTP_SCHEDULER_ASYNC_DECODE": "0", "RTP_CACHE_MEMORY_UTILIZATION": "0.5"}),
    "flag-beats-env": (["--scheduler-max-seq-len", "4096"],
                       {"RTP_SCHEDULER_MAX_SEQ_LEN": "2048", "RTP_TREE_DECODE_CONFIG_PATH": "/t"}),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_server_args_match_the_reference(case, monkeypatch):
    """The port's ``--<group>-<field>`` / ``RTP_<GROUP>_<FIELD>`` surface
    gives the JAX ``parse_engine_config``'s values on every field both
    configs have; ``serve`` reads it too, its own flags as aliases."""
    argv, env = CONFIG_CASES[case]
    for k in [k for k in os.environ if k.startswith("RTP_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, ref = parse_engine_config(argv), jparse_engine_config(argv)
    served = config_from_args(parse_args(["serve", "/ckpt", *argv]))
    shared = 0
    for group, obj, f in iter_fields(ours):
        jobj = getattr(ref, group) if group else ref
        if hasattr(jobj, f.name):
            shared += 1
            assert getattr(obj, f.name) == getattr(jobj, f.name), (group, f.name)
            sobj = getattr(served, group) if group else served
            assert getattr(sobj, f.name) == getattr(obj, f.name), (group, f.name)
    assert shared >= 25


def test_serve_aliases_beat_the_env(monkeypatch):
    monkeypatch.setenv("RTP_SCHEDULER_MAX_BATCH_SIZE", "7")
    monkeypatch.setenv("RTP_CACHE_ENABLE_PREFIX_CACHE", "1")
    conf = config_from_args(parse_args(["serve", "/m"]))
    assert conf.scheduler.max_batch_size == 7 and conf.cache.enable_prefix_cache
    conf = config_from_args(parse_args(["serve", "/m", "--max-batch-size", "3",
                                        "--no-prefix-cache"]))
    assert conf.scheduler.max_batch_size == 3 and not conf.cache.enable_prefix_cache
    monkeypatch.setenv("RTP_SPECULATIVE_METHOD", "mtp")
    with pytest.raises(NotImplementedError):
        config_from_args(parse_args(["serve", "/m"]))
