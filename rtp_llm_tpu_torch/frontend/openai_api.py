"""OpenAI-compatible HTTP API on the standard library.

Port of ``rtp_llm_tpu/frontend/openai_api.py`` built on
``http.server.ThreadingHTTPServer`` (one thread per connection, no aiohttp):
  POST /v1/completions, /            token-id prompts, or text with a tokenizer
  POST /v1/chat/completions, /chat/completions   (needs a tokenizer)
  POST /tokenizer/encode, /set_log_level, /start_profile, /stop_profile,
       /pause, /restart, /update_weights
  GET  /health, /status, /worker_status, /v1/models, /cache_status, /metrics
  GET / POST / DELETE /v1/loras      the dynamic LoRA adapters
``"stream": true`` answers with server-sent events. Without a tokenizer the
text routes answer 400 and token-id prompts are still served; every choice
also carries the generated ``token_ids``, and ``usage`` reports the reused
prefix as ``prompt_tokens_details.cached_tokens``. As the reference does, ``n``
> 1 fans out into independent streams (choices interleaved by index when
streamed), a non-streamed response carries the prompt's ``loss`` with
``calculate_loss`` and a choice's ``hidden_states`` with
``return_hidden_states``, and ``top_logprobs`` returns empty lists beside the
logprobs. A beam request (``num_beams`` > 1) answers with its best
hypothesis, which arrives as one chunk at its end.

Every chat choice goes through the output parser with the model family's
tool detector (``output_parsers.py``, ``tool_detectors.py``): ``<think>``
text moves to ``reasoning_content`` and tool-call blocks to ``tool_calls``
with ``finish_reason: "tool_calls"``. A streamed chat opens with the role
chunk, and the streaming parser holds back any tail that could grow into a
tag, so no ``content`` delta holds one. (The reference parses only ``n`` = 1
and leaves ``n`` > 1 and the hidden-states choice raw.) The profiler routes
write a ``torch.profiler`` Chrome trace (CPU and, on the card, CUDA
activity) into the request's ``dir``.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import tempfile
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from rtp_llm_tpu_torch.config.generate_config import GenerateConfig
from rtp_llm_tpu_torch.engine.stream import FinishReason
from rtp_llm_tpu_torch.frontend.chat_renderer import create_renderer
from rtp_llm_tpu_torch.frontend.output_parsers import (
    ParsedOutput, StreamingOutputParser, parse_output,
)
from rtp_llm_tpu_torch.frontend.token_processor import IncrementalDetokenizer
from rtp_llm_tpu_torch.frontend.tool_detectors import get_tool_detector
from rtp_llm_tpu_torch.lora import LoraManager
from rtp_llm_tpu_torch.server.engine_runner import EngineRunner
from rtp_llm_tpu_torch.utils.access_logger import AccessLogger
from rtp_llm_tpu_torch.utils.metrics import METRICS

logger = logging.getLogger(__name__)

SSE_DONE = b"data: [DONE]\n\n"


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class _NullDetokenizer:
    """Stands in for IncrementalDetokenizer when there is no tokenizer."""

    full_text = ""

    def push(self, new_token_ids):
        return "", False

    def finalize(self):
        return ""


class OpenAIApp:
    def __init__(self, runner: EngineRunner, tokenizer=None,
                 model_name: str = "rtp-llm-tpu-torch", model_type: str = "",
                 access_log_path: Optional[str] = None):
        self.runner = runner
        self.tok = tokenizer
        self.model_name = model_name
        self.renderer = create_renderer(tokenizer, model_type) if tokenizer is not None else None
        self.tool_detector = get_tool_detector(model_type)
        self.start_time = time.time()
        self.access = AccessLogger(access_log_path)
        self._profile = None  # (torch.profiler.profile, trace dir) while one runs
        self._profile_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---- serving ----

    def _make_server(self, host: str, port: int) -> ThreadingHTTPServer:
        app = self

        class Handler(_Handler):
            pass

        Handler.app = app
        httpd = ThreadingHTTPServer((host, port), Handler)
        httpd.daemon_threads = True
        return httpd

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the engine loop and the HTTP server in background threads;
        returns the bound port."""
        self.runner.start()
        self._httpd = self._make_server(host, port)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def serve_forever(self, host: str, port: int):
        """Blocking: serve until interrupted."""
        self.runner.start()
        self._httpd = self._make_server(host, port)
        try:
            self._httpd.serve_forever()
        finally:
            self._httpd.server_close()
            self.runner.stop()

    def stop(self):
        if self._httpd is not None and self._thread is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
        self.runner.stop()

    # ---- GET routes ----

    def health(self):
        """200 while the engine can serve; 503 once its background graph
        captures failed (every later capture would fail too)."""
        err = self.runner.engine.warmup_error
        if err is not None:
            raise HTTPError(503, f"decode-graph warmup failed: {err}")
        return {"status": "ok"}

    def worker_status(self):
        eng = self.runner.engine
        waiting = list(eng.scheduler.waiting)  # snapshot: the engine thread mutates it
        running = list(eng.scheduler.running)
        return {
            "available_concurrency": max(
                0, eng.config.scheduler.max_batch_size - len(running)),
            "running_query_len": len(running),
            "waiting_query_len": len(waiting),
            "step_count": eng.step_count,
            "tokens_generated": eng.tokens_generated,
            "kv_free_blocks": eng.cache_mgr.pool.free_blocks,
            "kv_total_blocks": eng.cache_mgr.pool.num_blocks,
            "kv_cache_available": eng.cache_mgr.free_blocks,
            "waiting_tokens": sum(s.prompt_len for s in waiting),
            "alive": eng.warmup_error is None,
        }

    def models(self):
        return {"object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "created": int(self.start_time), "owned_by": "rtp-llm-tpu-torch"}]}

    def cache_status(self, query: dict):
        """The KV pool's counts and the prefix cache's versioned membership
        (the cache-aware routing feed): ``version``, or with
        ``?from_version=N`` the hashes added and removed since N."""
        eng = self.runner.engine
        mgr = eng.cache_mgr
        with eng.device_lock:  # the engine thread journals under it
            out = {"block_size": mgr.block_size, "total_blocks": mgr.pool.num_blocks,
                   "free_blocks": mgr.pool.free_blocks, "used_blocks": mgr.pool.used_blocks,
                   "available_blocks": mgr.free_blocks,
                   "prefix_cache_entries": (len(mgr.prefix_cache)
                                            if mgr.prefix_cache is not None else 0),
                   "backend": "python"}
            fv = query.get("from_version")
            if fv is not None:
                try:
                    out.update(mgr.cache_hash_diff(int(fv)))
                except ValueError:
                    raise HTTPError(400, f"from_version must be an integer: {fv!r}") from None
            else:
                out["version"] = mgr.hash_version
        return out

    def metrics(self, query: dict, accept: str = ""):
        """Prometheus text by default; the JSON snapshot with
        ``?format=json`` or an ``Accept: application/json`` header."""
        if query.get("format") == "json" or "application/json" in accept:
            return METRICS.snapshot()
        return METRICS.prometheus_text()

    # ---- POST control routes ----

    def tokenizer_encode(self, body: dict):
        if self.tok is None:
            raise HTTPError(400, "no tokenizer")
        ids = list(self.tok.encode(body.get("prompt", body.get("text", ""))))
        return {"token_ids": ids, "tokens": self.tok.convert_ids_to_tokens(ids)}

    def set_log_level(self, body: dict):
        level = str(body.get("level", "INFO")).upper()
        logging.getLogger().setLevel(getattr(logging, level, logging.INFO))
        return {"status": "ok", "level": level}

    def start_profile(self, body: dict):
        """Start a ``torch.profiler`` window (the engine loop's CPU ops, and
        CUDA activity on the card); 409 while one runs."""
        trace_dir = body.get("dir") or os.path.join(tempfile.gettempdir(), "rtp_llm_trace")
        with self._profile_lock:
            if self._profile is not None:
                raise HTTPError(409, "a profile is already running")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.runner.engine.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            # on the engine-loop thread: a profiler records the CPU ops of
            # the thread that starts it
            self.runner.call_in_loop(prof.start)
            self._profile = (prof, trace_dir)
        return {"status": "started", "dir": trace_dir}

    def stop_profile(self, body: dict):
        """Stop the window and write its Chrome trace into its ``dir``; 409
        when none runs."""
        with self._profile_lock:
            if self._profile is None:
                raise HTTPError(409, "no profile is running")
            (prof, trace_dir), self._profile = self._profile, None
            path = os.path.join(trace_dir, f"trace_{time.time_ns()}.json")
            self.runner.call_in_loop(lambda: self._finish_profile(prof, path))
        return {"status": "stopped", "dir": trace_dir, "trace": path}

    def _finish_profile(self, prof, path: str) -> None:
        if self.runner.engine.device.type == "cuda":
            torch.cuda.synchronize(self.runner.engine.device)
        prof.stop()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)

    def pause(self, body: dict):
        self.runner.pause()
        return {"status": "paused"}

    def restart(self, body: dict):
        self.runner.resume()
        return {"status": "running"}

    def update_weights(self, body: dict):
        """Copy the checkpoint at ``model_path`` into the live weights; 400
        when its tensors differ in shape or dtype (the engine unchanged)."""
        path = body.get("model_path")
        if not path:
            raise HTTPError(400, '"model_path" required')
        try:
            self.runner.update_weights(path)
        except ValueError as e:
            raise HTTPError(400, str(e)) from None
        except Exception as e:  # noqa: BLE001 - reported to the client as the reference does
            raise HTTPError(500, str(e)) from None
        return {"status": "updated", "model_path": path}

    def loras(self, method: str, body: dict):
        """GET lists, POST ``{name, path}`` adds, DELETE ``{name}`` removes
        a dynamic LoRA adapter (the JAX route's answers and codes). The
        engine packs the adapters again on the engine-loop thread."""
        engine = self.runner.engine
        if engine.lora_manager is None:
            engine.lora_manager = LoraManager(engine.model.cfg.num_layers)
        mgr = engine.lora_manager
        if method == "GET":
            return {"adapters": mgr.names()}
        if method == "POST":
            path = body.get("path")
            if not path:
                raise HTTPError(400, '"path" required')
            try:
                name = mgr.add_adapter(path, body.get("name"))
            except Exception as e:  # noqa: BLE001 - a bad adapter answers 400, as in the reference
                raise HTTPError(400, str(e)) from None
            try:
                self.runner.call_in_loop(engine.refresh_lora_weights)
            except Exception as e:  # noqa: BLE001 - refused before the weights changed
                mgr.remove_adapter(name)
                raise HTTPError(400, str(e)) from None
            return {"status": "added", "name": name}
        name = body.get("name")
        if not mgr.remove_adapter(name):
            raise HTTPError(404, f"unknown adapter {name!r}")
        self.runner.call_in_loop(engine.refresh_lora_weights)
        return {"status": "removed", "name": name}

    # ---- generation ----

    def completions_ids(self, body: dict):
        """Prompt token ids for /v1/completions."""
        prompt = body.get("prompt")
        if prompt is None:
            raise HTTPError(400, '"prompt" required')
        if isinstance(prompt, list) and prompt and all(isinstance(t, int) for t in prompt):
            return [int(t) for t in prompt], (), ()
        if self.tok is None:
            raise HTTPError(400, "text prompts need a tokenizer; send token ids")
        if isinstance(prompt, list):
            prompt = prompt[0]
        return list(self.tok.encode(prompt)), (), ()

    def chat_ids(self, body: dict):
        if self.tok is None:
            raise HTTPError(400, "chat completions need a tokenizer")
        messages = body.get("messages") or []
        if not messages:
            raise HTTPError(400, '"messages" required')
        try:
            rendered = self.renderer.render(
                messages, tools=body.get("tools"),
                chat_template_kwargs=body.get("chat_template_kwargs"))
        except ValueError as e:  # e.g. a tool call without its response
            raise HTTPError(400, str(e)) from None
        return rendered.token_ids, rendered.stop_words, rendered.stop_token_ids

    def request_config(self, body: dict, stop_words, stop_ids):
        """(GenerateConfig, stop token sequences) of one request; HTTP 400
        for a control it cannot take."""
        try:
            cfg = GenerateConfig.from_dict(body)
        except (TypeError, ValueError) as e:
            raise HTTPError(400, str(e)) from None
        cfg.stop_words = list(cfg.stop_words) + [w for w in stop_words
                                                 if w not in cfg.stop_words]
        cfg.stop_token_ids = list(cfg.stop_token_ids) + [
            t for t in stop_ids if t not in cfg.stop_token_ids]
        if cfg.stop_words and self.tok is None:
            raise HTTPError(400, "stop strings need a tokenizer")
        stop_seqs = [ids for ids in (self.tok.encode(s, add_special_tokens=False)
                                     for s in cfg.stop_words) if ids]
        return cfg, stop_seqs

    def _detokenizer(self, cfg):
        return (IncrementalDetokenizer(self.tok, cfg.stop_words)
                if self.tok is not None else _NullDetokenizer())

    def parse(self, text: str) -> ParsedOutput:
        """A chat choice's text as reasoning, tool calls and content."""
        return parse_output(text, detector=self.tool_detector)

    def stream_parser(self) -> StreamingOutputParser:
        """The incremental parser of one streamed chat choice."""
        return StreamingOutputParser(detector=self.tool_detector)

    def enqueue(self, token_ids, cfg, stop_seqs, n: int = 1):
        """Enqueue ``n`` independent streams of one request (the
        ``num_return_sequences`` fan-out; each gets one choice); returns
        (streams, detokenizers). A stream the engine refuses aborts its
        siblings and answers 429 (overloaded) or 400."""
        streams = []
        for _ in range(n):
            stream = self.runner.enqueue(token_ids, cfg, stop_token_sequences=stop_seqs)
            if stream.error:
                for prev in streams:
                    prev.abort("overloaded: sibling stream shed")
                raise HTTPError(429 if stream.error.startswith("overloaded") else 400,
                                stream.error)
            streams.append(stream)
        return streams, [self._detokenizer(cfg) for _ in streams]

    @staticmethod
    def usage(streams) -> dict:
        n_out = sum(len(s.output_token_ids) for s in streams)
        prompt = streams[0].prompt_len
        return {"prompt_tokens": prompt, "completion_tokens": n_out,
                "total_tokens": prompt + n_out,
                "prompt_tokens_details": {"cached_tokens": streams[0].reuse_len}}

    @staticmethod
    def drain(stream, detok) -> None:
        """Read a stream to its end (or to a stop string in its text)."""
        while True:
            out = stream.next_output()
            if out.error:
                raise HTTPError(429 if out.error.startswith("overloaded") else 500,
                                out.error)
            _, hit = detok.push(out.new_tokens)
            if hit and not out.finished:
                stream.finish(FinishReason.STOP)  # stop string seen in the text
                return
            if out.finished:
                return

    def _token_text(self, token: int) -> str:
        return self.tok.decode([token]) if self.tok is not None else ""

    def choice(self, index: int, stream, detok, chat: bool) -> dict:
        """One choice of a finished stream. A chat choice's message is the
        parsed text: ``reasoning_content`` when it thought, ``tool_calls``
        (content then null when empty, finish reason "tool_calls") when it
        called. With ``logprobs`` it carries the reference's logprob
        objects: per token ``top_logprobs: []`` on a chat,
        ``top_logprobs: None`` on a completion."""
        fin = stream.finish_reason.value if stream.finish_reason else "stop"
        text = detok.full_text
        choice = {"index": index, "finish_reason": fin,
                  "token_ids": list(stream.output_token_ids)}
        want_lp = stream.config.return_logprobs
        ids, lps = stream.output_token_ids, stream.output_logprobs
        if chat:
            parsed = self.parse(text)
            message = {"role": "assistant", "content": parsed.content}
            if parsed.reasoning_content:
                message["reasoning_content"] = parsed.reasoning_content
            if parsed.tool_calls:
                message["tool_calls"] = parsed.tool_calls
                message["content"] = parsed.content or None
                choice["finish_reason"] = "tool_calls"
            choice["message"] = message
            choice["logprobs"] = ({"content": [
                {"token": self._token_text(t), "logprob": lp, "top_logprobs": []}
                for t, lp in zip(ids, lps)]} if want_lp and lps else None)
        else:
            choice.update(text=text, logprobs=(
                {"tokens": [self._token_text(t) for t in ids], "token_logprobs": list(lps),
                 "top_logprobs": None, "text_offset": None} if want_lp and lps else None))
        return choice

    def _body(self, rid: str, chat: bool, choices, streams, loss) -> dict:
        body = {"id": rid, "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()), "model": self.model_name,
                "choices": choices, "usage": self.usage(streams)}
        if loss is not None:
            body["loss"] = loss
        return body

    def respond(self, token_ids, cfg, stop_seqs, chat: bool, rid: str):
        """(the non-streamed body, its streams): ``num_return_sequences``
        choices, the prompt's ``loss`` with ``calculate_loss`` (1: the mean
        NLL, 2: the per-token list) and, with ``return_hidden_states``, one
        choice generated by the teacher-forced loop with its
        ``hidden_states`` ``[n_out][H]``."""
        engine = self.runner.engine
        loss = None
        try:
            if cfg.calculate_loss:
                nll = engine.compute_prompt_loss(token_ids, adapter_name=cfg.adapter_name)
                loss = float(nll.mean()) if cfg.calculate_loss == 1 else nll.tolist()
            if cfg.return_hidden_states:
                stream, hidden = engine.generate_with_hidden(token_ids, cfg)
        except ValueError as e:  # a prompt past max_seq_len
            raise HTTPError(400, str(e)) from None
        except RuntimeError as e:  # the KV pool stayed full
            raise HTTPError(503, str(e)) from None
        if cfg.return_hidden_states:
            detok = self._detokenizer(cfg)
            detok.push(stream.output_token_ids)
            choice = self.choice(0, stream, detok, chat)
            choice["hidden_states"] = hidden.tolist()
            return self._body(rid, chat, [choice], [stream], loss), [stream]
        streams, detoks = self.enqueue(token_ids, cfg, stop_seqs,
                                       n=cfg.num_return_sequences)
        try:
            for s, d in zip(streams, detoks):
                self.drain(s, d)
        except HTTPError:
            for s in streams:  # the siblings of a failed choice
                if not s.is_finished():
                    s.abort()
            raise
        choices = [self.choice(i, s, d, chat)
                   for i, (s, d) in enumerate(zip(streams, detoks))]
        return self._body(rid, chat, choices, streams, loss), streams

    @staticmethod
    def _outputs(streams):
        """(choice index, StreamOutput) as the streams produce them; n > 1
        interleaves them through one queue fed by a thread a stream."""
        if len(streams) == 1:
            while True:
                yield 0, streams[0].next_output()
        merged: "queue.Queue" = queue.Queue()

        def pump(i, s):
            while True:
                out = s.next_output()
                merged.put((i, out))
                if out.finished:
                    return

        for i, s in enumerate(streams):
            threading.Thread(target=pump, args=(i, s), daemon=True).start()
        while True:
            yield merged.get()

    def sse_chunks(self, streams, detoks, chat: bool, rid: str):
        """Yield server-sent-event payloads for a streaming response; with
        n > 1 each choice's chunks carry its index, interleaved as they come,
        and ``[DONE]`` follows the last choice's end. Each engine output's
        token ids ride on one chunk. A chat opens every choice with the role
        chunk; its text goes through the choice's streaming parser into
        ``reasoning_content`` and ``content`` deltas, and at its end come
        the parser's last deltas, a ``tool_calls`` delta when it called,
        then the finish chunk (with ``usage``)."""
        created = int(time.time())

        def chunk(i, delta, tokens, finish=None, usage=None):
            if chat:
                choice = {"index": i, "delta": delta, "finish_reason": finish}
            else:
                choice = {"index": i, "text": delta.get("content", ""), "finish_reason": finish}
            choice["token_ids"] = tokens
            d = {"id": rid, "created": created, "model": self.model_name,
                 "object": "chat.completion.chunk" if chat else "text_completion",
                 "choices": [choice]}
            if usage is not None:
                d["usage"] = usage
            return f"data: {json.dumps(d, ensure_ascii=False)}\n\n".encode()

        parsers = [self.stream_parser() for _ in streams] if chat else None
        done = [False] * len(streams)

        def emit(i, out):
            """The chunks of choice ``i``'s output ``out``."""
            stream, detok = streams[i], detoks[i]
            text, hit = detok.push(out.new_tokens)
            if hit and not out.finished:
                stream.finish(FinishReason.STOP)
            final = out.finished or hit
            if final:
                text += detok.finalize()
                done[i] = True
            fin = ("stop" if hit else (stream.finish_reason.value
                                       if stream.finish_reason else "stop")) if final else None
            tokens = list(out.new_tokens)
            if not chat:
                yield chunk(i, {"content": text}, tokens, finish=fin,
                            usage=self.usage([stream]) if final else None)
                return
            reasoning, content = parsers[i].push(text)
            calls = None
            if final:
                r, c, calls = parsers[i].finalize()
                reasoning, content = reasoning + r, content + c
            delta = {}
            if reasoning:
                delta["reasoning_content"] = reasoning
            if content:
                delta["content"] = content
            if not final:
                yield chunk(i, delta or {"content": ""}, tokens)
                return
            if delta:
                yield chunk(i, delta, [])
            if calls:
                yield chunk(i, {"tool_calls": [{**tc, "index": j} for j, tc in enumerate(calls)]},
                            [])
                fin = "tool_calls"
            yield chunk(i, {}, tokens, finish=fin, usage=self.usage([stream]))

        if chat:
            for i in range(len(streams)):
                yield chunk(i, {"role": "assistant", "content": ""}, [])
        for i, out in self._outputs(streams):
            if done[i]:
                continue  # the end a stop string already closed
            if out.error:
                yield chunk(i, {}, [], finish="error")
                done[i] = True
            else:
                yield from emit(i, out)
            if all(done):
                break
        yield SSE_DONE

    # ---- request accounting ----

    def log_query(self, rid: str, route: str, token_ids, cfg, streamed: bool) -> float:
        """Count a generation request and log its query; returns its start."""
        METRICS.inc("frontend.requests")
        self.access.log_query(rid, route, {"prompt_tokens": len(token_ids), "stream": streamed,
                                           "max_new_tokens": cfg.max_new_tokens})
        return time.time()

    def log_done(self, rid: str, route: str, stream, token_ids, t_start: float) -> None:
        """The request's TTFT (from its first stream) and latency, into the
        metrics and the access log."""
        latency = (time.time() - t_start) * 1e3
        ttft = None
        if stream.first_token_time:
            ttft = (stream.first_token_time - stream.enqueue_time) * 1e3
            METRICS.observe("frontend.ttft_ms", ttft)
        METRICS.observe("frontend.latency_ms", latency)
        self.access.log_success(rid, route, latency, len(token_ids),
                                len(stream.output_token_ids), first_token_ms=ttft)

    def log_error(self, rid: Optional[str], route: str, error: str) -> None:
        if rid is not None:  # a request refused before its id was made logs nothing
            self.access.log_exception(rid, route, error)


class _Handler(BaseHTTPRequestHandler):
    app: OpenAIApp = None
    server_version = "rtp-llm-tpu-torch"

    def log_message(self, fmt, *args):  # route access logs to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _send(self, status: int, data: bytes, content_type: str):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, status: int, payload):
        self._send(status, json.dumps(payload, ensure_ascii=False).encode(), "application/json")

    def _send_error(self, status: int, message: str):
        self._send_json(status, {"error": {"message": message, "code": status}})

    def _reply(self, fn):
        """Answer with ``fn()``: JSON, or text/plain for a string."""
        try:
            out = fn()
        except HTTPError as e:
            self._send_error(e.status, e.message)
            return
        if isinstance(out, str):
            self._send(200, out.encode(), "text/plain; charset=utf-8")
        else:
            self._send_json(200, out)

    def _split_path(self):
        route, _, qs = self.path.partition("?")
        return route, {k: v[-1] for k, v in urllib.parse.parse_qs(qs).items()}

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid JSON: {e}") from None
        if not isinstance(body, dict):
            raise HTTPError(400, "request body must be a JSON object")
        return body

    def do_GET(self):
        app = self.app
        route, query = self._split_path()
        routes = {"/health": app.health, "/status": app.health,
                  "/worker_status": app.worker_status, "/v1/models": app.models,
                  "/cache_status": lambda: app.cache_status(query),
                  "/metrics": lambda: app.metrics(query, self.headers.get("Accept", ""))}
        if route == "/v1/loras":
            self._reply(lambda: app.loras("GET", {}))
            return
        fn = routes.get(route)
        if fn is None:
            self._send_error(404, f"no route {self.path}")
            return
        self._reply(fn)

    def do_DELETE(self):
        route, _ = self._split_path()
        if route != "/v1/loras":
            self._send_error(404, f"no route {self.path}")
            return
        self._reply(lambda: self.app.loras("DELETE", self._read_body()))

    CONTROL_ROUTES = {"/tokenizer/encode": "tokenizer_encode", "/set_log_level": "set_log_level",
                      "/start_profile": "start_profile", "/stop_profile": "stop_profile",
                      "/pause": "pause", "/restart": "restart",
                      "/update_weights": "update_weights"}
    GENERATE_ROUTES = {"/v1/completions": False, "/": False,
                       "/v1/chat/completions": True, "/chat/completions": True}

    def do_POST(self):
        route, _ = self._split_path()
        if route == "/v1/loras":
            self._reply(lambda: self.app.loras("POST", self._read_body()))
            return
        if route in self.CONTROL_ROUTES:
            fn = getattr(self.app, self.CONTROL_ROUTES[route])
            self._reply(lambda: fn(self._read_body()))
            return
        if route not in self.GENERATE_ROUTES:
            self._send_error(404, f"no route {self.path}")
            return
        self._generate(route, self.GENERATE_ROUTES[route])

    def _generate(self, route: str, chat: bool):
        app = self.app
        streams, rid = [], None
        try:
            body = self._read_body()
            token_ids, stop_words, stop_ids = (app.chat_ids if chat
                                               else app.completions_ids)(body)
            cfg, stop_seqs = app.request_config(body, stop_words, stop_ids)
            rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
            streamed = bool(body.get("stream"))
            t_start = app.log_query(rid, route, token_ids, cfg, streamed)
            # the request is logged done before its last bytes go out
            if not streamed:
                payload, streams = app.respond(token_ids, cfg, stop_seqs, chat, rid)
                app.log_done(rid, route, streams[0], token_ids, t_start)
                self._send_json(200, payload)
                return
            streams, detoks = app.enqueue(token_ids, cfg, stop_seqs,
                                          n=cfg.num_return_sequences)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            for payload in app.sse_chunks(streams, detoks, chat, rid):
                if payload == SSE_DONE:
                    app.log_done(rid, route, streams[0], token_ids, t_start)
                self.wfile.write(payload)
                self.wfile.flush()
        except HTTPError as e:
            app.log_error(rid, route, e.message)
            self._send_error(e.status, e.message)
        except (BrokenPipeError, ConnectionResetError):
            app.log_error(rid, route, "client went away")
            for s in streams:  # client went away
                if not s.is_finished():
                    s.abort()


def build_app(engine, tokenizer=None, model_name: str = "rtp-llm-tpu-torch",
              access_log_path: Optional[str] = None) -> OpenAIApp:
    """The HTTP app over ``engine`` (not started: call ``start`` or
    ``serve_forever``). Used by ``cli serve`` and ``chip_smoke.py``."""
    return OpenAIApp(EngineRunner(engine), tokenizer, model_name=model_name,
                     model_type=engine.model.cfg.model_type, access_log_path=access_log_path)
