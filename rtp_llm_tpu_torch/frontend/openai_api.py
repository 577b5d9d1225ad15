"""OpenAI-compatible HTTP API on the standard library.

Port of ``rtp_llm_tpu/frontend/openai_api.py`` built on
``http.server.ThreadingHTTPServer`` (one thread per connection, no aiohttp):
  POST /v1/completions       token-id prompts, or text when a tokenizer exists
  POST /v1/chat/completions  (needs a tokenizer)
  GET  /health, /worker_status
``"stream": true`` answers with server-sent events. Without a tokenizer the
text routes answer 400 and token-id prompts are still served; every choice
also carries the generated ``token_ids``, and ``usage`` reports the reused
prefix as ``prompt_tokens_details.cached_tokens``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from rtp_llm_tpu_torch.config.generate_config import GenerateConfig
from rtp_llm_tpu_torch.engine.stream import FinishReason
from rtp_llm_tpu_torch.frontend.chat_renderer import ChatRenderer
from rtp_llm_tpu_torch.frontend.token_processor import IncrementalDetokenizer
from rtp_llm_tpu_torch.server.engine_runner import EngineRunner

logger = logging.getLogger(__name__)


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
                 model_name: str = "rtp-llm-tpu-torch", model_type: str = ""):
        self.runner = runner
        self.tok = tokenizer
        self.model_name = model_name
        self.renderer = ChatRenderer(tokenizer, model_type) if tokenizer is not None else None
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

    # ---- routes ----

    def health(self):
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
            "alive": True,
        }

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
        if body.get("tools"):
            # the reference parses the reply into tool_calls; a reply of raw
            # text would look like an answer without them
            raise HTTPError(400, "tool-call parsing is not ported yet")
        rendered = self.renderer.render(
            messages, tools=body.get("tools"),
            chat_template_kwargs=body.get("chat_template_kwargs"))
        return rendered.token_ids, rendered.stop_words, rendered.stop_token_ids

    def generate(self, body: dict, token_ids, stop_words, stop_ids, chat: bool):
        """Enqueue one request; returns (stream, cfg, detokenizer)."""
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
        stream = self.runner.enqueue(token_ids, cfg, stop_token_sequences=stop_seqs)
        if stream.error:
            raise HTTPError(429 if stream.error.startswith("overloaded") else 400,
                            stream.error)
        detok = (IncrementalDetokenizer(self.tok, cfg.stop_words)
                 if self.tok is not None else _NullDetokenizer())
        return stream, cfg, detok

    @staticmethod
    def usage(stream) -> dict:
        n_out = len(stream.output_token_ids)
        return {"prompt_tokens": stream.prompt_len, "completion_tokens": n_out,
                "total_tokens": stream.prompt_len + n_out,
                "prompt_tokens_details": {"cached_tokens": stream.reuse_len}}

    def collect(self, stream, detok, chat: bool, rid: str) -> dict:
        """Drain a stream to completion and build the non-streaming body."""
        while True:
            out = stream.next_output()
            if out.error:
                raise HTTPError(429 if out.error.startswith("overloaded") else 500,
                                out.error)
            _, hit = detok.push(out.new_tokens)
            if hit and not out.finished:
                stream.finish(FinishReason.STOP)  # stop string seen in the text
                break
            if out.finished:
                break
        fin = stream.finish_reason.value if stream.finish_reason else "stop"
        text = detok.full_text
        choice = {"index": 0, "finish_reason": fin,
                  "token_ids": list(stream.output_token_ids)}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice.update(text=text, logprobs=(
                {"token_logprobs": list(stream.output_logprobs)}
                if stream.config.return_logprobs else None))
        return {"id": rid, "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()), "model": self.model_name,
                "choices": [choice], "usage": self.usage(stream)}

    def sse_chunks(self, stream, detok, chat: bool, rid: str):
        """Yield server-sent-event payloads for a streaming response."""
        created = int(time.time())

        def chunk(text, tokens, finish=None, usage=None):
            if chat:
                choice = {"index": 0, "delta": {"content": text} if text or finish is None
                          else {}, "finish_reason": finish}
            else:
                choice = {"index": 0, "text": text, "finish_reason": finish}
            choice["token_ids"] = tokens
            d = {"id": rid, "created": created, "model": self.model_name,
                 "object": "chat.completion.chunk" if chat else "text_completion",
                 "choices": [choice]}
            if usage is not None:
                d["usage"] = usage
            return f"data: {json.dumps(d, ensure_ascii=False)}\n\n".encode()

        while True:
            out = stream.next_output()
            if out.error:
                yield chunk("", [], finish="error")
                break
            text, hit = detok.push(out.new_tokens)
            if hit and not out.finished:
                stream.finish(FinishReason.STOP)
            if out.finished or hit:
                text += detok.finalize()
                fin = "stop" if hit else (stream.finish_reason.value
                                          if stream.finish_reason else "stop")
                yield chunk(text, list(out.new_tokens), finish=fin,
                            usage=self.usage(stream))
                break
            yield chunk(text, list(out.new_tokens))
        yield b"data: [DONE]\n\n"


class _Handler(BaseHTTPRequestHandler):
    app: OpenAIApp = None
    server_version = "rtp-llm-tpu-torch"

    def log_message(self, fmt, *args):  # route access logs to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _send_json(self, status: int, payload):
        data = json.dumps(payload, ensure_ascii=False).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_error(self, status: int, message: str):
        self._send_json(status, {"error": {"message": message, "code": status}})

    def do_GET(self):
        routes = {"/health": self.app.health, "/worker_status": self.app.worker_status}
        fn = routes.get(self.path.split("?", 1)[0])
        if fn is None:
            self._send_error(404, f"no route {self.path}")
            return
        self._send_json(200, fn())

    def do_POST(self):
        route = self.path.split("?", 1)[0]
        pick = {"/v1/completions": (self.app.completions_ids, False),
                "/v1/chat/completions": (self.app.chat_ids, True),
                "/chat/completions": (self.app.chat_ids, True)}.get(route)
        if pick is None:
            self._send_error(404, f"no route {self.path}")
            return
        to_ids, chat = pick
        stream = None
        try:
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                raise HTTPError(400, f"invalid JSON: {e}") from None
            if not isinstance(body, dict):
                raise HTTPError(400, "request body must be a JSON object")
            token_ids, stop_words, stop_ids = to_ids(body)
            stream, _, detok = self.app.generate(body, token_ids, stop_words,
                                                 stop_ids, chat)
            rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
            if not body.get("stream"):
                self._send_json(200, self.app.collect(stream, detok, chat, rid))
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            for payload in self.app.sse_chunks(stream, detok, chat, rid):
                self.wfile.write(payload)
                self.wfile.flush()
        except HTTPError as e:
            self._send_error(e.status, e.message)
        except (BrokenPipeError, ConnectionResetError):
            if stream is not None and not stream.is_finished():
                stream.abort()  # client went away


def build_app(engine, tokenizer=None, model_name: str = "rtp-llm-tpu-torch") -> OpenAIApp:
    """The HTTP app over ``engine`` (not started: call ``start`` or
    ``serve_forever``). Used by ``cli serve`` and ``chip_smoke.py``."""
    return OpenAIApp(EngineRunner(engine), tokenizer, model_name=model_name,
                     model_type=engine.model.cfg.model_type)
