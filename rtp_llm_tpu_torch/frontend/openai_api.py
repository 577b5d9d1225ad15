"""OpenAI-compatible HTTP API on the standard library.

Port of ``rtp_llm_tpu/frontend/openai_api.py`` built on
``http.server.ThreadingHTTPServer`` (one thread per connection, no aiohttp):
  POST /v1/completions       token-id prompts, or text when a tokenizer exists
  POST /v1/chat/completions  (needs a tokenizer)
  GET  /health, /worker_status
``"stream": true`` answers with server-sent events. Without a tokenizer the
text routes answer 400 and token-id prompts are still served; every choice
also carries the generated ``token_ids``, and ``usage`` reports the reused
prefix as ``prompt_tokens_details.cached_tokens``. As the reference does, ``n``
> 1 fans out into independent streams (choices interleaved by index when
streamed), a non-streamed response carries the prompt's ``loss`` with
``calculate_loss`` and a choice's ``hidden_states`` with
``return_hidden_states``, and ``top_logprobs`` returns empty lists beside the
logprobs.
"""

from __future__ import annotations

import json
import logging
import queue
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
        """One choice of a finished stream. With ``logprobs`` it carries the
        reference's logprob objects: per token ``top_logprobs: []`` on a
        chat, ``top_logprobs: None`` on a completion."""
        fin = stream.finish_reason.value if stream.finish_reason else "stop"
        text = detok.full_text
        choice = {"index": index, "finish_reason": fin,
                  "token_ids": list(stream.output_token_ids)}
        want_lp = stream.config.return_logprobs
        ids, lps = stream.output_token_ids, stream.output_logprobs
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
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

    def respond(self, token_ids, cfg, stop_seqs, chat: bool, rid: str) -> dict:
        """The non-streamed body: ``num_return_sequences`` choices, the
        prompt's ``loss`` with ``calculate_loss`` (1: the mean NLL, 2: the
        per-token list) and, with ``return_hidden_states``, one choice
        generated by the teacher-forced loop with its ``hidden_states``
        ``[n_out][H]``."""
        engine = self.runner.engine
        loss = None
        try:
            if cfg.calculate_loss:
                nll = engine.compute_prompt_loss(token_ids)
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
            return self._body(rid, chat, [choice], [stream], loss)
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
        return self._body(rid, chat, choices, streams, loss)

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
        and ``[DONE]`` follows the last choice's end."""
        created = int(time.time())

        def chunk(i, text, tokens, finish=None, usage=None):
            if chat:
                choice = {"index": i, "delta": {"content": text} if text or finish is None
                          else {}, "finish_reason": finish}
            else:
                choice = {"index": i, "text": text, "finish_reason": finish}
            choice["token_ids"] = tokens
            d = {"id": rid, "created": created, "model": self.model_name,
                 "object": "chat.completion.chunk" if chat else "text_completion",
                 "choices": [choice]}
            if usage is not None:
                d["usage"] = usage
            return f"data: {json.dumps(d, ensure_ascii=False)}\n\n".encode()

        done = [False] * len(streams)
        for i, out in self._outputs(streams):
            if done[i]:
                continue  # the end a stop string already closed
            stream, detok = streams[i], detoks[i]
            if out.error:
                yield chunk(i, "", [], finish="error")
                done[i] = True
            else:
                text, hit = detok.push(out.new_tokens)
                if hit and not out.finished:
                    stream.finish(FinishReason.STOP)
                if out.finished or hit:
                    text += detok.finalize()
                    fin = "stop" if hit else (stream.finish_reason.value
                                              if stream.finish_reason else "stop")
                    yield chunk(i, text, list(out.new_tokens), finish=fin,
                                usage=self.usage([stream]))
                    done[i] = True
                else:
                    yield chunk(i, text, list(out.new_tokens))
            if all(done):
                break
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
        try:
            self._send_json(200, fn())
        except HTTPError as e:
            self._send_error(e.status, e.message)

    def do_POST(self):
        route = self.path.split("?", 1)[0]
        pick = {"/v1/completions": (self.app.completions_ids, False),
                "/v1/chat/completions": (self.app.chat_ids, True),
                "/chat/completions": (self.app.chat_ids, True)}.get(route)
        if pick is None:
            self._send_error(404, f"no route {self.path}")
            return
        to_ids, chat = pick
        streams = []
        try:
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                raise HTTPError(400, f"invalid JSON: {e}") from None
            if not isinstance(body, dict):
                raise HTTPError(400, "request body must be a JSON object")
            token_ids, stop_words, stop_ids = to_ids(body)
            cfg, stop_seqs = self.app.request_config(body, stop_words, stop_ids)
            rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
            if not body.get("stream"):
                self._send_json(200, self.app.respond(token_ids, cfg, stop_seqs, chat, rid))
                return
            streams, detoks = self.app.enqueue(token_ids, cfg, stop_seqs,
                                               n=cfg.num_return_sequences)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            for payload in self.app.sse_chunks(streams, detoks, chat, rid):
                self.wfile.write(payload)
                self.wfile.flush()
        except HTTPError as e:
            self._send_error(e.status, e.message)
        except (BrokenPipeError, ConnectionResetError):
            for s in streams:  # client went away
                if not s.is_finished():
                    s.abort()


def build_app(engine, tokenizer=None, model_name: str = "rtp-llm-tpu-torch") -> OpenAIApp:
    """The HTTP app over ``engine`` (not started: call ``start`` or
    ``serve_forever``). Used by ``cli serve`` and ``chip_smoke.py``."""
    return OpenAIApp(EngineRunner(engine), tokenizer, model_name=model_name,
                     model_type=engine.model.cfg.model_type)
