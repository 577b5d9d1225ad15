"""Structured per-request access logging.

Port of ``rtp_llm_tpu/utils/access_logger.py``.

Analog of the reference access_logger (rtp_llm/access_logger/access_logger.py:38):
one JSON line per request (query + success/exception records) on a dedicated
logger, non-blocking via QueueHandler.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import queue
import time
from typing import Any, Optional


class AccessLogger:
    def __init__(self, path: Optional[str] = None, logger_name: str = "rtp_llm_access"):
        self.logger = logging.getLogger(logger_name)
        self.logger.propagate = False
        self.logger.setLevel(logging.INFO)
        if not self.logger.handlers:
            handler: logging.Handler
            if path:
                handler = logging.FileHandler(path)
            else:
                handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("%(message)s"))
            q: "queue.Queue" = queue.Queue(maxsize=10000)
            qh = logging.handlers.QueueHandler(q)
            self._listener = logging.handlers.QueueListener(q, handler)
            self._listener.start()
            self.logger.addHandler(qh)

    def log_query(self, request_id: Any, route: str, body_summary: dict):
        self._emit({"type": "query", "request_id": request_id, "route": route,
                    **body_summary})

    def log_success(self, request_id: Any, route: str, latency_ms: float,
                    prompt_tokens: int, completion_tokens: int,
                    first_token_ms: Optional[float] = None):
        self._emit({
            "type": "success", "request_id": request_id, "route": route,
            "latency_ms": round(latency_ms, 2),
            "first_token_ms": round(first_token_ms, 2) if first_token_ms else None,
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
        })

    def log_exception(self, request_id: Any, route: str, error: str):
        self._emit({"type": "exception", "request_id": request_id,
                    "route": route, "error": error})

    def _emit(self, record: dict):
        record["ts"] = time.time()
        try:
            self.logger.info(json.dumps(record, ensure_ascii=False, default=str))
        except Exception:
            pass
