"""Engine loop thread (port of ``rtp_llm_tpu/server/engine_runner.py``).

A dedicated thread steps the engine whenever it has work: streams waiting or
running, or a decode window in flight that is not read back yet. enqueue is
thread-safe and wakes the loop. HTTP handler threads block on each stream's
output queue; with ``decode_steps = N`` a window puts N tokens on it at once.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from rtp_llm_tpu_torch.config.generate_config import GenerateConfig
from rtp_llm_tpu_torch.engine.engine import LlmEngine
from rtp_llm_tpu_torch.engine.stream import GenerateStream

logger = logging.getLogger(__name__)


class EngineRunner:
    def __init__(self, engine: LlmEngine):
        self.engine = engine
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "EngineRunner":
        self._thread = threading.Thread(target=self._loop, name="engine-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread:
            self._thread.join(timeout=timeout)

    def enqueue(self, prompt_token_ids: List[int],
                config: Optional[GenerateConfig] = None,
                stop_token_sequences=None) -> GenerateStream:
        # the engine lock keeps the scheduler's queue consistent with a step
        with self.engine.device_lock:
            stream = self.engine.enqueue(prompt_token_ids, config,
                                         stop_token_sequences=stop_token_sequences)
        with self._cond:
            self._cond.notify_all()
        return stream

    def _loop(self):
        logger.info("engine loop started")
        while True:
            with self._cond:
                while not self._stop and not self.engine.has_work():
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    break
            try:
                self.engine.step()
            except Exception:  # an engine error must not kill the loop silently
                logger.exception("engine step failed; aborting running streams")
                with self.engine.device_lock:
                    self.engine.abort_all("engine step error")
        logger.info("engine loop stopped")
