"""Engine loop thread (port of ``rtp_llm_tpu/server/engine_runner.py``).

A dedicated thread steps the engine whenever it has work: streams waiting or
running, or a decode window in flight that is not read back yet. enqueue is
thread-safe and wakes the loop. HTTP handler threads block on each stream's
output queue; with ``decode_steps = N`` a window puts N tokens on it at once.

``pause`` stops the stepping (streams stay queued) and ``resume`` restarts
it. ``update_weights`` loads a checkpoint through the engine's own loader,
quantizer and fusion and copies it into the live weight tensors: the
decode, verify and rollout windows are CUDA graphs that read those tensors
by address, so a rebinding (the JAX runner's ``eng.weights = new``) would
leave every replay on the old weights. The LoRA stacks are not in a
checkpoint and stay as they are (the JAX runner's rebinding drops them).
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
from typing import List, Optional

import torch

from rtp_llm_tpu_torch.config.generate_config import GenerateConfig
from rtp_llm_tpu_torch.engine.engine import LlmEngine
from rtp_llm_tpu_torch.engine.stream import GenerateStream
from rtp_llm_tpu_torch.loader.loader import CheckpointLoader
from rtp_llm_tpu_torch.quant import make_quant_transform

logger = logging.getLogger(__name__)


def check_same_layout(live: dict, new: dict) -> None:
    """ValueError unless ``new`` has the names of ``live``, each tensor of
    the same shape and dtype and each marker entry equal."""
    bad = sorted(set(live) ^ set(new))
    for name in sorted(set(live) & set(new)):
        a, b = live[name], new[name]
        if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
            bad.append(name)
        elif isinstance(a, torch.Tensor):
            if a.shape != b.shape or a.dtype != b.dtype:
                bad.append(f"{name}: {tuple(b.shape)} {b.dtype} for {tuple(a.shape)} {a.dtype}")
        elif a != b:
            bad.append(name)
    if bad:
        raise ValueError("checkpoint does not match the served weights: "
                         + "; ".join(bad[:4]) + (" ..." if len(bad) > 4 else ""))


def copy_weights(live: dict, new: dict) -> None:
    """Copy every tensor of ``new`` into its counterpart in ``live``: the
    live tensors keep their storage."""
    for name, t in new.items():
        if isinstance(t, torch.Tensor):
            live[name].copy_(t)


class EngineRunner:
    def __init__(self, engine: LlmEngine):
        self.engine = engine
        self._cond = threading.Condition()
        self._stop = False
        self._paused = False
        self._tasks: list = []  # (fn, Future) to run on the loop thread
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

    def pause(self):
        """Stop stepping after the step in progress; streams stay queued."""
        with self._cond:
            self._paused = True

    def resume(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    @property
    def paused(self) -> bool:
        return self._paused

    def call_in_loop(self, fn):
        """Run ``fn()`` on the engine-loop thread between two steps (paused
        or not) and return its result; on the caller's thread when no loop
        runs."""
        if self._thread is None or not self._thread.is_alive():
            return fn()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            self._tasks.append((fn, fut))
            self._cond.notify_all()
        return fut.result()

    def update_weights(self, model_path: str):
        """Load ``model_path`` as the engine loaded its weights (the same
        loader, load-time quantization and fusion) and copy it into the live
        tensors under the device lock, so that captured graphs, the EAGLE
        head's reference and every later step read the new values.
        ValueError, with the engine unchanged, when the checkpoint's tensors
        differ in shape or dtype from the served ones. Streams in flight go
        on with the new weights (the JAX semantics); the prefix cache is
        invalidated, since its blocks hold the old weights' KV."""
        eng = self.engine
        new = CheckpointLoader(eng.model.cfg, device=eng.device,
                               transform=make_quant_transform(eng.config.quant)).load(model_path)
        new = eng.model.fuse_weights(new)
        check_same_layout({k: v for k, v in eng.weights.items() if ".lora_" not in k}, new)
        with eng.device_lock, torch.no_grad():
            copy_weights(eng.weights, new)
            eng.cache_mgr.invalidate_prefix_cache()
        logger.info("weights updated from %s", model_path)

    def _loop(self):
        logger.info("engine loop started")
        while True:
            with self._cond:
                while not self._stop and not self._tasks and (
                        self._paused or not self.engine.has_work()):
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    break
                tasks, self._tasks = self._tasks, []
            for fn, fut in tasks:
                try:
                    fut.set_result(fn())
                except Exception as e:  # noqa: BLE001 - handed to the caller
                    fut.set_exception(e)
            if self._paused or not self.engine.has_work():
                continue
            try:
                self.engine.step()
            except Exception:  # an engine error must not kill the loop silently
                logger.exception("engine step failed; aborting running streams")
                with self.engine.device_lock:
                    self.engine.abort_all("engine step error")
        logger.info("engine loop stopped")
