"""Captured CUDA graphs of the engine's decode windows, and their readback.

The JAX engine jits one decode program per (kv bucket, ``need_sampling``,
``need_stats``) and one ``lax.scan`` of ``n_steps`` fused decode+sample
bodies per the same key and step count (``_decode_jit``,
``_decode_multi_jit``), and retraces the single step for n-gram bans and trie
allow-lists. Here each such program is a ``torch.cuda.CUDAGraph`` of
``n_steps`` bodies over the engine's static tensors (decode state, KV pool,
weights, the ban and allow buffers), keyed the same way plus a
``constrained`` flag for the steps that read the ban and allow rows: one
replay launches a whole window from one host call, where the eager window
dispatches every kernel from Python. The speculative windows share the
cache: the verify (the target's T = K+1 forward and the acceptance) and a
draft model's or EAGLE head's K+1-step rollout, which writes its drafts
into the buffer the verify reads. Every window is one ``WindowKey``.

* All graphs share one memory pool. A capture frees its intermediates when
  it ends, so the next capture reuses them: the pool holds one window's
  activations (logits ``[B, V]`` f32 and the sampler's copies of them) and
  the graphs' small static outputs, not one set a graph (a verify's logits
  are ``[B * (K+1), V]`` f32). The graphs replay one at a time on one
  stream, so sharing is safe.
* Capture runs no kernel, so a capture in the middle of serving leaves the
  state as it was. Whatever initialises lazily (cuBLAS handles and their
  workspace for the capture stream, a kernel's first
  ``cudaFuncSetAttribute``, lazily loaded modules) runs first in ``prime``,
  eagerly, on an idle batch; a thread that captures later (the engine's
  background warmup) creates its own cuBLAS handles first (``ready_thread``).
* The engine's ``torch.Generator`` is registered with each graph, so every
  replay draws new numbers and advances the generator as the eager window
  would.
* Nothing else touches the card while a capture runs: the HTTP threads run
  no CUDA and ``enqueue`` waits on the engine's lock. So the capture takes
  the strictest error mode, ``"global"``, under which any such call fails
  the capture instead of corrupting it.
* A capture that fails raises. There is no fallback to the eager window.

A replay makes no Python call of a kernel wrapper, so each graph records the
launch counts its capture made (``_kernels.CapturedCalls``) and adds them at
every replay.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from rtp_llm_tpu_torch._kernels import CapturedCalls


class WindowKey(NamedTuple):
    """One window of the graph cache. ``kind`` "decode": ``n_steps`` decode
    bodies, sampling or greedy, with or without the stats pass, reading the
    ban and allow rows when ``constrained``; "verify": the target's forward
    at T = ``k`` + 1 and the acceptance; "vanilla" / "eagle" (the
    speculative method): that proposer's rollout of ``k`` drafts. A
    speculative window leaves the decode fields at their defaults."""
    kv_blocks: int
    need_sampling: bool = False
    need_stats: bool = False
    n_steps: int = 1
    constrained: bool = False
    kind: str = "decode"
    k: int = 0


@dataclasses.dataclass
class DecodeGraph:
    graph: "torch.cuda.CUDAGraph"
    # what the window returns, rewritten by each replay: a decode window's
    # (tokens, logprobs) [n_steps, B], a verify's ([K+2, B] i64,), a
    # rollout's ()
    outputs: tuple
    calls: CapturedCalls


class DecodeGraphs:
    """The graph cache of one engine, by ``WindowKey``. ``window(key)``
    runs one window eagerly and returns its outputs, a tuple of tensors."""

    def __init__(self, window: Callable, generator: torch.Generator, device: torch.device):
        self._window = window
        self.generator = generator
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)  # prime and capture run here
        self.graphs: dict[WindowKey, DecodeGraph] = {}
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def __contains__(self, key: WindowKey) -> bool:
        return key in self.graphs

    def prime(self, keys) -> None:
        """Run each key's window once eagerly on the capture stream. Only on
        an idle batch: every slot inactive, so nothing but the generator
        moves."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for key in keys:
                self._window(key)
        cur.wait_stream(self.stream)

    def ready_thread(self) -> None:
        """Ready the calling thread for captures: cuBLAS keeps a handle (and
        a workspace a stream) per thread, and neither can be created inside
        a capture. One small product of each kind on the capture stream
        creates them; no state of the engine is touched."""
        with torch.cuda.stream(self.stream):
            for dtype in (torch.bfloat16, torch.float32):
                a = torch.ones((16, 16), dtype=dtype, device=self.device)
                torch.nn.functional.linear(a @ a, a, a[0])
        self.stream.synchronize()

    def capture(self, key: WindowKey) -> DecodeGraph:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        try:
            with CapturedCalls() as calls:
                with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                      capture_error_mode="global"):
                    outputs = self._window(key)
        except Exception as e:
            raise RuntimeError(f"capture of the decode graph {key} failed") from e
        entry = DecodeGraph(graph, tuple(outputs), calls)
        self.graphs[key] = entry
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return entry

    def replay(self, key: WindowKey):
        """Launch the key's window (capturing it first if it is new) on the
        current stream; returns its static outputs (a decode window's
        (tokens, logprobs) ``[n, B]``)."""
        entry = self.graphs.get(key) or self.capture(key)
        entry.graph.replay()
        entry.calls.replay()
        self.replays += 1
        return entry.outputs

    def pool_bytes(self) -> int:
        """Device bytes the shared pool's segments reserve."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class Readback:
    """One pinned host buffer for a window's ``[n, B]`` tokens and
    logprobs, and the event that says its copy has landed. The engine keeps
    two: one for the window in flight, one for the window it resolves. On
    the CPU the buffers are plain and the copy is done when it returns."""

    def __init__(self, batch: int, device: torch.device):
        self.batch, self.pin = batch, device.type == "cuda"
        self.tokens = self.logprobs = None
        self.event = torch.cuda.Event() if self.pin else None
        self.n = 0
        self.need_stats = False

    def start(self, tokens: torch.Tensor, logprobs: torch.Tensor, need_stats: bool) -> None:
        """Queue the copy of a window's outputs behind the window itself.
        The buffer grows to the longest window it has held."""
        self.n, self.need_stats = tokens.shape[0], need_stats
        if self.tokens is None or self.tokens.shape[0] < self.n:
            shape = (self.n, self.batch)
            self.tokens = torch.zeros(shape, dtype=torch.int64, pin_memory=self.pin)
            self.logprobs = torch.zeros(shape, dtype=torch.float32, pin_memory=self.pin)
        self.tokens[: self.n].copy_(tokens, non_blocking=True)
        if need_stats:
            self.logprobs[: self.n].copy_(logprobs, non_blocking=True)
        if self.event is not None:
            self.event.record()

    def wait(self):
        """(tokens, logprobs or None) as ``[n][B]`` lists, once landed."""
        if self.event is not None:
            self.event.synchronize()
        toks = self.tokens[: self.n].tolist()
        return toks, self.logprobs[: self.n].tolist() if self.need_stats else None
