"""The continuous-batching engine: host loop + device steps.

Port of ``rtp_llm_tpu/engine/engine.py::LlmEngine``, trimmed to the main
path. Each step schedules streams and prefills the new ones with prefix
reuse, every forward at the real length of its tokens (no bucket):

* packed and pipelined (JAX ``_run_prefills_packed``): new streams whose
  non-reused prompt fits the largest prefill bucket go in groups of at most
  ``PREFILL_PACK`` streams and that many real tokens. A group's forward and
  batched first-token sample are dispatched in one step; its tokens come
  back through a pinned buffer and the streams enter decode slots in the
  next step (or the next one that admits nothing), under the device's work;
* single: a longer prompt (in chunks of the largest bucket), a preemption
  recompute, or a lone stream with no group pending, finished at once.

Then one decode window runs over the fixed decode batch: ``decode_steps``
fused decode+sample bodies (one when a row is near ``max_seq_len``), read
back as ``[n, B]`` tokens through a pinned buffer. On the card a window is a
replayed CUDA graph (``decode_graphs.py``); on the CPU it runs eagerly. With
``async_decode`` the window is dispatched before the previous one is read
back, so the host's stop checks run under it. The prefill path reads nothing
back synchronously and copies to the device only from pinned memory, so its
dispatch never waits for a window in flight.

Request controls, as the JAX engine serves them. Every window reads each
slot's logit-bias row and forced token from the decode state (a think budget
that is spent forces its end token, once: the body clears the forcing after
applying it). Think budgets, n-gram bans and a trie (``tree_decode_config_path``)
turn multi-step windows off; a step with n-gram bans or a trie resolves the
window in flight and runs one synchronous step whose ban and allow rows lie
in fixed device buffers (the ``constrained`` graphs). ``generate_with_hidden``
and ``compute_prompt_loss`` are teacher-forced loops of one-stream prefills
on a private allocation.

Speculative decoding (``config.speculative``): prompt lookup on the host, a
draft model (``engine/draft.py``) or an EAGLE / EAGLE3 head
(``engine/eagle.py``) proposes K tokens a stream, and one verify window runs
the target at T = K+1 over ``[pending token, drafts]`` and accepts the
drafts that equal its own argmax. The verify (and a draft's or EAGLE's
rollout) is a replayed graph beside the decode windows. A step speculates
only when every active stream decodes greedily with nothing the verify
cannot apply at every position: no penalties, logprobs, logit bias, think
budget, n-gram bans or trie, and no end of an EOS ban inside the window;
otherwise it takes the normal window. A speculative step is synchronous.

Beam search (``num_beams`` > 1, ``variable_num_beams``): a beam request is
prefilled alone and branches into beams that hold no decode slot
(``engine/beam.py`` keeps the host state). Every step runs each live group
once: one eager forward of its k rows at T = 1 (K1 attention, KV written
in-layer), ``log_softmax`` in f32 read back to the host, the top 2k
candidates, and the children's blocks: full blocks shared by reference, the
partial tail copied (``copy_blocks``) into a fresh block when a parent has
several children. The group ends with its best hypothesis in one chunk.

LoRA: adapters of a ``LoraManager`` (``lora/``) are packed into stacks the
forward indexes by each row's adapter id (``ops/lora.py``, kernel X4) on
every path: packed prefill, the decode and verify windows (the id is decode
state), the beam step and the teacher-forced loops. Adapters change the
stacks the graphs read, so ``refresh_lora_weights`` captures them again.
The prefix cache keys each block by its adapter too.

Split pools (gemma2: global layers on the paged pool, sliding layers on one
ring a decode slot, ``models/llama_family.py``), as the JAX engine serves
them: the rings hold what the prefix cache would share, so it is off; every
stream prefills alone, after it takes its decode slot (the ring is the
slot's); K/V are written in-layer (no deferred writes); beam requests are
refused (400) and a speculative config raises. The teacher-forced loops
borrow a free slot's ring while they run. The auto-sized pool leaves room
for the rings, int8 scales included: a slot's ring costs what ``window +
span`` tokens of every sliding layer cost, so such a model serves with
fewer slots.

Mixture-of-experts models (qwen2_moe, qwen3_moe, mixtral) serve through the
same paths: the expert layer is a function of the token rows that reads
nothing back to the host, so the decode and verify windows capture it. Beam
search serves them as it serves a dense trunk; LoRA adapters are refused
(``refresh_lora_weights``, before the weights change). The KV pool's
auto-size reads the device memory left after the weights, the expert stacks
included.

Not ported (see ROADMAP.md): MTP (it needs the DeepSeek model), the host KV
tier, multimodal inputs and EPLB.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
import time
from typing import List, Optional, Union

import numpy as np
import torch

from rtp_llm_tpu_torch.cache.kv_cache_manager import KVCacheManager, adapter_salt
from rtp_llm_tpu_torch.config.engine_config import EngineConfig
from rtp_llm_tpu_torch.config.generate_config import GenerateConfig
from rtp_llm_tpu_torch.device import resolve_device
from rtp_llm_tpu_torch.engine.beam import Beam, BeamGroup
from rtp_llm_tpu_torch.engine.decode_graphs import DecodeGraphs, Readback, WindowKey
from rtp_llm_tpu_torch.engine.device_state import (
    MAX_LOGIT_BIAS, DecodeState, params_row_from_config,
)
from rtp_llm_tpu_torch.engine.draft import DraftRunner
from rtp_llm_tpu_torch.engine.eagle import EagleRunner
from rtp_llm_tpu_torch.engine.logits_processors import (
    MAX_ALLOW, TreeDecodeConfig, TreeDecodeState,
)
from rtp_llm_tpu_torch.engine.scheduler import FIFOScheduler
from rtp_llm_tpu_torch.engine.speculative import greedy_verify, propose_prompt_lookup
from rtp_llm_tpu_torch.engine.stream import FinishReason, GenerateStream, StreamState
from rtp_llm_tpu_torch.models.batch import ModelInputs, upload
from rtp_llm_tpu_torch.models.llama_family import torch_dtype
from rtp_llm_tpu_torch.ops import lora as lora_ops
from rtp_llm_tpu_torch.ops.kv_cache import quantize_kv, storage_view, token_slots
from rtp_llm_tpu_torch.ops.sampling import NEG_INF, SamplingParams, eos_ban_row, sample_tokens
from rtp_llm_tpu_torch.utils.metrics import METRICS

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PrefillGroup:
    """A prefill group dispatched and not yet finished: its streams, the
    allocation each held at dispatch, the first tokens' readback and what
    slot insertion writes (per row)."""

    streams: List[GenerateStream]
    allocs: list
    readback: Readback
    params_rows: List[dict]
    prompt_masks: torch.Tensor  # [n, V] bool
    block_tables: torch.Tensor  # [n, max_blocks] int32
    bias: Optional[tuple]  # ([n, MAX_LOGIT_BIAS] ids, vals) or None


def split_pool_unheld(cfg, weights: dict) -> Optional[str]:
    """What of a split-pool model's weights no test holds against the JAX
    package, or None. Held on the CPU (``tests/test_torch_gemma.py``): bf16
    / f32 weights, int8 / int4 / fp4 weight-only and W8A8 quantized at load,
    dynamic LoRA. Not held: fp8 weights (the JAX engine cannot fuse their
    per-tensor scales), W4A8 (its greedy tokens part from the JAX engine's
    at a near tie) and pre-quantized checkpoints."""
    if cfg.quantization:
        return f"a pre-quantized {cfg.quantization['method']} checkpoint"
    if any(k.endswith(".w4a8") for k in weights):
        return "W4A8 weights"
    if any(isinstance(t, torch.Tensor) and t.dtype == torch.float8_e4m3fn
           for t in weights.values()):
        return "fp8 weights"
    return None


class LlmEngine:
    PREFILL_PACK = 4  # streams a packed prefill group holds at most
    MAX_NGRAM_BANS = 16  # per-row cap on no-repeat-ngram banned tokens

    def __init__(self, model, weights: dict, config: EngineConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 draft=None, eagle: Optional[dict] = None):
        """``draft``: (draft model, its weights) for ``speculative.method``
        "vanilla"; ``eagle``: the EAGLE / EAGLE3 head's weights
        (``loader.load_eagle_weights``) for "eagle"."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on {self.device}")
        self.model = model
        n_pos = model.cfg.max_position_embeddings
        if not model.cfg.use_alibi and config.scheduler.max_seq_len > n_pos:
            # a position table (learned positions, gpt_bigcode; RoPE's cos /
            # sin rows, e.g. Phi-2's 2048): no position past it is served,
            # where the gather would fault the card; a longer prompt is
            # refused as any past max_seq_len, a stream stops there (ROADMAP
            # C: the JAX package clamps the position to the table's last row)
            config = dataclasses.replace(config, scheduler=dataclasses.replace(
                config.scheduler, max_seq_len=n_pos))
        self.config = config
        model.gemm_variant = "pipe" if config.kernel.int4_pipeline else "base"
        fused = model.fuse_weights(weights)
        # sync the caller's dict in place so it does not pin the unfused
        # q/k/v and gate/up tensors alive next to the fused ones
        weights.clear()
        weights.update(fused)
        self.weights = weights
        mc, sc, cc = model.cfg, config.scheduler, config.cache

        self.block_size = cc.block_size
        # split pools (module docstring): the rings are sized by the largest
        # prefill chunk, which a query reaches back a window from
        self.swa_split = bool(getattr(model, "swa_split", False))
        if self.swa_split:
            if config.speculative.enabled:
                raise ValueError("speculative decoding is not wired for mixed global / "
                                 "sliding-window pool models (their rings are per slot)")
            unheld = split_pool_unheld(model.cfg, weights)
            if unheld:
                raise ValueError(f"{unheld} on a mixed global / sliding-window pool model is "
                                 "not held against the JAX package yet (ROADMAP A10)")
            model.swa_prefill_span = max(sc.prefill_buckets)
        self.num_blocks = cc.num_blocks or self._auto_size_blocks()
        self.max_blocks_per_seq = math.ceil(sc.max_seq_len / cc.block_size)
        # sliding-window block recycling (the JAX gate): a model whose every
        # layer has one window, with swa_recycle or the prefix cache off;
        # prefix reuse is then off. A draft model or an EAGLE head reads the
        # target's block tables through its own attention, which may have no
        # window: those engines do not recycle.
        recycle = (mc.sliding_window if mc.sliding_window and not mc.sliding_window_pattern
                   and config.speculative.method not in ("vanilla", "eagle")
                   and (cc.swa_recycle or not cc.enable_prefix_cache) else 0)
        self.cache_mgr = KVCacheManager(
            self.num_blocks, cc.block_size,
            enable_prefix_cache=cc.enable_prefix_cache and not recycle and not self.swa_split,
            sliding_window_tokens=recycle)
        self.scheduler = FIFOScheduler(sc, self.cache_mgr)
        self.scheduler.rope_switch = getattr(model, "rope_switch", 0)
        self.kv = model.init_cache(self.num_blocks, cc.block_size,
                                   torch_dtype(config.quant.kv_cache_dtype),
                                   **(dict(max_slots=sc.max_batch_size) if self.swa_split else {}))
        # deferred decode KV writes: one batched scatter a step instead of 2
        # a layer (int8: one quantization of all layers' rows, then one data
        # and one scale scatter, instead of a quantize + 4 scatters a layer)
        self._defer_decode = bool(sc.defer_kv_writes
                                  and getattr(model, "supports_deferred_kv", False))
        self.state = DecodeState.init(sc.max_batch_size, self.max_blocks_per_seq,
                                      mc.vocab_size, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.eos_ids = tuple(mc.eos_token_ids)
        self._ban_row = eos_ban_row(self.eos_ids, mc.vocab_size, self.device)
        self.tree_config = (TreeDecodeConfig.from_file(config.tree_decode_config_path)
                            if config.tree_decode_config_path else None)
        if self.tree_config is not None:
            tc = self.tree_config
            self._check_ids("the trie", [tc.start_token_id, tc.end_token_id]
                            + [t for ids in tc.prefix_dict.values() for t in ids])
        # the rows a constrained window reads (n-gram bans, trie allow-lists),
        # rewritten before each such window
        self._ban_buf = torch.full((sc.max_batch_size, self.MAX_NGRAM_BANS), -1,
                                   dtype=torch.int64, device=self.device)
        self._allow_buf = torch.full((sc.max_batch_size, MAX_ALLOW), -1,
                                     dtype=torch.int64, device=self.device)
        self._init_speculative(draft, eagle)

        # slot bookkeeping
        self.slots: List[Optional[GenerateStream]] = [None] * sc.max_batch_size
        self._free_slots = list(range(sc.max_batch_size - 1, -1, -1))
        self._slot_nblocks = [0] * sc.max_batch_size  # detect allocation growth
        self._slot_ban = [False] * sc.max_batch_size
        self._slot_forced = [-1] * sc.max_batch_size  # last forcing written a slot

        # block-table width buckets for decode: the table passed to the step
        # tracks the batch's deepest row instead of max_seq_len
        buckets, b_ = [], 8
        while b_ < self.max_blocks_per_seq:
            buckets.append(b_)
            b_ *= 2
        buckets.append(self.max_blocks_per_seq)
        self._kv_buckets = buckets

        # prefill groups dispatched and not yet finished
        self._prefill_pending: List[PrefillGroup] = []
        # decode windows: the one in flight (async) and its readback buffers
        self._pending = None  # (Readback, streams)
        self._readbacks = [Readback(sc.max_batch_size, self.device) for _ in range(2)]
        self._next_readback = 0
        # the WindowKeys that warmup() readied and that dispatch used
        self.warm_keys: set = set()
        self.decode_keys: set = set()
        self._warmup_thread: Optional[threading.Thread] = None
        # what failed the background captures, if one did (the engine is
        # then unhealthy: ``wait_warmup_complete`` raises it)
        self.warmup_error: Optional[BaseException] = None
        # on the card every window is a replayed graph; chip_smoke.py sets
        # this to hold the graphs against the eager window
        self._eager_decode = self.device.type != "cuda"
        self._graphs = None
        if self.device.type == "cuda":
            self._graphs = DecodeGraphs(self._window, self.generator, self.device)
            # every sampler variant and the speculative windows once, eagerly,
            # while no slot is active
            self._graphs.prime([WindowKey(buckets[0], ns, st, 1, c) for ns in (False, True)
                                for st in (False, True) for c in (False, True)]
                               + self._spec_keys(buckets[0]))

        self.step_count = 0
        self.tokens_generated = 0
        # one thread steps the engine; enqueue from other threads takes it too
        self.device_lock = threading.Lock()
        # beam search: the live groups, and over their steps: steps, rows
        # forwarded, host seconds (forward, readback and selection)
        self._beam_groups: List[BeamGroup] = []
        self.beam_stats = dict(steps=0, rows=0, seconds=0.0)
        # dynamic LoRA: the registry, and the adapters packed at the last
        # refresh by name: (id, prefix-cache salt)
        self.lora_manager = None
        self._lora: dict = {}

    def _block_bytes(self, layers: int) -> int:
        """Device bytes of one block of ``layers`` layers: K and V data at the
        pool's element size, plus, for int8, one bf16 scale per (slot, kv
        head) for each. (The JAX package sizes an int8 pool by its data
        alone, which overruns the budget by 2 / head_dim.)"""
        cc, mc = self.config.cache, self.model.cfg
        dtype = torch_dtype(self.config.quant.kv_cache_dtype)
        per_head = mc.head_dim * dtype.itemsize + (2 if dtype == torch.int8 else 0)
        return 2 * layers * cc.block_size * mc.num_kv_heads * per_head

    def kv_block_bytes(self) -> int:
        """Device bytes one block of the paged pool takes over its layers
        (a split model's global layers only)."""
        model = self.model
        return self._block_bytes(len(model._full_pos) if model.swa_split
                                 else model.cfg.num_layers)

    def ring_bytes(self) -> tuple:
        """(bytes of one decode slot's rings, of the ring pool's null block)
        of a split model, over its sliding layers; (0, 0) otherwise. The
        ring pool takes ``max_batch_size`` times the first plus the second."""
        if not self.model.swa_split:
            return 0, 0
        block = self._block_bytes(len(self.model._swa_pos))
        return self.model.ring_blocks(self.config.cache.block_size) * block, block

    def _auto_size_blocks(self) -> int:
        """Size the KV pool from free device memory after the weights: what
        they take is read from the device, so 8- and 4-bit weights leave
        the pool what their real bytes leave. A split model's rings come off
        the budget first; if they leave no room for the smallest pool it
        raises, naming the bytes and the slots that would fit."""
        cc = self.config.cache
        if self.device.type == "cuda":
            # hand cached blocks back first: what loading freed (unfused
            # members, the float originals of load-time quantization) would
            # otherwise still count as used
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info(self.device)
            budget = (free - (1.0 - cc.memory_utilization) * total
                      - cc.reserve_runtime_mem_mb * (1 << 20))
        else:
            budget = 256 << 20  # keep the CPU pool small
        per_block = self.kv_block_bytes()
        per_slot, null = self.ring_bytes()
        rings = per_slot * self.config.scheduler.max_batch_size + null
        if per_slot and budget - rings < 16 * per_block:
            fit = max(0, int((budget - 16 * per_block - null) // per_slot))
            raise ValueError(
                f"the sliding-window rings of {self.config.scheduler.max_batch_size} decode "
                f"slots take {rings} bytes of a {int(budget)}-byte KV budget and leave no "
                f"room for the paged pool; at most {fit} slots fit (--max-batch-size)")
        budget -= rings
        n = max(16, int(budget // per_block))
        logger.info("auto-sized KV pool: %d blocks (%.1f MiB)", n, n * per_block / 2**20)
        return n

    # ---- device steps ----

    def _decode_step(self, kv_blocks: int, need_sampling: bool, need_stats: bool,
                     constrained: bool = False):
        """One fused decode+sample body over the whole decode batch; updates
        the device state in place. Returns device tensors (tokens, logprobs).
        Every body applies the slots' logit bias and forcing, then clears the
        forcing; a ``constrained`` one also the ban and allow rows. Nothing
        here reads a device value back: it is captured as it runs."""
        st = self.state
        active = st.kv_lens > 0
        kv_lens_new = torch.where(active, st.kv_lens + 1, 0)
        inputs = ModelInputs(
            tokens=st.last_tokens[:, None],
            positions=torch.where(active, st.kv_lens, 0)[:, None],
            block_tables=st.block_tables[:, :kv_blocks],
            kv_lens=kv_lens_new,
            q_offsets=st.kv_lens,
            adapter_ids=st.adapter_ids,
        )
        out, self.kv = self.model.forward(self.weights, self.kv, inputs,
                                          defer_kv_writes=self._defer_decode)
        if self._defer_decode:
            self._apply_kv_writes(out.kv_writes, st.kv_lens, inputs.block_tables, active)
        tokens, logprobs = sample_tokens(
            out.logits, st.params, st.prompt_mask, st.output_counts, self.eos_ids,
            self.generator, need_sampling=need_sampling, active=active,
            need_stats=need_stats, ban_row=self._ban_row,
            forced_tokens=st.forced_tokens, bias_ids=st.bias_ids, bias_vals=st.bias_vals,
            ban_tokens=self._ban_buf if constrained else None,
            allow_tokens=self._allow_buf if constrained else None)
        tokens = torch.where(active, tokens, st.last_tokens)
        st.last_tokens.copy_(tokens)
        st.kv_lens.copy_(kv_lens_new)
        st.clear_forced()
        return tokens, logprobs

    def _decode_window(self, kv_blocks: int, need_sampling: bool, need_stats: bool,
                       n_steps: int, constrained: bool = False):
        """``n_steps`` decode bodies, tokens and logprobs stacked ``[n, B]``
        (JAX ``_decode_multi_impl``: a scan over the same body)."""
        outs = [self._decode_step(kv_blocks, need_sampling, need_stats, constrained)
                for _ in range(n_steps)]
        return torch.stack([t for t, _ in outs]), torch.stack([lp for _, lp in outs])

    def _window(self, key: WindowKey):
        """Run the window ``key`` names eagerly: a decode window, the
        verify, or a proposer's rollout (whose drafts land in
        ``_draft_buf``; it returns nothing)."""
        if key.kind == "decode":
            return self._decode_window(*key[:5])
        if key.kind == "verify":
            return self._verify_window(key.kv_blocks, key.k)
        runner = self.draft if key.kind == "vanilla" else self.eagle
        runner.rollout(self.state, key.kv_blocks, key.k, self._draft_buf)
        return ()

    def _dispatch(self, key: WindowKey):
        """Launch one window: a graph replay on the card, eager on the CPU."""
        self.decode_keys.add(key)
        if self._eager_decode:
            return self._window(key)
        return self._graphs.replay(key)

    def _apply_kv_writes(self, kv_writes, kv_lens, block_tables, active) -> None:
        """Write every layer's deferred K/V rows ``([L, B, HD], [L, B, HD])``
        into the pool in one batched scatter, at position ``kv_lens`` (the
        length before this step) of each active row. An int8 pool quantizes
        all layers' rows together, then one data and one scale scatter."""
        kw, vw = kv_writes
        slots = token_slots(torch.where(active, kv_lens, 0)[:, None], block_tables,
                            self.block_size, active[:, None]).reshape(-1)  # [B]
        if not isinstance(self.kv, dict):
            self._scatter_flat(self.kv, kw, vw, slots)
            return
        l, b, hd = kw.shape
        hkv = self.kv["scale"].shape[-1]
        kq, ks, vq, vs = quantize_kv(kw.reshape(l * b, hkv, hd // hkv),
                                     vw.reshape(l * b, hkv, hd // hkv))
        self._scatter_flat(self.kv["data"], kq.reshape(l, b, hd), vq.reshape(l, b, hd), slots)
        self._scatter_flat(self.kv["scale"], ks.reshape(l, b, hkv), vs.reshape(l, b, hkv), slots)

    @staticmethod
    def _scatter_flat(pool, kw, vw, slots) -> None:
        """One scatter of per-layer K and V rows ``[L, B, C]`` into the
        ``[L, 2, NS, C]`` pool through its flat ``[L*2*NS, C]`` view, in
        place. Index math is int64. Out-of-range slots are masked as
        ``write_kv`` masks them: redirected to slot 0 of their plane, which
        is rewritten with its own contents."""
        l, _, ns, c = pool.shape
        valid = (slots >= 0) & (slots < ns)
        safe = torch.where(valid, slots, torch.zeros_like(slots))[None, :]  # [1, B]
        base = torch.arange(l, device=pool.device)[:, None] * (2 * ns)  # [L, 1]
        idx = torch.cat([(base + safe).reshape(-1), (base + ns + safe).reshape(-1)])
        rows = storage_view(torch.cat([kw.reshape(-1, c), vw.reshape(-1, c)]).to(pool.dtype))
        flat = storage_view(pool).view(l * 2 * ns, c)
        flat[idx] = torch.where(valid.repeat(2 * l)[:, None], rows, flat[idx])

    # ---- speculative decoding ----

    def _init_speculative(self, draft, eagle) -> None:
        """The proposer of ``config.speculative`` and the verify's draft
        buffer ``[B, K]`` (the static operand every verify graph reads)."""
        sp, sc = self.config.speculative, self.config.scheduler
        self.spec = sp
        self.draft = self.eagle = None
        self._draft_buf = None
        self._eagle_seed = None  # the last single prefill's feature row
        # counted over speculative steps: verify windows, active rows they
        # ran, tokens they emitted, host seconds proposing and verifying
        self.spec_stats = dict(steps=0, rows=0, tokens=0, propose_s=0.0, verify_s=0.0)
        if not sp.enabled:
            return
        if sp.method == "vanilla":
            if draft is None:
                raise ValueError("speculative method 'vanilla' needs a draft model")
            dmodel, dweights = draft
            if dmodel.device != self.device:
                raise ValueError(f"draft model on {dmodel.device}, engine on {self.device}")
            self.draft = DraftRunner(dmodel, dweights, self.num_blocks, self.block_size,
                                     self.model.cfg.vocab_size)
        elif sp.method == "eagle":
            if eagle is None:
                raise ValueError("speculative method 'eagle' needs an EAGLE head")
            self.eagle = EagleRunner(self.model, self.weights, eagle, self.num_blocks,
                                     self.block_size, sc.max_batch_size)
        self._draft_buf = torch.zeros((sc.max_batch_size, sp.draft_tokens), dtype=torch.int64,
                                      device=self.device)

    def _spec_keys(self, kv_blocks: int) -> list:
        """The speculative windows of one kv bucket: the proposer's rollout
        (a draft model or EAGLE; prompt lookup proposes on the host), then
        the verify."""
        if not self.spec.enabled:
            return []
        kinds = (("verify",) if self.spec.method == "prompt_lookup"
                 else (self.spec.method, "verify"))
        return [WindowKey(kv_blocks, kind=kind, k=self.spec.draft_tokens) for kind in kinds]

    def _features(self) -> dict:
        """The forward arguments that return what an EAGLE head reads as
        ``all_hidden``: the final-normed rows (EAGLE) or the captured
        layers' outputs (EAGLE3). Only the verify and the prefill pass
        them: every other forward of the model keeps the final-normed rows."""
        if self.eagle is None:
            return {}
        cap = self.eagle.capture_layers
        return dict(need_all_hidden=not cap, capture_layers=cap)

    def _spec_eligible(self, active) -> bool:
        """Whether this step speculates: the JAX gate (greedy streams, no
        think budget, n-gram bans or trie, room for K+1 more tokens) and
        nothing the verify cannot apply at each of its positions exactly as
        the decode window would: penalties and logprobs (the JAX verify
        applies pre-step counts and returns no logprobs), a logit bias (it
        applies none), or an EOS ban that ends inside the window (it bans at
        every position what the first may not emit)."""
        if not self.spec.enabled or self.tree_config is not None:
            return False
        k, msl = self.spec.draft_tokens, self.config.scheduler.max_seq_len
        for s in active:
            c, n_out = s.config, len(s.output_token_ids)
            if (c.do_sample or c.max_thinking_tokens or c.no_repeat_ngram_size
                    or s.total_len + k + 1 > msl
                    or c.repetition_penalty != 1.0 or c.presence_penalty != 0.0
                    or c.frequency_penalty != 0.0 or c.return_logprobs or c.top_logprobs
                    or c.logit_bias
                    or (not c.ignore_eos and n_out < c.min_new_tokens <= n_out + k)):
                return False
        return True

    def _verify_inputs(self, kv_blocks: int, k: int) -> ModelInputs:
        """The padded ``[B, K+1]`` forward over each slot's pending token and
        its drafts, at positions kv_len .. kv_len + K (inactive rows: kv_len
        0, masked everywhere)."""
        st = self.state
        active = st.kv_lens > 0
        offs = torch.arange(k + 1, device=self.device)[None, :]
        return ModelInputs(
            tokens=torch.cat([st.last_tokens[:, None], self._draft_buf], dim=1),
            positions=torch.where(active[:, None], st.kv_lens[:, None] + offs, 0),
            block_tables=st.block_tables[:, :kv_blocks],
            kv_lens=torch.where(active, st.kv_lens + (k + 1), 0),
            q_offsets=st.kv_lens, adapter_ids=st.adapter_ids)

    def _verify_logits(self, kv_blocks: int, k: int):
        """The target's forward over the verify window, K/V written in-layer
        at all K+1 positions (a deferred-write engine too: those writes are a
        T = 1 mode, and ``quantize_kv`` gives the in-layer rows the scales
        the deferred writer would): (logits ``[B, K+1, V]`` f32 with the EOS
        ban applied, the features ``all_hidden`` when an EAGLE head reads
        them, else None)."""
        b = self.state.kv_lens.shape[0]
        out, self.kv = self.model.forward(self.weights, self.kv,
                                          self._verify_inputs(kv_blocks, k),
                                          need_all_logits=True, **self._features())
        logits = out.all_logits.view(b, k + 1, -1)
        ban = self.state.params.ban_eos[:, None, None] & self._ban_row[None, None, :]
        return logits.masked_fill(ban, NEG_INF), out.all_hidden

    def _verify_window(self, kv_blocks: int, k: int):
        """One verify: greedy acceptance of the drafts in ``_draft_buf``,
        the decode state advanced by each row's emitted tokens (last token,
        length, output counts) and an EAGLE head's features refreshed.
        Returns ``([K+2, B] int64,)``: the greedy tokens by position, then
        each row's emitted count. Nothing is read back here."""
        st = self.state
        active = st.kv_lens > 0
        logits, hidden = self._verify_logits(kv_blocks, k)
        g, n_new = greedy_verify(logits, self._draft_buf)  # [B, T], [B]
        n_new = torch.where(active, n_new, 0)
        emitted = torch.arange(k + 1, device=self.device)[None, :] < n_new[:, None]
        st.output_counts.scatter_add_(1, g, emitted.to(st.output_counts.dtype))
        at = (n_new - 1).clamp(0, k)
        st.last_tokens.copy_(torch.where(active, g.gather(1, at[:, None])[:, 0],
                                         st.last_tokens))
        st.kv_lens.copy_(torch.where(active, st.kv_lens + n_new.to(st.kv_lens.dtype), 0))
        if self.eagle is not None:
            feat = hidden.view(g.shape[0], k + 1, -1)
            self.eagle.update_hidden(
                feat.gather(1, at[:, None, None].expand(-1, 1, feat.shape[-1]))[:, 0], active)
        return (torch.cat([g.T, n_new[None]]),)

    def _spec_step(self, active) -> None:
        """Propose, verify, read back, and append each stream's emitted
        tokens one at a time until a stop fires (the rest are dropped:
        their KV rows lie past the accepted length)."""
        k = self.spec.draft_tokens
        *rollout, verify = self._spec_keys(self._kv_bucket(active, k))
        t0 = time.perf_counter()
        if not rollout:
            host = torch.zeros((len(self.slots), k), dtype=torch.int64)
            sp = self.spec
            for s in active:
                # all_token_ids ends with the pending token: drafts follow it
                host[s.slot] = torch.tensor(propose_prompt_lookup(
                    s.all_token_ids, k, sp.ngram_min, sp.ngram_max))
            self._draft_buf.copy_(upload(host, self.device))
        else:
            self._dispatch(rollout[0])
        switch = self.scheduler.rope_switch
        for s in active:  # a window past the switch turns its keys by the long table
            if s.rope_keep is not None and s.total_len + k > switch:
                s.rope_keep = min(s.rope_keep, s.total_len - 1)
        t1 = time.perf_counter()
        (out,) = self._dispatch(verify)
        readback = self._readbacks[self._next_readback]
        self._next_readback ^= 1
        readback.start(out, None, need_stats=False)
        rows, _ = readback.wait()
        st = self.spec_stats
        st["propose_s"] += t1 - t0
        st["verify_s"] += time.perf_counter() - t1
        st["steps"] += 1
        st["rows"] += len(active)
        msl = self.config.scheduler.max_seq_len
        total, generated = 0, self.tokens_generated
        for s in active:
            n = rows[k + 1][s.slot]
            total += n
            for j in range(n):
                self.tokens_generated += 1
                if s.append_token(rows[j][s.slot], self.eos_ids, 0.0, max_seq_len=msl):
                    self._release_stream(s)
                    break
        st["tokens"] += total
        METRICS.inc("engine.tokens_generated", self.tokens_generated - generated)
        METRICS.observe("engine.spec_accepted", total / len(active) - 1)

    # ---- prefill ----

    def _block_rows(self, rows: list) -> torch.Tensor:
        """``[len(rows), max_blocks]`` block-table rows on the device."""
        host = torch.zeros((len(rows), self.max_blocks_per_seq), dtype=torch.int32)
        for r, blocks in enumerate(rows):
            host[r, : len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
        return upload(host, self.device)

    def _block_row(self, blocks: list) -> torch.Tensor:
        return self._block_rows([blocks])[0]

    def _prefill_inputs(self, rows, block_tables: torch.Tensor,
                        adapter_ids=None, state_slots=None) -> ModelInputs:
        """Packed inputs of one prefill forward, every row at its real
        length: ``rows`` holds (token ids, q_offset) a row, ``adapter_ids``
        each row's LoRA adapter (None: no adapter anywhere), ``state_slots``
        each row's decode slot (a split model's rings; None: row r is slot
        r). One upload."""
        lens = [len(toks) for toks, _ in rows]
        n, b = sum(lens), len(rows)
        host = torch.empty(2 * n + 4 * b, dtype=torch.int64)
        host[:n] = torch.tensor([t for toks, _ in rows for t in toks])
        host[n: 2 * n] = torch.cat([torch.arange(off, off + len(toks)) for toks, off in rows])
        host[2 * n: 2 * n + b] = torch.tensor([off + len(toks) for toks, off in rows])
        host[2 * n + b: 2 * n + 2 * b] = torch.tensor([off for _, off in rows])
        host[2 * n + 2 * b: 2 * n + 3 * b] = torch.tensor(adapter_ids or [0] * b)
        host[2 * n + 3 * b:] = torch.tensor(state_slots if state_slots is not None else range(b))
        dev = upload(host, self.device)
        return ModelInputs(tokens=dev[:n], positions=dev[n: 2 * n], block_tables=block_tables,
                           kv_lens=dev[2 * n: 2 * n + b], q_offsets=dev[2 * n + b: 2 * n + 2 * b],
                           row_lens=tuple(lens),
                           adapter_ids=(dev[2 * n + 2 * b: 2 * n + 3 * b]
                                        if any(adapter_ids or ()) else None),
                           state_slots=dev[2 * n + 3 * b:] if state_slots is not None else None)

    def _whole(self, inputs: ModelInputs, length: int) -> ModelInputs:
        """A chunk's inputs with every row's RoPE table picked by the whole
        context's ``length`` (longrope: as one forward of it would)."""
        if not self.scheduler.rope_switch:
            return inputs
        return inputs._replace(rope_lens=torch.full_like(inputs.kv_lens, length))

    def _prefill_forward(self, stream: GenerateStream, block_row: torch.Tensor):
        """Prefill of the stream's non-reused context in chunks of the
        largest prefill bucket, each at its real length; returns the last
        chunk's logits [1, V]. With an EAGLE head every chunk also returns
        its features, which prefill the head's layer; the last position's
        seeds the slot (``_eagle_seed``)."""
        prompt = stream.context_token_ids
        chunk = self.config.scheduler.prefill_buckets[-1]
        slots = [stream.slot] if self.swa_split else None  # taken before the prefill
        logits, feats = None, []
        for pos in range(stream.reuse_len, len(prompt), chunk):
            inputs = self._whole(self._prefill_inputs([(prompt[pos: pos + chunk], pos)],
                                                      block_row[None], [stream.adapter_id],
                                                      slots), len(prompt))
            out, self.kv = self.model.forward(self.weights, self.kv, inputs, **self._features())
            logits = out.logits
            if self.eagle is not None:
                feats.append((pos, out.all_hidden))
        if feats:
            self.eagle.prefill(prompt, feats, block_row)
            self._eagle_seed = feats[-1][1][-1]
        return logits

    def _prompt_masks(self, token_lists) -> torch.Tensor:
        """``[n, V]`` bool on the device, True at each list's tokens."""
        host = torch.zeros((len(token_lists), self.model.cfg.vocab_size), dtype=torch.bool)
        for r, ids in enumerate(token_lists):
            host[r, torch.tensor(ids, dtype=torch.int64)] = True
        return upload(host, self.device)

    def _sampling_params(self, rows: List[dict]) -> SamplingParams:
        """Per-row sampling params ``[n]`` on the device, in one upload."""
        fields = SamplingParams._fields
        host = torch.tensor([[float(r[f]) for r in rows] for f in fields], dtype=torch.float32)
        dev = upload(host, self.device)
        return SamplingParams(*(dev[i].to(getattr(self.state.params, f).dtype)
                                for i, f in enumerate(fields)))

    def _take_slot(self, stream: GenerateStream, ban: bool) -> int:
        """The stream's decode slot: the one it took before its prefill (a
        split model's, ``_run_prefill``), else a free one."""
        slot = stream.slot if stream.slot >= 0 else self._free_slots.pop()
        stream.slot = slot
        self.slots[slot] = stream
        self._slot_nblocks[slot] = len(stream.alloc.blocks)
        self._slot_ban[slot] = ban
        self._slot_forced[slot] = -1
        return slot

    @staticmethod
    def _ngram_bans(token_ids, n: int, cap: int) -> list:
        """Tokens that would complete an already-seen n-gram (HF
        ``no_repeat_ngram_size`` semantics), at most ``cap``."""
        if n <= 0 or len(token_ids) < n:
            return []
        tail = tuple(token_ids[-(n - 1):]) if n > 1 else ()
        seen, out = set(), []
        for i in range(len(token_ids) - n + 1):
            if tuple(token_ids[i: i + n - 1]) == tail:
                t = token_ids[i + n - 1]
                if t not in seen:
                    seen.add(t)
                    out.append(t)
        return out[:cap]

    def _id_rows(self, lists, width: int) -> torch.Tensor:
        """``[len(lists), width]`` int64 on the device, each list's ids
        first, ``-1`` after. One upload."""
        host = torch.full((len(lists), width), -1, dtype=torch.int64)
        for r, ids in enumerate(lists):
            if ids:
                host[r, : len(ids)] = torch.tensor(ids[:width], dtype=torch.int64)
        return upload(host, self.device)

    def _bias_rows(self, configs) -> Optional[tuple]:
        """``([n, MAX_LOGIT_BIAS] ids, vals)`` on the device for configs of
        which any sets ``logit_bias`` (its first MAX_LOGIT_BIAS entries);
        None if none does."""
        if not any(c.logit_bias for c in configs):
            return None
        items = [list((c.logit_bias or {}).items())[:MAX_LOGIT_BIAS] for c in configs]
        vals = torch.zeros((len(configs), MAX_LOGIT_BIAS), dtype=torch.float32)
        for r, row in enumerate(items):
            if row:
                vals[r, : len(row)] = torch.tensor([float(v) for _, v in row])
        return (self._id_rows([[int(t) for t, _ in row] for row in items], MAX_LOGIT_BIAS),
                upload(vals, self.device))

    def _sample_first(self, streams, logits: torch.Tensor, block_tables) -> PrefillGroup:
        """Batched first-token sampling with per-row params (prompt masks,
        zero output counts, the logit bias, the prompt's n-gram bans and the
        trie's allow-list), its readback started."""
        rows = [params_row_from_config(s.config, s.needs_eos_ban()) for s in streams]
        pmask = self._prompt_masks([s.prompt_token_ids for s in streams])
        counts = torch.zeros((len(streams), self.model.cfg.vocab_size), dtype=torch.int32,
                             device=self.device)
        bias = self._bias_rows([s.config for s in streams])
        kw = {}
        if bias is not None:
            kw.update(bias_ids=bias[0], bias_vals=bias[1])
        if any(s.config.no_repeat_ngram_size for s in streams):
            kw["ban_tokens"] = self._id_rows(
                [self._ngram_bans(s.prompt_token_ids, s.config.no_repeat_ngram_size,
                                  self.MAX_NGRAM_BANS) for s in streams], self.MAX_NGRAM_BANS)
        allows = [s.tree_state.allowed() if s.tree_state is not None else None for s in streams]
        if any(allows):
            kw["allow_tokens"] = self._id_rows(allows, MAX_ALLOW)
        tokens, logprobs = sample_tokens(
            logits, self._sampling_params(rows), pmask, counts, self.eos_ids, self.generator,
            need_sampling=any(s.config.do_sample for s in streams), ban_row=self._ban_row, **kw)
        readback = Readback(len(streams), self.device)
        readback.start(tokens[None], logprobs[None], need_stats=True)
        return PrefillGroup(list(streams), [s.alloc for s in streams], readback, rows, pmask,
                            block_tables, bias)

    def _dispatch_prefill_group(self, group) -> PrefillGroup:
        """One forward over the group's real tokens (no pad row reaches a
        linear; only attention's operand is padded to the longest row), then
        the first-token sample. Nothing here waits for the device."""
        bt = self._block_rows([s.alloc.blocks for s in group])
        inputs = self._prefill_inputs(
            [(s.prompt_token_ids[s.reuse_len:], s.reuse_len) for s in group], bt,
            [s.adapter_id for s in group])
        out, self.kv = self.model.forward(self.weights, self.kv, inputs)
        return self._sample_first(group, out.logits, bt)

    def _finish_prefill_group(self, g: PrefillGroup) -> None:
        """Read back a group's first tokens and insert its streams into
        decode slots. A stream aborted, or preempted (perhaps re-admitted
        under a new allocation), since dispatch is skipped and takes no
        slot: a preempted stream prefills again when it is re-admitted."""
        toks, lps = g.readback.wait()
        msl = self.config.scheduler.max_seq_len
        for r, s in enumerate(g.streams):
            if s.is_finished() or s.alloc is not g.allocs[r]:
                continue
            token, prow = toks[0][r], g.params_rows[r]
            slot = self._take_slot(s, prow["ban_eos"])
            row = self._shrunk_row(s, s.prompt_len + 1, g.block_tables[r])
            self.state.insert_slot(slot, token, s.prompt_len, row,
                                   g.prompt_masks[r], prow,
                                   bias_row=None if g.bias is None else (g.bias[0][r],
                                                                         g.bias[1][r]),
                                   adapter_id=s.adapter_id)
            self._prefill_proposer(s, slot, s.prompt_token_ids, row)
            if s.append_token(token, self.eos_ids, lps[0][r], max_seq_len=msl):
                self._release_stream(s)

    def _shrunk_row(self, stream: GenerateStream, total: int, row: torch.Tensor) -> torch.Tensor:
        """The table row a prefilled stream enters decode with: with
        recycling, its blocks wholly below the window are freed first
        (``KVCacheManager.shrink_sliding``) and the row is written anew."""
        if self.cache_mgr.shrink_sliding(stream.alloc, total):
            return self._block_row(stream.alloc.blocks)
        return row

    def _run_prefill(self, stream: GenerateStream):
        """Chunked prefill, then first-token sample + decode-slot insertion
        before it returns. A preempted stream (recompute) prefills its
        generated context too and re-enters decode with its pending last
        token: no new sample. A split model's stream takes its decode slot
        first: its prefill writes the slot's rings."""
        block_row = self._block_row(stream.alloc.blocks)
        if self.swa_split:
            stream.slot = self._free_slots.pop()
            self.slots[stream.slot] = stream
        logits = self._prefill_forward(stream, block_row)
        if not stream.is_recompute:
            self._finish_prefill_group(self._sample_first([stream], logits, block_row[None]))
            return
        prow = params_row_from_config(stream.config, stream.needs_eos_ban())
        slot = self._take_slot(stream, prow["ban_eos"])
        block_row = self._shrunk_row(stream, stream.total_len, block_row)
        counts = torch.zeros(self.model.cfg.vocab_size, dtype=torch.int32)
        counts.index_add_(0, torch.tensor(stream.output_token_ids),
                          torch.ones(len(stream.output_token_ids), dtype=torch.int32))
        bias = self._bias_rows([stream.config])
        self.state.insert_slot(slot, stream.output_token_ids[-1], stream.total_len - 1,
                               block_row, self._prompt_masks([stream.prompt_token_ids])[0],
                               prow, counts_row=upload(counts, self.device),
                               bias_row=None if bias is None else (bias[0][0], bias[1][0]),
                               adapter_id=stream.adapter_id)
        self._prefill_proposer(stream, slot, stream.context_token_ids, block_row)

    def _prefill_proposer(self, stream, slot: int, tokens, block_row) -> None:
        """A stream entering a decode slot: the draft model prefills
        ``tokens`` (the whole prompt, or a recompute's context) into its
        pool; an EAGLE head's slot takes the feature of the stream's last
        prefilled position (its prefill ran single, just before)."""
        if self.draft is not None:
            self.draft.prefill(tokens, block_row, self.config.scheduler.prefill_buckets[-1],
                               self._prefill_inputs)
        if self.eagle is not None:
            self.eagle.set_slot_hidden(slot, self._eagle_seed)

    def _pack_groups(self, streams) -> list:
        """FIFO groups of at most PREFILL_PACK streams and at most the
        largest prefill bucket's real tokens (activation memory: the JAX
        engine's [4, 8192] would not fit next to an auto-sized pool)."""
        cap = self.config.scheduler.prefill_buckets[-1]
        groups, tokens = [], 0
        for s in streams:
            n = s.prompt_len - s.reuse_len
            if not groups or len(groups[-1]) == self.PREFILL_PACK or tokens + n > cap:
                groups.append([])
                tokens = 0
            groups[-1].append(s)
            tokens += n
        return groups

    def _run_prefills_packed(self, streams):
        """Prefill this step's new streams (JAX ``_run_prefills_packed``).
        Streams whose non-reused context exceeds the largest bucket,
        recomputes, and streams with a trie walk take the single path. The
        packable ones are dispatched in groups; last step's groups are
        finished after them, so their readback overlaps the device running
        this step's."""
        if self.eagle is not None or self.swa_split:
            # the head's prefill and its slot's feature follow each stream's
            # own features; a split model's prefill writes its slot's rings:
            # single prefills only (as JAX)
            for s in streams:
                self._run_prefill(s)
            return
        max_bucket = self.config.scheduler.prefill_buckets[-1]
        packable, single = [], []
        for s in streams:
            fits = len(s.context_token_ids) - s.reuse_len <= max_bucket
            (packable if fits and not s.is_recompute and s.tree_state is None
             else single).append(s)
        for s in single:
            self._run_prefill(s)
        prev, self._prefill_pending = self._prefill_pending, []
        if len(packable) == 1 and not prev:
            self._run_prefill(packable[0])
            return
        for group in self._pack_groups(packable):
            self._prefill_pending.append(self._dispatch_prefill_group(group))
        for g in prev:
            self._finish_prefill_group(g)

    def _flush_prefill_pending(self):
        """Finish every dispatched prefill group."""
        pending, self._prefill_pending = self._prefill_pending, []
        for g in pending:
            self._finish_prefill_group(g)

    def _kv_bucket(self, active, extra: int) -> int:
        """Block-table width covering this window's deepest row (+extra
        positions: the window's further steps and the window in flight),
        rounded up to a bucket: one graph per bucket."""
        need_tokens = max(s.total_len for s in active) + extra + 1
        need_blocks = -(-need_tokens // self.block_size)
        for b_ in self._kv_buckets:
            if need_blocks <= b_:
                return b_
        return self._kv_buckets[-1]

    # ---- dispatch / release ----

    def _release_stream(self, stream: GenerateStream):
        if stream.slot >= 0:
            self.state.clear_slot(stream.slot)
            self.slots[stream.slot] = None
            self._free_slots.append(stream.slot)
            stream.slot = -1
        self.scheduler.release(stream)

    def _resolve_pending(self):
        """Read back the window in flight and run its stop checks."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._resolve_window(*pending)

    def _resolve_window(self, readback: Readback, streams):
        """Append each stream's tokens of the window until a stop fires. The
        tokens after a stop (the overshoot) are discarded: their KV rows lie
        past the accepted length. A stream released after dispatch (client
        abort, preemption) ignores its tokens."""
        toks, lps = readback.wait()
        msl = self.config.scheduler.max_seq_len
        generated = self.tokens_generated
        for s in streams:
            if s.is_finished() or s.slot < 0:
                continue
            for j in range(len(toks)):
                self.tokens_generated += 1
                if s.append_token(toks[j][s.slot], self.eos_ids,
                                  lps[j][s.slot] if lps is not None else 0.0,
                                  max_seq_len=msl):
                    self._release_stream(s)
                    break
        METRICS.inc("engine.tokens_generated", self.tokens_generated - generated)

    # ---- the step ----

    def step(self) -> bool:
        """One engine iteration. Returns True if any work was done."""
        with self.device_lock, torch.no_grad():
            did = self._step_locked()
            self._set_gauges()
            return did

    def _set_gauges(self) -> None:
        """The engine's gauges (JAX ``_step_locked``'s), from host values
        the step already holds: nothing is read back from the device."""
        pool = self.cache_mgr.pool
        running = sum(s is not None for s in self.slots)
        METRICS.set_gauge("engine.running_streams", running)
        METRICS.set_gauge("engine.waiting_streams", len(self.scheduler.waiting))
        METRICS.set_gauge("engine.kv_free_blocks", pool.free_blocks)
        METRICS.set_gauge("engine.kv_utilization", 1.0 - pool.free_blocks / max(pool.num_blocks, 1))
        METRICS.set_gauge("engine.batch_occupancy", running / len(self.slots))

    def _step_locked(self) -> bool:
        # release streams finished outside the engine loop (client abort,
        # frontend stop string): their blocks and slot would leak otherwise
        for s in list(self.scheduler.running):
            if s.is_finished() and (s.slot >= 0 or s.alloc is not None):
                self._release_stream(s)
        # admission needs resolved slot and block state; idle steps flush
        if self.scheduler.waiting or not self.scheduler.running:
            self._resolve_pending()
        new_streams = self.scheduler.schedule()
        normal = [s for s in new_streams if s.config.max_num_beams <= 1]
        for s in new_streams:
            if s.config.max_num_beams > 1:
                self._run_beam_prefill(s)
        if normal:
            self._run_prefills_packed(normal)
        elif self._prefill_pending:
            # no new prefills this step: finish last step's groups
            self._flush_prefill_pending()
        for group in list(self._beam_groups):
            self._beam_step(group)

        active = [s for s in self.scheduler.running if s.slot >= 0]
        if not active:
            self._resolve_pending()
            self.step_count += 1
            return bool(new_streams) or bool(self._beam_groups)

        sc = self.config.scheduler
        use_spec = self._spec_eligible(active)
        if use_spec:
            # proposals follow the latest tokens: resolve the window in
            # flight, then ask again with exact lengths
            self._resolve_pending()
            active = [s for s in self.scheduler.running if s.slot >= 0]
            if not active:
                self.step_count += 1
                return True
            use_spec = self._spec_eligible(active)
        n_multi = sc.decode_steps
        # tokens of the window in flight: the host lengths lag by that many
        ahead = self._pending[0].n if self._pending else 0
        # think budgets, n-gram bans and a trie need the latest tokens
        use_multi = (n_multi > 1 and not use_spec and self.tree_config is None
                     and not any(s.config.max_thinking_tokens or s.config.no_repeat_ngram_size
                                 for s in active)
                     and all(s.total_len + ahead + n_multi + 1 <= sc.max_seq_len
                             for s in active))
        n = n_multi if use_multi else 1
        # this window writes positions total_len - 1 + ahead .. + n - 1; a
        # verify total_len - 1 .. + K
        extra = self.spec.draft_tokens if use_spec else n - 1 + ahead

        # grow block allocations for the tokens this window writes
        forced_changed = False
        for s in list(active):
            if s.alloc is None or s.slot < 0:
                continue  # evicted as a victim earlier in this loop
            preempted_self = not self.scheduler.grow_for_decode(s, extra)
            for v in self.scheduler.preempted_this_step:
                if v.slot >= 0:
                    self.state.clear_slot(v.slot)
                    self.slots[v.slot] = None
                    self._free_slots.append(v.slot)
                    v.slot = -1
                if v in active:
                    active.remove(v)
            self.scheduler.preempted_this_step.clear()
            if preempted_self:
                continue
            if len(s.alloc.blocks) != self._slot_nblocks[s.slot]:
                self.state.block_tables[s.slot] = self._block_row(s.alloc.blocks)
                self._slot_nblocks[s.slot] = len(s.alloc.blocks)
            ban = s.needs_eos_ban()
            if ban != self._slot_ban[s.slot]:
                self._slot_ban[s.slot] = ban
                self.state.params.ban_eos[s.slot] = ban
            # a forcing is written when it changes (the JAX engine's rule:
            # then every live slot's last forcing is written again)
            forced = s.forced_next_token()
            if forced != self._slot_forced[s.slot]:
                self._slot_forced[s.slot] = forced
                forced_changed = True
        if forced_changed:
            self._write_forced()
        if not active:
            self.step_count += 1
            return True
        if use_spec:
            self._spec_step(active)
            self.step_count += 1
            return True

        cfgs = [s.config for s in active]
        need_sampling = any(c.do_sample for c in cfgs)
        need_stats = any(c.repetition_penalty != 1.0 or c.presence_penalty != 0.0
                         or c.frequency_penalty != 0.0 or c.return_logprobs
                         or c.top_logprobs for c in cfgs)
        use_ban = any(c.no_repeat_ngram_size for c in cfgs)
        use_tree = self.tree_config is not None and any(s.tree_state is not None for s in active)
        if use_ban or use_tree:
            # bans and allow-lists follow the whole token history: resolve the
            # window in flight and run one synchronous step
            self._resolve_pending()
            active = [s for s in self.scheduler.running if s.slot >= 0]
            if not active:
                self.step_count += 1
                return True
            self._write_constraints(active, use_ban, use_tree)
            tokens, logprobs = self._dispatch(
                WindowKey(self._kv_bucket(active, 1), need_sampling, need_stats, 1, True))
            readback = self._readbacks[self._next_readback]
            self._next_readback ^= 1
            readback.start(tokens, logprobs, need_stats)
            self._resolve_window(readback, active)
            self.step_count += 1
            return True
        tokens, logprobs = self._dispatch(
            WindowKey(self._kv_bucket(active, extra), need_sampling, need_stats, n, False))
        readback = self._readbacks[self._next_readback]
        self._next_readback ^= 1
        readback.start(tokens, logprobs, need_stats)
        if sc.async_decode:
            # resolve the previous window while the device runs this one
            prev, self._pending = self._pending, (readback, active)
            if prev is not None:
                self._resolve_window(*prev)
        else:
            self._resolve_pending()
            self._resolve_window(readback, active)
        self.step_count += 1
        return True

    def _write_forced(self) -> None:
        """Write every live slot's forcing into the decode state (-1 in the
        others), behind the window in flight."""
        host = torch.full((len(self.slots),), -1, dtype=torch.int64)
        for s in self.slots:
            if s is not None and s.slot >= 0:
                host[s.slot] = self._slot_forced[s.slot]
        self.state.forced_tokens.copy_(upload(host, self.device))

    def _write_constraints(self, active, use_ban: bool, use_tree: bool) -> None:
        """Rewrite the constrained window's rows: each slot's n-gram bans
        over its whole history and its trie's allow-list (-1 = none)."""
        b = len(self.slots)
        bans, allows = [None] * b, [None] * b
        for s in active:
            if use_ban:
                bans[s.slot] = self._ngram_bans(s.all_token_ids, s.config.no_repeat_ngram_size,
                                                self.MAX_NGRAM_BANS)
            if use_tree and s.tree_state is not None:
                allows[s.slot] = s.tree_state.allowed()
        self._ban_buf.copy_(self._id_rows(bans, self.MAX_NGRAM_BANS))
        self._allow_buf.copy_(self._id_rows(allows, MAX_ALLOW))

    # ---- beam search (engine/beam.py) ----

    def copy_blocks(self, src: list, dst: list) -> None:
        """Copy whole KV blocks over all layers, block ``src[i]`` into
        ``dst[i]``: the data and, on an int8 pool, the scales (the fork of a
        beam's partial tail block). One ``index_copy_`` a tensor."""
        if not src:
            return
        bs = self.block_size
        offs = torch.arange(bs)
        rows = upload(torch.cat([(torch.tensor(src)[:, None] * bs + offs).reshape(-1),
                                 (torch.tensor(dst)[:, None] * bs + offs).reshape(-1)]),
                      self.device)
        n = len(src) * bs
        for pool in (self.kv.values() if isinstance(self.kv, dict) else (self.kv,)):
            view = storage_view(pool)  # [L, 2, NS, C]
            view.index_copy_(2, rows[n:], view.index_select(2, rows[:n]))

    def _run_beam_prefill(self, stream: GenerateStream) -> None:
        """Prefill a beam request alone and branch it into its beams (no
        decode slot). The beams take over the stream's blocks: beam 0
        inherits them, the others share the full ones and copy the partial
        tail. The stream gives up its allocation, so no preemption picks it."""
        block_row = self._block_row(stream.alloc.blocks)
        logits = self._prefill_forward(stream, block_row)  # [1, V]
        logprobs = torch.log_softmax(logits.float(), dim=-1)[0].cpu().numpy()
        group = BeamGroup(stream, stream.config.max_num_beams, self.cache_mgr, self.block_size)
        # a beam never outgrows max_seq_len: its block-table row has
        # max_blocks_per_seq entries
        group.max_new = max(1, min(stream.config.max_new_tokens,
                                   self.config.scheduler.max_seq_len - stream.prompt_len))
        group.init_from_prefill(stream.alloc.blocks, logprobs, self.eos_ids, group.max_new)
        parent_blocks = stream.alloc.blocks  # ownership moves to the beams
        stream.alloc = None
        self._beam_groups.append(group)
        if not self._beam_fix_blocks(group, parent_blocks, seq_len=stream.prompt_len):
            # the pool is exhausted before the fork: the best first token
            group.beams[0].blocks = list(parent_blocks)
            for b in group.beams[1:]:
                b.blocks = []
            self._finish_beam_group(group)

    def _beam_fix_blocks(self, group: BeamGroup, parent_blocks: list, seq_len: int) -> bool:
        """Give each beam writable KV for its pending token at ``seq_len``:
        beam 0 inherits ``parent_blocks``, the rest share the full blocks
        (a reference each) and copy the partial tail, if there is one. All
        fresh blocks come from one malloc, so an OOM leaves no partial
        references; False on OOM (the caller finishes the group)."""
        pool = self.cache_mgr.pool
        k = len(group.beams)
        fresh_tail = seq_len % self.block_size == 0  # the pending token opens a block
        n_fresh = (k - 1) + (1 if fresh_tail else 0)
        fresh = self.cache_mgr._malloc(n_fresh) if n_fresh else []
        if fresh is None:
            return False
        src, dst = [], []
        fi = 0
        for i, beam in enumerate(group.beams):
            if i == 0:
                blocks = list(parent_blocks)
            else:
                blocks = list(parent_blocks if fresh_tail else parent_blocks[:-1])
                pool.ref(blocks)
                if not fresh_tail:
                    src.append(parent_blocks[-1])
                    dst.append(fresh[fi])
            if i or fresh_tail:
                blocks.append(fresh[fi])
                fi += 1
            beam.blocks = blocks
        self.copy_blocks(src, dst)
        return True

    def _beam_logprobs(self, group: BeamGroup) -> np.ndarray:
        """One forward of the group's k rows at T = 1, each at its pending
        token (K/V written in-layer, at position n), and the f32
        ``log_softmax`` of its logits ``[k, V]`` on the host."""
        k = len(group.beams)
        n = group.seq_len(group.beams[0]) - 1  # the pending tokens' position
        need = -(-(n + 1) // self.block_size)
        kvb = next((b_ for b_ in self._kv_buckets if need <= b_), self._kv_buckets[-1])
        host = torch.zeros((k, 4 + kvb), dtype=torch.int32)
        for i, beam in enumerate(group.beams):
            host[i, 0] = beam.tokens[-1]
            host[i, 4: 4 + len(beam.blocks)] = torch.tensor(beam.blocks, dtype=torch.int32)
        host[:, 1] = n
        host[:, 2] = n + 1
        host[:, 3] = group.stream.adapter_id
        dev = upload(host, self.device)
        inputs = ModelInputs(tokens=dev[:, 0:1], positions=dev[:, 1:2], block_tables=dev[:, 4:],
                             kv_lens=dev[:, 2], q_offsets=dev[:, 1],
                             adapter_ids=dev[:, 3] if group.stream.adapter_id else None)
        out, self.kv = self.model.forward(self.weights, self.kv, inputs)
        return torch.log_softmax(out.logits.float(), dim=-1).cpu().numpy()

    def _beam_step(self, group: BeamGroup) -> None:
        """One decode and rerank step of a beam group, then the children's
        blocks: a parent's first child takes its blocks over, each further
        child shares its full blocks and copies its partial tail. On OOM
        the old beams are intact and the group finishes with its best
        hypothesis: one request must not fail the batch."""
        t0 = time.perf_counter()
        stream = group.stream
        lp = self._beam_logprobs(group)
        st = self.beam_stats
        st["steps"] += 1
        st["rows"] += len(group.beams)
        children = group.advance(lp, () if stream.config.ignore_eos else self.eos_ids,
                                 group.max_new)
        self.tokens_generated += len(children)
        try:
            if group.done or not children or stream.is_finished():
                self._finish_beam_group(group)
                return
            old = group.beams
            pool = self.cache_mgr.pool
            new_pos = group.seq_len(old[0])  # the children's pending tokens
            fresh_tail = new_pos % self.block_size == 0
            parents = {p for p, _, _ in children}
            n_fresh = len(children) - len(parents) + (len(parents) if fresh_tail else 0)
            fresh = self.cache_mgr._malloc(n_fresh) if n_fresh else []
            if fresh is None:
                self._finish_beam_group(group)
                return
            fi = 0
            beams, src, dst, inherited = [], [], [], set()
            for parent, tok, score in children:
                pblocks = old[parent].blocks
                if parent not in inherited:
                    inherited.add(parent)
                    blocks = list(pblocks)
                else:
                    blocks = list(pblocks if fresh_tail else pblocks[:-1])
                    pool.ref(blocks)
                    if not fresh_tail:
                        src.append(pblocks[-1])
                        dst.append(fresh[fi])
                if fresh_tail or len(blocks) < len(pblocks):
                    blocks.append(fresh[fi])
                    fi += 1
                beams.append(Beam(tokens=old[parent].tokens + [tok], cum_logprob=score,
                                  blocks=blocks))
            for i, beam in enumerate(old):  # parents with no child
                if i not in parents:
                    pool.free(beam.blocks)
            self.copy_blocks(src, dst)
            group.beams = beams
        finally:
            st["seconds"] += time.perf_counter() - t0

    def _finish_beam_group(self, group: BeamGroup) -> None:
        """Free the beams' blocks and end the stream with the best
        hypothesis, the whole output in one chunk; every hypothesis, best
        first, stays on the stream (``beam_hypotheses``)."""
        stream = group.stream
        best = group.best()
        pool = list(group.finished) + [Beam(b.tokens, b.cum_logprob, []) for b in group.beams]
        for beam in group.beams:
            self.cache_mgr.pool.free(beam.blocks)
        group.beams = []
        self._beam_groups.remove(group)
        if not stream.is_finished():
            stream.beam_hypotheses = sorted(((list(h.tokens), h.cum_logprob) for h in pool),
                                            key=lambda h: -h[1] / max(len(h[0]), 1))
            stream.output_token_ids = list(best.tokens)
            stream.finish(FinishReason.STOP if group.finished else FinishReason.LENGTH,
                          emit_all=True)
        self.scheduler.release(stream)

    # ---- dynamic LoRA ----

    def set_lora_manager(self, manager) -> None:
        self.lora_manager = manager
        self.refresh_lora_weights()

    def refresh_lora_weights(self) -> None:
        """Pack the manager's adapters into the weights (``fuse_lora``'s
        stacks on the device) under the device lock; a pack the kernels
        would not take raises before the weights or graphs change. The
        graphs read the stacks by address, so on the card every captured
        window is captured again (the JAX engine's re-trace), after the
        window in flight is resolved; serving after the refresh captures
        nothing."""
        mgr = self.lora_manager
        if mgr is not None and mgr.names() and self.model.cfg.num_experts:
            raise ValueError("LoRA adapters on a mixture-of-experts model are not ported "
                             "(ROADMAP A11)")
        with self.device_lock, torch.no_grad():
            self._resolve_pending()
            pack = self.model.fuse_lora(mgr.device_pack(self.device)) if mgr else {}
            for name in [n for n in self.weights if ".lora_" in n]:
                del self.weights[name]
            self.weights.update(pack)
            self._lora = ({name: (i, adapter_salt(name, adds))
                           for name, (i, adds) in mgr.entries().items()} if mgr else {})
            if self._graphs is None:
                return
            if pack:
                lora_ops.warm(self.device)
            keys = list(self._graphs.graphs)
            self._graphs.graphs.clear()
            self._graphs.ready_thread()
            for key in keys:
                self._graphs.capture(key)

    # ---- warmup ----

    def _decode_warmup_keys(self, tail: bool) -> list:
        """Decode keys warmup readies, largest kv bucket first (its
        activations set the shared pool). ``tail=False``: serving's common
        windows, need_stats=False (default sampling configs carry no
        penalties or logprobs), both sampling variants, one step and
        ``decode_steps``, and with speculation each bucket's rollout and
        verify (first: a verify's activations are the largest).
        ``tail=True``: the rest, the need_stats=True windows and the
        constrained single steps (n-gram bans, trie) with and without the
        stats pass."""
        steps = sorted({1, self.config.scheduler.decode_steps}, reverse=True)
        buckets = list(reversed(self._kv_buckets))
        if not tail:
            return ([key for kvb in buckets for key in self._spec_keys(kvb)]
                    + [WindowKey(kvb, ns, False, n, False) for kvb in buckets
                       for ns in (False, True) for n in steps])
        return ([WindowKey(kvb, ns, True, n, False) for kvb in buckets for ns in (False, True)
                 for n in steps]
                + [WindowKey(kvb, ns, st, 1, True) for kvb in buckets for ns in (False, True)
                   for st in (False, True)])

    def _ready(self, key) -> None:
        """Capture ``key``'s graph on the card (if it has none yet) and
        record it as warm. Under the device lock."""
        if self._graphs is not None and key not in self._graphs:
            self._graphs.capture(key)
        self.warm_keys.add(key)

    def _warm_prefill(self) -> None:
        """One prefill forward at 1, 2 and PREFILL_PACK rows of a few tokens
        each, into the null block (block 0, never allocated), so that no
        kernel's first launch waits on a request."""
        t = min(16, self.block_size)
        for rows in (1, 2, self.PREFILL_PACK):
            bt = torch.zeros((rows, self.max_blocks_per_seq), dtype=torch.int32,
                             device=self.device)
            inputs = self._prefill_inputs([([0] * t, 0)] * rows, bt)
            _, self.kv = self.model.forward(self.weights, self.kv, inputs)

    def warmup(self, tail: bool = True):
        """Ready every decode window serving can reach. The common windows
        (``need_stats=False``) are captured here, after one prefill forward
        at each packed group size; on the card the rest (``need_stats=True``,
        constrained) are captured by a background thread, one at a time
        under the device lock between steps, while serving starts
        (``wait_warmup_complete`` joins it). Capture runs no kernel, so the
        engine may be serving. ``tail=False`` leaves the rest to be captured
        at first use: for an engine that serves no penalties, logprobs or
        constraints. On the CPU nothing is captured: the common keys are
        only recorded and the rest are readied at first use."""
        with self.device_lock, torch.no_grad():
            self._warm_prefill()
            for key in self._decode_warmup_keys(tail=False):
                self._ready(key)
        if self._graphs is None or not tail:
            return
        self._warmup_thread = threading.Thread(
            target=self._warm_tail, args=(self._decode_warmup_keys(tail=True),),
            name="decode-graph-warmup", daemon=True)
        self._warmup_thread.start()

    def _warm_tail(self, keys) -> None:
        """The background captures. A failure is kept, not lost with the
        thread: a capture that fails can leave the shared pool unusable for
        every later one, so the engine reports it at once."""
        t0 = time.perf_counter()
        try:
            with self.device_lock:
                self._graphs.ready_thread()
            for key in keys:
                with self.device_lock, torch.no_grad():
                    self._ready(key)
        except Exception as e:  # noqa: BLE001 - kept for wait_warmup_complete and /health
            logger.exception("background decode-graph warmup failed")
            self.warmup_error = e
            return
        logger.info("warmup: %d more decode graphs in %.1f s", len(keys),
                    time.perf_counter() - t0)

    def wait_warmup_complete(self, timeout: Optional[float] = None) -> None:
        """Join the background captures of ``warmup()``; raises what failed
        them."""
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout)
        if self.warmup_error is not None:
            raise RuntimeError("background decode-graph warmup failed") from self.warmup_error

    # ---- public API ----

    def _check_ids(self, what: str, ids) -> None:
        """ValueError for an id outside ``[0, vocab)``: on the card such an
        id would index past a table (the embedding, a scatter) and fail the
        device, and with it every stream."""
        v = self.model.cfg.vocab_size
        bad = [t for t in ids if not 0 <= t < v]
        if bad:
            raise ValueError(f"{what} holds token ids outside the vocabulary "
                             f"[0, {v}): {bad[:8]}")

    def check_request(self, prompt_token_ids: List[int],
                      config: Optional[GenerateConfig] = None) -> None:
        """ValueError unless every token id the request names (its prompt,
        its logit-bias keys, its think tokens) lies in the vocabulary."""
        self._check_ids("the prompt", prompt_token_ids)
        if config is None:
            return
        if config.logit_bias:
            self._check_ids("logit_bias", [int(t) for t in config.logit_bias])
        self._check_ids("the think tokens", [t for t in (config.think_start_token_id,
                                                         config.think_end_token_id)
                                             if t is not None])
        self._lora_entry(config.adapter_name)
        if self.swa_split and config.max_num_beams > 1:
            raise ValueError("beam search is not supported for mixed global / sliding-window "
                             "pool models (per-slot rings are not fork-shareable)")

    def _lora_entry(self, name: Optional[str]) -> tuple:
        """(id, prefix-cache salt) of the adapter ``name`` as packed at the
        last refresh, (0, 0) for none; ValueError for an adapter the engine
        does not serve."""
        if not name:
            return 0, 0
        if name not in self._lora:
            raise ValueError(f"unknown LoRA adapter {name!r}")
        return self._lora[name]

    def enqueue(self, prompt_token_ids: List[int],
                config: Optional[GenerateConfig] = None,
                stop_token_sequences: Optional[List[List[int]]] = None) -> GenerateStream:
        """Queue a request; a stream whose request fails ``check_request``
        comes back aborted with its error, and is not queued."""
        stream = GenerateStream(prompt_token_ids, config,
                                stop_token_sequences=stop_token_sequences)
        try:
            self.check_request(prompt_token_ids, config)
        except ValueError as e:
            stream.abort(str(e))
            return stream
        stream.adapter_id, stream.cache_salt = self._lora_entry(stream.config.adapter_name)
        if self.tree_config is not None:
            stream.tree_state = TreeDecodeState(self.tree_config)
            for t in prompt_token_ids:
                stream.tree_state.update(int(t))
        self.scheduler.enqueue(stream)
        return stream

    def has_work(self) -> bool:
        """Streams waiting or running, a window not yet read back, a
        prefill group not yet finished, or a live beam group."""
        return (self.scheduler.has_work() or self._pending is not None
                or bool(self._prefill_pending) or bool(self._beam_groups))

    def abort_all(self, error: str):
        """Abort every stream and drop the window, prefill groups and beam
        groups in flight (after an engine error: their tokens are not read)."""
        self._pending = None
        self._prefill_pending = []
        for group in self._beam_groups:
            for beam in group.beams:
                self.cache_mgr.pool.free(beam.blocks)
        self._beam_groups = []
        for s in list(self.scheduler.running):
            s.abort(error)
            self._release_stream(s)
        while self.scheduler.waiting:
            self.scheduler.waiting.popleft().abort(error)

    def generate(self, prompt_token_ids: List[int],
                 config: Optional[GenerateConfig] = None,
                 max_steps: int = 100_000) -> GenerateStream:
        """Synchronous convenience: enqueue + step to completion."""
        stream = self.enqueue(prompt_token_ids, config)
        steps = 0
        while not stream.is_finished() and steps < max_steps:
            self.step()
            steps += 1
        return stream

    # ---- teacher-forced loops ----

    def generate_with_hidden(self, prompt_token_ids: List[int],
                             config: Optional[GenerateConfig] = None):
        """Synchronous generate that also returns the final-normed hidden
        state that produced each output token (JAX ``generate_with_hidden``).
        A teacher-forced loop of one-stream prefills on a private allocation
        (not admitted by the scheduler): the prompt in chunks of the largest
        prefill bucket, then one token a forward at its offset. Greedy takes
        the argmax of the raw logits; sampling draws from the temperature's
        softmax with a generator seeded by ``config.seed``. Returns
        (GenerateStream, hidden ``[n_out, H]`` f32 on the host)."""
        config = config or GenerateConfig()
        self.check_request(prompt_token_ids, config)
        stream = GenerateStream(list(prompt_token_ids), config)
        stream.adapter_id = self._lora_entry(config.adapter_name)[0]
        with self.device_lock:
            alloc = self.cache_mgr.allocate(list(prompt_token_ids), allow_reuse=False)
        if alloc is None:
            raise RuntimeError("KV pool exhausted")
        stream.alloc = alloc
        stream.state = StreamState.RUNNING
        gen = torch.Generator(device=self.device)
        gen.manual_seed(config.seed or 0)
        chunk = self.config.scheduler.prefill_buckets[-1]
        msl = self.config.scheduler.max_seq_len
        hiddens = []
        with self.device_lock, torch.no_grad():
            slots = self._borrow_ring_slot(alloc)
            toks, pos = list(prompt_token_ids), 0
            while True:
                t_real = min(len(toks) - pos, chunk)
                inputs = self._whole(self._prefill_inputs(
                    [(toks[pos: pos + t_real], pos)], self._block_row(alloc.blocks)[None],
                    [stream.adapter_id], slots), len(toks))
                out, self.kv = self.model.forward(self.weights, self.kv, inputs,
                                                  need_all_hidden=True)
                if pos + t_real < len(toks):
                    pos += t_real
                    continue
                logits = out.logits[0]
                if config.do_sample and config.temperature > 0:
                    probs = torch.softmax(logits / max(config.temperature, 1e-5), dim=-1)
                    tok = int(torch.multinomial(probs, 1, generator=gen))
                else:
                    tok = int(torch.argmax(logits))
                hiddens.append(out.all_hidden[-1].float())
                finished = stream.append_token(tok, self.eos_ids, max_seq_len=msl)
                if finished or len(stream.output_token_ids) >= config.max_new_tokens:
                    if not stream.is_finished():
                        stream.finish(FinishReason.LENGTH)
                    break
                if not self.cache_mgr.extend(alloc, len(toks) + 2):
                    stream.finish(FinishReason.LENGTH)
                    break
                toks.append(tok)
                pos = len(toks) - 1
            self.cache_mgr.free(alloc)
            if slots:
                self._free_slots.append(slots[0])
            stream.alloc = None
            hidden = (torch.stack(hiddens).cpu() if hiddens
                      else torch.zeros((0, self.model.cfg.hidden_size)))
        return stream, hidden

    def compute_prompt_loss(self, prompt_token_ids: List[int],
                            adapter_name: Optional[str] = None) -> torch.Tensor:
        """Per-token negative log-likelihood of the prompt, teacher-forced
        (JAX ``compute_prompt_loss``), under the LoRA adapter
        ``adapter_name`` if one is named: ``[len(prompt) - 1]`` f32 on the
        host, ``loss[i] = -log p(t_{i+1} | t_{<=i})``. Chunks of the largest
        prefill bucket on a private allocation; the device lock is taken a
        chunk at a time, so decode steps interleave (a split model's loop
        holds it throughout, with a borrowed slot's rings)."""
        prompt = list(prompt_token_ids)
        self.check_request(prompt)
        aid = self._lora_entry(adapter_name)[0]
        if len(prompt) < 2:
            return torch.zeros(0)
        if len(prompt) > self.config.scheduler.max_seq_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds max_seq_len "
                             f"{self.config.scheduler.max_seq_len}")
        # a split model borrows a free slot's rings and holds the device lock
        # for the whole loop, so that no admission between chunks counts the
        # slot free; another model takes the lock a chunk at a time
        chunk_lock = contextlib.nullcontext() if self.swa_split else self.device_lock
        alloc = slots = None
        for _ in range(200):  # transient pool pressure waits, as admission does
            self.device_lock.acquire()
            alloc = self.cache_mgr.allocate(prompt, allow_reuse=False)
            if alloc is not None and self.swa_split:
                if self._free_slots:
                    slots = [self._free_slots.pop()]
                    break  # the lock stays held
                self.cache_mgr.free(alloc)  # and wait for a free slot
                alloc = None
            self.device_lock.release()
            if alloc is not None:
                break
            time.sleep(0.05)
        if alloc is None:
            raise RuntimeError("KV pool exhausted" + (" or no free decode slot"
                                                      if self.swa_split else ""))
        try:
            losses = self._prompt_nll(prompt, alloc, aid, slots, chunk_lock)
        finally:
            with chunk_lock:
                self.cache_mgr.free(alloc)
                if slots:
                    self._free_slots.append(slots[0])
            if self.swa_split:
                self.device_lock.release()
        return torch.cat(losses) if losses else torch.zeros(0)

    def _prompt_nll(self, prompt, alloc, aid, slots, lock) -> list:
        """``compute_prompt_loss``'s chunks: each chunk's NLL ``[n]`` on
        the host, ``lock`` taken a chunk at a time."""
        chunk = self.config.scheduler.prefill_buckets[-1]
        losses = []
        for pos in range(0, len(prompt), chunk):
            t_real = min(len(prompt) - pos, chunk)
            n_next = min(t_real, len(prompt) - pos - 1)
            with lock, torch.no_grad():
                inputs = self._whole(self._prefill_inputs(
                    [(prompt[pos: pos + t_real], pos)], self._block_row(alloc.blocks)[None],
                    [aid], slots), len(prompt))
                out, self.kv = self.model.forward(self.weights, self.kv, inputs,
                                                  need_all_logits=True)
                if n_next <= 0:
                    continue
                lg = out.all_logits[:n_next]
                nxt = upload(torch.tensor(prompt[pos + 1: pos + 1 + n_next]), self.device)
                nll = torch.logsumexp(lg, dim=-1) - lg.gather(1, nxt[:, None])[:, 0]
                losses.append(nll.cpu())
        return losses

    def _borrow_ring_slot(self, alloc) -> Optional[list]:
        """A split model's ``generate_with_hidden`` writes a free decode
        slot's rings (the JAX engine's write ring 0, which may be a live
        stream's): ``[slot]``, taken from the free slots under the device
        lock and given back by the caller; None for another model.
        RuntimeError (the allocation freed) when every slot is taken."""
        if not self.swa_split:
            return None
        if not self._free_slots:
            self.cache_mgr.free(alloc)
            raise RuntimeError("no free decode slot for the split pool's rings")
        return [self._free_slots.pop()]
