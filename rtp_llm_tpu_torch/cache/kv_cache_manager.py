"""KV-cache manager: block allocation + prefix reuse for request streams.

Port of ``rtp_llm_tpu/cache/kv_cache_manager.py`` (pure-Python pool and
prefix cache, sliding-window block recycling; the host / disk / remote tiers
and the native C++ pool are not ported). When the pool is exhausted, LRU
cache-held blocks are evicted to satisfy new allocations. This class never
touches device memory: the engine owns the device pool.

Sliding-window recycling (``sliding_window_tokens`` W > 0, uniform-window
models, prefix cache off): a stream keeps ``swa_keep = ceil(W / bs) + 2``
blocks live. ``extend`` gives logical block j the stream's own physical
block of logical j - swa_keep once it holds it alone, and
``shrink_sliding`` frees, after a prefill, the blocks wholly below the
window, their table entries pointing at the first live block. A table then
repeats ids, whose stale rows the kernels read only masked by position
(the window's lower bound is per query), so they must lie wholly below
every query's window; ``extend`` states the bound.

The prefix cache's membership is versioned for cache-aware routing (JAX
``hash_version`` / ``cache_hash_diff``, the ``/cache_status`` feed): every
block hash that enters or leaves the cache bumps ``hash_version`` and is
journalled. ``invalidate_prefix_cache`` (after a weight update) drops every
cached block and stops allocations made before it from being offered to
the cache: their KV was computed by the old weights.

An allocation carries a ``salt`` that seeds its hash chain: a LoRA adapter's
(``adapter_salt``), so that blocks computed under one adapter are never
matched by a prompt served under another or under none. (The JAX package
keys blocks by tokens alone: ROADMAP.md, section C.)
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import deque

from rtp_llm_tpu_torch.cache.block_pool import BlockPool
from rtp_llm_tpu_torch.cache.prefix_cache import PrefixBlockCache, chain_hashes


@dataclasses.dataclass
class BlockAllocation:
    """Blocks held by one stream; ``reuse_len`` = tokens covered by reused
    prefix blocks (their KV is already on the device)."""

    blocks: list[int]
    reuse_len: int
    epoch: int = 0  # the manager's epoch at allocation
    salt: int = 0  # the hash chain's seed (0 = the base model)
    # sliding-window recycling left repeated physical ids in ``blocks``:
    # free() frees each once
    recycled: bool = False


def adapter_salt(name: str, generation: int = 0) -> int:
    """The prefix-cache salt of a LoRA adapter: a stable 63-bit hash of
    its name and of which registration of that name it is."""
    digest = hashlib.sha1(f"{name}\0{generation}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class KVCacheManager:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True, sliding_window_tokens: int = 0):
        self.block_size = block_size
        self.swa_tokens = sliding_window_tokens
        self.swa_keep = 0
        if sliding_window_tokens:
            if enable_prefix_cache:
                raise ValueError("sliding-window recycling needs the prefix cache off")
            # the window's blocks, the block being written, and one guard
            self.swa_keep = -(-sliding_window_tokens // block_size) + 2
        self.pool = BlockPool(num_blocks)
        self.prefix_cache = PrefixBlockCache() if enable_prefix_cache else None
        self._block_pyhash: dict[int, int] = {}  # cached block -> its chain hash
        self.hash_version = 0
        self._journal: deque = deque(maxlen=8192)  # (version, "+" | "-", hash)
        self.epoch = 0  # bumped by invalidate_prefix_cache

    # ---- sizing / admission ----

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return max(1, math.ceil(num_tokens / self.block_size))

    @property
    def free_blocks(self) -> int:
        """Free now + reclaimable from the prefix cache."""
        n = self.pool.free_blocks
        if self.prefix_cache is not None:
            n += self.prefix_cache.reclaimable(self.pool)
        return n

    def estimate_peak_blocks(self, prompt_len: int, max_new_tokens: int) -> int:
        """Admission estimate. Recycling bounds a stream at ``swa_keep``
        blocks once decoding; its prefill still takes the whole prompt."""
        total = self.blocks_for_tokens(prompt_len + max_new_tokens)
        if self.swa_tokens:
            return min(total, max(self.blocks_for_tokens(prompt_len + 1), self.swa_keep))
        return total

    # ---- allocation ----

    def _malloc(self, n: int) -> list[int] | None:
        """malloc with LRU eviction from the prefix cache as fallback."""
        got = self.pool.malloc(n)
        if got is not None or self.prefix_cache is None:
            return got
        while self.pool.free_blocks < n:
            if not self._evict_lru():
                return None
        return self.pool.malloc(n)

    def _evict_lru(self) -> bool:
        """Drop the cache's least-recently-used block (journalled); False
        when the cache is empty."""
        b = self.prefix_cache.pop_lru()
        if b is None:
            return False
        h = self._block_pyhash.pop(b, None)
        if h is not None:
            self._journal_op("-", h)
        self.pool.free([b])  # drop the cache's reference
        return True

    def _journal_op(self, op: str, h: int) -> None:
        self.hash_version += 1
        self._journal.append((self.hash_version, op, h))

    def allocate(self, token_ids: list[int], allow_reuse: bool = True,
                 salt: int = 0) -> BlockAllocation | None:
        """Allocate blocks for a request of len(token_ids) tokens, reusing
        cached prefix blocks of the same ``salt`` where possible (not with
        ``allow_reuse=False``: a caller that writes every position's KV
        itself). None if the pool (after eviction) cannot cover it: the
        caller keeps the request waiting."""
        need_total = self.blocks_for_tokens(len(token_ids))
        reused: list[int] = []
        if self.prefix_cache is not None and allow_reuse:
            reused = self.prefix_cache.match(token_ids, self.block_size,
                                             parent=salt)[:need_total]
        # hold the matched blocks before eviction can reclaim them
        self.pool.ref(reused)
        fresh = self._malloc(need_total - len(reused))
        if fresh is None:
            self.pool.free(reused)
            return None
        return BlockAllocation(blocks=reused + fresh,
                               reuse_len=len(reused) * self.block_size, epoch=self.epoch,
                               salt=salt)

    def extend(self, alloc: BlockAllocation, new_total_tokens: int) -> bool:
        """Grow a stream's allocation to cover new_total_tokens (decode).
        False on OOM (the caller must preempt a stream).

        Recycling: logical block j first takes the physical block of j -
        swa_keep, if the stream holds it alone (a beam fork or a cache
        reference stops it). That block's rows must be dead for every query
        that can still read it. Its last position is (j - swa_keep + 1) * bs
        - 1. A forward writes positions from its first query q0 to q0 + T - 1
        before its attention reads them (T = 1 a decode step, also within a
        multi-step window, whose steps run in order; K + 1 a verify window;
        prefill allocates its prompt whole and recycles nothing), and the
        first write into block j is at j * bs >= q0 + 0, the last query at
        most q0 + T - 1 < j * bs + T, so q0 > j * bs - T. Every query q >= q0
        reads positions above q - W, and with swa_keep = ceil(W / bs) + 2:
        (j - swa_keep + 1) * bs - 1 <= j * bs - W - bs - 1 < q0 - W when T <=
        bs + 1. So any window of up to bs + 1 tokens (65 at bs 64; the
        engine's are at most 9) reads none of the recycled rows; an async
        window in flight has run before the next window's writes, which
        follow it on the device's stream."""
        need = self.blocks_for_tokens(new_total_tokens)
        if need <= len(alloc.blocks):
            return True
        while self.swa_tokens and len(alloc.blocks) < need:
            j_old = len(alloc.blocks) - self.swa_keep
            if j_old < 0 or self.pool.refcount(alloc.blocks[j_old]) != 1:
                break
            alloc.blocks.append(alloc.blocks[j_old])
            alloc.recycled = True
        if need <= len(alloc.blocks):
            return True
        fresh = self._malloc(need - len(alloc.blocks))
        if fresh is None:
            return False
        alloc.blocks.extend(fresh)
        return True

    def shrink_sliding(self, alloc: BlockAllocation, total_tokens: int) -> bool:
        """After a prefill: free the physical blocks wholly below the window
        (the first len - swa_keep), their table entries pointing at the
        first live block, whose positions lie above theirs. True if the
        blocks changed (the caller writes the table row anew). A no-op
        without recycling or on an allocation that already recycled."""
        if not self.swa_tokens or alloc.recycled:
            return False
        dead = len(alloc.blocks) - self.swa_keep
        if dead <= 0:
            return False
        live = alloc.blocks[dead]
        victims = []
        for i in range(dead):
            b = alloc.blocks[i]
            if self.pool.refcount(b) != 1 or b == live:
                continue
            victims.append(b)
            alloc.blocks[i] = live
        if not victims:
            return False
        self.pool.free(victims)
        alloc.recycled = True
        return True

    def free(self, alloc: BlockAllocation, token_ids: list[int] | None = None):
        """Release a stream's blocks. With token_ids (prompt + generated),
        full blocks are offered to the prefix cache first; retained blocks
        keep one reference owned by the cache. An allocation made before the
        last ``invalidate_prefix_cache`` is not offered."""
        if self.prefix_cache is not None and token_ids and alloc.epoch == self.epoch:
            n_full = len(token_ids) // self.block_size
            prefix = token_ids[: n_full * self.block_size]
            retained = self.prefix_cache.insert(prefix, alloc.blocks[:n_full], self.block_size,
                                                parent=alloc.salt)
            self.pool.ref(retained)  # the cache's reference
            if retained:
                kept = set(retained)
                for h, b in zip(chain_hashes(prefix, self.block_size, alloc.salt),
                                alloc.blocks[:n_full]):
                    if b in kept:
                        self._block_pyhash[b] = h
                        self._journal_op("+", h)
        # a recycled table repeats physical ids: each is freed once
        self.pool.free(list(dict.fromkeys(alloc.blocks)) if alloc.recycled else alloc.blocks)
        alloc.blocks = []

    def invalidate_prefix_cache(self) -> None:
        """Drop every cached prefix block and start a new epoch: blocks of
        allocations made before now are freed, never cached."""
        self.epoch += 1
        if self.prefix_cache is not None:
            while self._evict_lru():
                pass

    # ---- cache-aware routing feed (JAX ``cache_hash_diff``) ----

    def cache_hash_diff(self, from_version: int = 0) -> dict:
        """Versioned prefix-cache membership for a cluster router:
        ``{"version", "base", "added", "removed"}``. ``base`` True means
        ``added`` is the whole current hash set (``from_version`` is older
        than the journal holds)."""
        cur = self.hash_version
        if from_version >= cur:
            return {"version": cur, "base": False, "added": [], "removed": []}
        oldest = self._journal[0][0] if self._journal else cur + 1
        if from_version + 1 < oldest:
            return {"version": cur, "base": True,
                    "added": list(self._block_pyhash.values()), "removed": []}
        added, removed = [], []
        for ver, op, h in self._journal:
            if ver > from_version:
                (added if op == "+" else removed).append(h)
        return {"version": cur, "base": False, "added": added, "removed": removed}
