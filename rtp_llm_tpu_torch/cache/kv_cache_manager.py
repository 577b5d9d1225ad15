"""KV-cache manager: block allocation + prefix reuse for request streams.

Port of ``rtp_llm_tpu/cache/kv_cache_manager.py`` (pure-Python pool and
prefix cache; the host / disk / remote tiers, sliding-window recycling and
the native C++ pool are not ported). When the pool is exhausted, LRU
cache-held blocks are evicted to satisfy new allocations. This class never
touches device memory: the engine owns the device pool.

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


def adapter_salt(name: str, generation: int = 0) -> int:
    """The prefix-cache salt of a LoRA adapter: a stable 63-bit hash of
    its name and of which registration of that name it is."""
    digest = hashlib.sha1(f"{name}\0{generation}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class KVCacheManager:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True):
        self.block_size = block_size
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
        return self.blocks_for_tokens(prompt_len + max_new_tokens)

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
        False on OOM (the caller must preempt a stream)."""
        need = self.blocks_for_tokens(new_total_tokens)
        if need <= len(alloc.blocks):
            return True
        fresh = self._malloc(need - len(alloc.blocks))
        if fresh is None:
            return False
        alloc.blocks.extend(fresh)
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
        self.pool.free(alloc.blocks)
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
