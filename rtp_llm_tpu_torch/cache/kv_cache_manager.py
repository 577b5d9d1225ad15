"""KV-cache manager: block allocation + prefix reuse for request streams.

Port of ``rtp_llm_tpu/cache/kv_cache_manager.py`` (pure-Python pool and
prefix cache; the host / disk / remote tiers, sliding-window recycling and
the native C++ pool are not ported). When the pool is exhausted, LRU
cache-held blocks are evicted to satisfy new allocations. This class never
touches device memory: the engine owns the device pool.
"""

from __future__ import annotations

import dataclasses
import math

from rtp_llm_tpu_torch.cache.block_pool import BlockPool
from rtp_llm_tpu_torch.cache.prefix_cache import PrefixBlockCache


@dataclasses.dataclass
class BlockAllocation:
    """Blocks held by one stream; ``reuse_len`` = tokens covered by reused
    prefix blocks (their KV is already on the device)."""

    blocks: list[int]
    reuse_len: int


class KVCacheManager:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True):
        self.block_size = block_size
        self.pool = BlockPool(num_blocks)
        self.prefix_cache = PrefixBlockCache() if enable_prefix_cache else None

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
            b = self.prefix_cache.pop_lru()
            if b is None:
                return None
            self.pool.free([b])  # drop the cache's reference
        return self.pool.malloc(n)

    def allocate(self, token_ids: list[int], allow_reuse: bool = True) -> BlockAllocation | None:
        """Allocate blocks for a request of len(token_ids) tokens, reusing
        cached prefix blocks where possible (not with ``allow_reuse=False``:
        a caller that writes every position's KV itself). None if the pool
        (after eviction) cannot cover it: the caller keeps the request
        waiting."""
        need_total = self.blocks_for_tokens(len(token_ids))
        reused: list[int] = []
        if self.prefix_cache is not None and allow_reuse:
            reused = self.prefix_cache.match(token_ids, self.block_size)[:need_total]
        # hold the matched blocks before eviction can reclaim them
        self.pool.ref(reused)
        fresh = self._malloc(need_total - len(reused))
        if fresh is None:
            self.pool.free(reused)
            return None
        return BlockAllocation(blocks=reused + fresh,
                               reuse_len=len(reused) * self.block_size)

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
        keep one reference owned by the cache."""
        if self.prefix_cache is not None and token_ids:
            n_full = len(token_ids) // self.block_size
            retained = self.prefix_cache.insert(
                token_ids[: n_full * self.block_size], alloc.blocks[:n_full],
                self.block_size)
            self.pool.ref(retained)  # the cache's reference
        self.pool.free(alloc.blocks)
        alloc.blocks = []
