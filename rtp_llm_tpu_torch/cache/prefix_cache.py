"""Prefix-hash block reuse cache with LRU eviction.

Port of ``rtp_llm_tpu/cache/prefix_cache.py``: a finished request's full
blocks are inserted keyed by a chained per-block hash of the token prefix;
new requests match their longest cached prefix and re-reference those
blocks instead of recomputing the KV. Cached-but-unreferenced blocks are
evicted LRU when the pool runs dry. A chain may be seeded (``parent``): a
LoRA adapter's salt keeps its blocks apart from the base model's.
"""

from __future__ import annotations

from collections import OrderedDict


def chain_hashes(token_ids: list[int], block_size: int, parent: int = 0) -> list[int]:
    """Chained hash per *full* block of token_ids."""
    out = []
    h = parent
    for i in range(0, len(token_ids) - block_size + 1, block_size):
        h = hash((h, tuple(token_ids[i : i + block_size])))
        out.append(h)
    return out


class PrefixBlockCache:
    def __init__(self):
        self._entries: OrderedDict[int, int] = OrderedDict()  # hash -> block, LRU first
        self._by_block: dict[int, int] = {}  # block -> hash

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, token_ids: list[int], block_size: int, parent: int = 0) -> list[int]:
        """Longest cached block-prefix for token_ids (touches the matches).

        Matches at most the first len(token_ids)-1 tokens' worth of full
        blocks: at least one token must be prefilled to have a last hidden
        state to sample from."""
        usable = len(token_ids) - 1
        blocks = []
        for h in chain_hashes(token_ids[:usable], block_size, parent):
            b = self._entries.get(h)
            if b is None:
                break
            self._entries.move_to_end(h)
            blocks.append(b)
        return blocks

    def insert(self, token_ids: list[int], blocks: list[int], block_size: int,
               parent: int = 0) -> list[int]:
        """Insert full blocks of a finished request. Returns the block ids newly
        retained by the cache (the caller transfers one reference for each)."""
        retained = []
        for h, b in zip(chain_hashes(token_ids, block_size, parent), blocks):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue  # already cached (possibly as a different block id)
            self._entries[h] = b
            self._by_block[b] = h
            retained.append(b)
        return retained

    def pop_lru(self) -> int | None:
        """Evict the least-recently-used entry, returning its block id."""
        if not self._entries:
            return None
        _, b = self._entries.popitem(last=False)
        self._by_block.pop(b, None)
        return b

    def reclaimable(self, pool) -> int:
        """Cache-held blocks whose only reference is the cache's own."""
        return sum(1 for b in self._by_block if pool.refcount(b) == 1)
