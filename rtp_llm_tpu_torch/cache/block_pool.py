"""Ref-counted block pool (port of ``rtp_llm_tpu/cache/block_pool.py``).

Block ids are indices into the device cache's block axis. Block 0 is the
reserved null block (padding target) and is never allocated.
"""

from __future__ import annotations


class BlockPool:
    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))  # pop() -> 1 first
        self._refs: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def malloc(self, n: int) -> list[int] | None:
        """Allocate n blocks with refcount 1, or None if not enough free."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, blocks: list[int]):
        for b in blocks:
            if b != 0:
                self._refs[b] += 1

    def free(self, blocks: list[int]):
        """Decrement refcounts; blocks reaching 0 return to the free list."""
        for b in blocks:
            if b == 0:
                continue
            r = self._refs[b] - 1
            if r == 0:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = r

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)
