"""Paged KV cache: a global page pool, a refcounted free list and per-slot
page tables (reference ``runtime/kv_cache.py``, without prefix sharing).

Each attention unit position owns K and V pools of shape
``(r, num_blocks, block_size, n_kv_heads, head_dim)`` on the device (int8
or fp8 codes plus ``(r, num_blocks, n_kv_heads)`` f32 scales when the pool
is quantized); one
host-side page table ``(max_batch, max_pages)`` int32 is shared by every
layer and copied to the device per step.  **Block 0 is the trash page**:
free and shielded slots' table rows point at it, so padding rows of the
batched decode step write their garbage there and never into live pages.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

TRASH_PAGE = 0  # physical block 0: sink for padding writes, never allocated


class PoolInvariantError(AssertionError):
    """A pool invariant does not hold; ``rule`` names it as the reference's
    analyzer does (POOL001 refcounts, POOL002 table ownership, POOL003 free
    list)."""

    def __init__(self, rule: str, msg: str):
        super().__init__(f"{rule}: {msg}")
        self.rule = rule


class BlockAllocator:
    """Refcounted free list over physical blocks 1..num_blocks-1.

    ``alloc`` is all-or-nothing; blocks come out at refcount 1 and return to
    the (LIFO) free list when their last reference is freed.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (block 0 is the trash page), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}

    @property
    def capacity(self) -> int:
        """Usable pages (excludes the trash page)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` pages from the free list, or None if they don't fit."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def free(self, pages: list[int]) -> None:
        """Drop one reference per page; a block is reclaimed at zero."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"double free / foreign page {p}")
        for p in pages:
            if self._ref[p] == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] -= 1

    def check_invariants(self, holders=None) -> None:
        """Raise :class:`PoolInvariantError` unless the free list holds each
        usable page at most once, never trash or a referenced page, and
        together with the references accounts for every page; with
        ``holders`` (per-slot owned pages), each refcount equals the page's
        occurrences across them."""
        free = self._free
        if len(set(free)) != len(free):
            raise PoolInvariantError("POOL003", f"duplicate free pages: {free}")
        if any(not 1 <= p < self.num_blocks for p in free):
            raise PoolInvariantError("POOL003", f"out-of-range free pages: {free}")
        if set(free) & self._ref.keys():
            raise PoolInvariantError(
                "POOL003", f"pages both free and referenced: "
                f"{sorted(set(free) & self._ref.keys())}")
        if TRASH_PAGE in self._ref:
            raise PoolInvariantError("POOL003", "the trash page is refcounted")
        if len(free) + len(self._ref) != self.capacity:
            raise PoolInvariantError(
                "POOL003", f"{self.capacity - len(free) - len(self._ref)} pages "
                "leaked (neither free nor referenced)")
        if any(r < 1 for r in self._ref.values()):
            raise PoolInvariantError("POOL001", f"non-positive refcounts {self._ref}")
        if holders is None:
            return
        expect = collections.Counter(p for h in holders for p in h)
        for p in self._ref.keys() | expect.keys():
            if self._ref.get(p, 0) != expect.get(p, 0):
                raise PoolInvariantError(
                    "POOL001", f"page {p}: refcount {self._ref.get(p, 0)} != "
                    f"{expect.get(p, 0)} slot mappings")


@dataclasses.dataclass(frozen=True)
class PoolStats:
    """Point-in-time pool accounting."""

    capacity: int  # usable pages
    in_use: int
    peak_in_use: int
    page_bytes: int  # bytes of one page across all layers (K + V)
    active_slots: int


class PagedKVCache:
    """Device page pools + host page tables for the batched engine."""

    def __init__(self, cfg: ModelConfig, *, max_batch: int, max_seq: int,
                 block_size: int, num_blocks: int | None = None,
                 kv_dtype: str = "fp32", device=None):
        if max_seq % block_size != 0:
            raise ValueError(
                f"max_seq {max_seq} must be a multiple of block_size {block_size}")
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.block_size = block_size
        self.max_pages = max_seq // block_size
        if num_blocks is None:  # every slot can grow to max_seq, + trash
            num_blocks = max_batch * self.max_pages + 1
        self.num_blocks = num_blocks
        self.allocator = BlockAllocator(num_blocks)
        self.pools = T.init_paged_cache(cfg, num_blocks, block_size, kv_dtype,
                                        device=self.device)
        self.page_table = np.full((max_batch, self.max_pages), TRASH_PAGE, np.int32)
        self._owned: list[list[int]] = [[] for _ in range(max_batch)]
        self.peak_pages_in_use = 0

    # -- accounting ------------------------------------------------------------

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` cache rows."""
        return -(-length // self.block_size)

    @property
    def free_pages(self) -> int:
        return self.allocator.free_count

    @property
    def pages_in_use(self) -> int:
        return self.allocator.used_count

    @property
    def page_bytes(self) -> int:
        """Device bytes of one page across all layers: K + V, plus the
        per-page scale rows when the pool is quantized."""
        return sum(leaf.numel() * leaf.element_size() // self.num_blocks
                   for c in self.pools["blocks"].values() for leaf in c.values())

    def stats(self, *, active_slots: int = 0) -> PoolStats:
        return PoolStats(capacity=self.allocator.capacity, in_use=self.pages_in_use,
                         peak_in_use=self.peak_pages_in_use,
                         page_bytes=self.page_bytes, active_slots=active_slots)

    def slot_pages(self, slot: int) -> list[int]:
        return list(self._owned[slot])

    # -- allocation ------------------------------------------------------------

    def alloc(self, slot: int, length: int) -> bool:
        """Grow ``slot``'s pages to cover ``length`` rows (only the missing
        tail).  All-or-nothing; False = the free list can't satisfy it."""
        need = self.pages_for(length) - len(self._owned[slot])
        if need <= 0:
            return True
        pages = self.allocator.alloc(need)
        if pages is None:
            return False
        start = len(self._owned[slot])
        self._owned[slot].extend(pages)
        self.page_table[slot, start: start + len(pages)] = pages
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return True

    def shield(self, slot: int) -> None:
        """Point ``slot``'s table row at trash while keeping ownership: an
        admission in flight is a padding row of the interleaved decode
        steps, whose writes must land in trash, not in its pages."""
        self.page_table[slot, :] = TRASH_PAGE

    def publish(self, slot: int) -> None:
        """Re-expose ``slot``'s owned pages (when it goes active)."""
        pages = self._owned[slot]
        self.page_table[slot, :] = TRASH_PAGE
        self.page_table[slot, : len(pages)] = pages

    def ensure_write(self, slot: int, pos: int) -> bool:
        """Make position ``pos`` writable for ``slot`` (the lazy page fault
        as decode advances).  False = no free page."""
        if not self.alloc(slot, pos + 1):
            return False
        blk = self._owned[slot][pos // self.block_size]
        if self.allocator.refcount(blk) != 1:
            raise NotImplementedError(
                "writing a shared page needs a copy-on-write fork: ROADMAP, "
                "prefix sharing and COW")
        return True

    def truncate(self, slot: int, length: int) -> None:
        """Shrink ``slot``'s pages to cover exactly ``length`` rows: the
        speculative-decode rollback, which returns the pages faulted for
        rejected draft positions to the free list.  The dropped tail must
        be exclusively owned (refcount 1)."""
        keep = self.pages_for(length)
        tail = self._owned[slot][keep:]
        if not tail:
            return
        assert all(self.allocator.refcount(p) == 1 for p in tail), (
            "rollback would drop a shared page", slot, tail)
        self.allocator.free(tail)
        del self._owned[slot][keep:]
        self.page_table[slot, keep:] = TRASH_PAGE

    def release(self, slot: int) -> None:
        """Drop ``slot``'s pages and point its table row at trash."""
        if self._owned[slot]:
            self.allocator.free(self._owned[slot])
            self._owned[slot] = []
        self.page_table[slot, :] = TRASH_PAGE

    def device_page_table(self) -> torch.Tensor:
        """The host table as an int32 tensor on the pools' device."""
        return torch.from_numpy(self.page_table.copy()).to(self.device)

    def check_invariants(self) -> None:
        """Raise :class:`PoolInvariantError` unless allocator refcounts
        match the slots' owned pages and every table row maps exactly its
        slot's pages (or trash while shielded), never another slot's."""
        self.allocator.check_invariants(self._owned)
        for slot, owned in enumerate(self._owned):
            if TRASH_PAGE in owned:
                raise PoolInvariantError("POOL002", f"slot {slot} owns the trash page")
            row = self.page_table[slot]
            n = len(owned)
            if not (row[n:] == TRASH_PAGE).all():
                raise PoolInvariantError(
                    "POOL002", f"slot {slot} maps pages beyond its {n} owned "
                    f"({row.tolist()})")
            bad = [i for i in range(n) if row[i] not in (TRASH_PAGE, owned[i])]
            if bad:
                raise PoolInvariantError(
                    "POOL002", f"slot {slot} table rows {bad} alias pages it does "
                    f"not own ({row[:n].tolist()} vs {owned})")
