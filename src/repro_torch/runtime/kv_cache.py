"""Paged KV cache: a global page pool, a refcounted free list and per-slot
page tables (reference ``runtime/kv_cache.py``, without prefix sharing),
the page scatter and gather that move a request's rows between a b=1
contiguous cache and its pages (admission after a streamed prefill, evict,
readmit), and ``StateStore``, the host-side store of recurrent-state
snapshots.

Each attention unit position owns K and V pools of shape
``(r, num_blocks, block_size, n_kv_heads, head_dim)`` on the device (int8
or fp8 codes plus ``(r, num_blocks, n_kv_heads)`` f32 scales when the pool
is quantized); mamba unit positions keep their O(1) state slot-indexed
(``(r, max_batch, ...)``) beside the pages.  One host-side page table
``(max_batch, max_pages)`` int32 is shared by every layer and copied to the
device per step.  **Block 0 is the trash page**: free and shielded slots'
table rows point at it, so padding rows of the batched decode step write
their garbage there and never into live pages.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.models import transformer as T

TRASH_PAGE = 0  # physical block 0: sink for padding writes, never allocated
PAGED_LEAVES = ("k", "v", "k_scale", "v_scale")  # per-page leaves; the rest are per slot


def scatter_slot_state(dst: dict, src: dict, slot: int) -> None:
    """Overwrite row ``slot`` of every per-slot leaf of ``dst`` (``(r, B,
    ...)``) with the b=1 cache ``src`` (``(r, 1, ...)``), in place."""
    for name, c in dst["blocks"].items():
        for key, leaf in c.items():
            leaf[:, slot: slot + 1].copy_(src["blocks"][name][key])


def gather_slot_state(src: dict, slot: int) -> dict:
    """Row ``slot`` of every leaf of ``src`` (``(r, B, ...)``) as a b=1
    cache (``(r, 1, ...)``): a copy, so later writes to ``src`` leave it
    as it was (the contiguous engine's evict)."""
    return {"blocks": {name: {key: leaf[:, slot: slot + 1].clone()
                              for key, leaf in c.items()}
                       for name, c in src["blocks"].items()}}


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
        self.kv_dtype = quant.validate_kv_dtype(kv_dtype)
        self.compute_dtype = cfg.compute_dtype
        self.allocator = BlockAllocator(num_blocks)
        self.pools = T.init_paged_cache(cfg, max_batch, num_blocks, block_size, kv_dtype,
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
        per-page scale rows when the pool is quantized (0 for a pool of
        slot state only)."""
        return sum(c[k].numel() * c[k].element_size() // self.num_blocks
                   for c in self.pools["blocks"].values() for k in PAGED_LEAVES if k in c)

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

    def scatter(self, slot: int, caches: Any, length: int, *, start_page: int = 0) -> None:
        """Write a b=1 contiguous cache's rows ``[start_page * block_size,
        length)`` into ``slot``'s pages (admission after a streamed prefill,
        or readmit), whole pages at a time, and overwrite its per-slot state
        rows whole (so garbage that padding ticks left in them is gone).
        Over int8/fp8 pools each page is quantized as it is written
        (``scales_of`` over its rows, then ``quantize``), so codes and
        scales move together.  The slot must own ``pages_for(length)``
        pages, and the target pages must be its alone."""
        n_total = self.pages_for(length)
        n = n_total - start_page
        assert n > 0 and len(self._owned[slot]) >= n_total, (
            slot, length, start_page, self._owned[slot])
        target = self._owned[slot][start_page:n_total]
        assert all(self.allocator.refcount(p) == 1 for p in target), (
            "scatter into a shared page would corrupt its sharers", target)
        bs = self.block_size
        pages = torch.tensor(target, dtype=torch.long, device=self.device)
        row0 = start_page * bs
        for name, c in self.pools["blocks"].items():
            src = caches["blocks"][name]
            for key, leaf in c.items():
                if key not in PAGED_LEAVES:  # per-slot state (mamba ssm/conv)
                    leaf[:, slot: slot + 1].copy_(src[key])
                    continue
                if key.endswith("_scale"):
                    continue  # written beside its data leaf
                rows = src[key][:, 0, row0: row0 + n * bs]
                rows = rows.reshape(rows.shape[0], n, bs, *rows.shape[2:])
                skey = f"{key}_scale"
                if skey in c:
                    scales = quant.scales_of(rows, self.kv_dtype)
                    leaf[:, pages] = quant.quantize(rows, scales, self.kv_dtype)
                    c[skey][:, pages] = scales
                else:
                    leaf[:, pages] = rows.to(leaf.dtype)

    def gather(self, slot: int, length: int) -> dict:
        """``slot``'s first ``pages_for(length)`` pages as a b=1 contiguous
        cache of ``n_pages * block_size`` rows, dequantized to
        ``compute_dtype`` over int8/fp8 pools, beside a copy of its per-slot
        state rows (evict: the page contents travel with the request).
        Always a copy."""
        n = self.pages_for(length)
        assert len(self._owned[slot]) >= n, (slot, length, self._owned[slot])
        pages = torch.tensor(self._owned[slot][:n], dtype=torch.long, device=self.device)
        out = {}
        for name, c in self.pools["blocks"].items():
            oc = {}
            for key, leaf in c.items():
                if key not in PAGED_LEAVES:
                    oc[key] = leaf[:, slot: slot + 1].clone()
                    continue
                if key.endswith("_scale"):
                    continue  # folded into the dequantized rows
                g = leaf[:, pages]  # (r, n, bs, hkv, hd), a copy
                skey = f"{key}_scale"
                if skey in c:
                    g = quant.dequantize(g, c[skey][:, pages]).to(self.compute_dtype)
                oc[key] = g.reshape(g.shape[0], n * self.block_size, *g.shape[3:])[:, None]
            out[name] = oc
        return {"blocks": out}

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


class StateStore:
    """Host-side LRU map: chunk-aligned prompt prefix -> recurrent-state
    snapshot (the mamba servable's analog of the prefix registry; the
    reference's ``kv_cache.StateStore``).

    A recurrent SSM compresses the whole prefix into O(1) state, so the
    only shareable artifact is a snapshot of that state at a known token
    boundary: an admission whose prompt extends a stored prefix restores
    the snapshot and streams only the uncovered tail.  Snapshots are host
    copies, and boundaries are multiples of the prefill chunk so a resumed
    prefill dispatches the exact chunk tasks a full prefill would.
    """

    def __init__(self, max_entries: int = 32):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        # digest -> (token bytes, n_tokens, host snapshot)
        self._entries: collections.OrderedDict[bytes, tuple[bytes, int, Any]] = (
            collections.OrderedDict())
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, tokens: np.ndarray, snapshot: Any) -> None:
        """Store a host snapshot for ``tokens`` (LRU-bounded; an existing
        entry for the same tokens is refreshed in place)."""
        tb = np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
        d = hashlib.sha1(tb).digest()
        self._entries[d] = (tb, len(tb) // 4, snapshot)
        self._entries.move_to_end(d)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def lookup(self, tokens: np.ndarray, *, align_tokens: int) -> tuple[int, Any]:
        """Longest stored chunk-aligned *proper* prefix of ``tokens`` ->
        (n_tokens, snapshot); (0, None) on miss.  Stored bytes are compared
        on a hit, so a digest collision can never alias prefixes."""
        if align_tokens < 1:
            raise ValueError(f"align_tokens must be >= 1, got {align_tokens}")
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        top = ((tokens.size - 1) // align_tokens) * align_tokens
        for n in range(top, 0, -align_tokens):
            tb = tokens[:n].tobytes()
            d = hashlib.sha1(tb).digest()
            entry = self._entries.get(d)
            if entry is not None and entry[0] == tb:
                self._entries.move_to_end(d)
                self.hits += 1
                return entry[1], entry[2]
        self.misses += 1
        return 0, None
