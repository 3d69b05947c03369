"""Paged KV cache: a global page pool, a refcounted free list and per-slot
page tables (reference ``runtime/kv_cache.py``), the page scatter and
gather that move a request's rows between a b=1 contiguous cache and its
pages (admission after a streamed prefill, evict, readmit), prefix sharing
with copy-on-write and its on-disk store, and ``StateStore``, the
host-side store of recurrent-state snapshots.

**Prefix sharing** is the paper's SYNC transfer in serving form: a prompt
prefix common to many requests (a system prompt) is staged once.
``PrefixRegistry`` maps page-aligned prefix tokens to their physical
blocks, so later admissions map the same blocks into their tables at
refcount + 1 and prefill only the uncovered tail.  A block returns to the
free list at refcount zero; a write into a shared block forks it first
(``ensure_write``'s copy-on-write, which copies the scale rows with a
quantized page), so no sharer sees another's divergence.

Each attention unit position owns K and V pools of shape
``(r, num_blocks, block_size, n_kv_heads, head_dim)`` on the device (int8
or fp8 codes plus ``(r, num_blocks, n_kv_heads)`` f32 scales when the pool
is quantized); mamba unit positions keep their O(1) state slot-indexed
(``(r, max_batch, ...)``) beside the pages, and so do whisper's
cross-attention K/V (``encoder_seq`` rows a slot).  One host-side page table
``(max_batch, max_pages)`` int32 is shared by every layer and copied to the
device per step.  **Block 0 is the trash page**: free and shielded slots'
table rows point at it, so padding rows of the batched decode step write
their garbage there and never into live pages.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.budget import tick_path, transfer_budget
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.models import transformer as T
from repro_torch.runtime.graphs import _JIT_CACHE_CAP, Graphs, StepGraph, lru_get

#: On-disk prefix-store schema (the reference's); a mismatched file is
#: ignored wholesale (cold start), never misread.
PREFIX_STORE_SCHEMA = 1

TRASH_PAGE = 0  # physical block 0: sink for padding writes, never allocated
PAGED_LEAVES = ("k", "v", "k_scale", "v_scale")  # per-page leaves; the rest are per slot


def zero_cache(caches: dict) -> dict:
    """Zero every leaf of a cache tree in place; returns it."""
    for c in caches["blocks"].values():
        for leaf in c.values():
            leaf.zero_()
    return caches


def copy_front(dst: dict, src: dict) -> None:
    """Copy each leaf of ``src`` into the front of ``dst``'s leaf (the K/V
    rows a b=1 cache holds, or a per-slot state leaf whole), in place."""
    for name, c in src["blocks"].items():
        for key, leaf in c.items():
            d = dst["blocks"][name][key]
            if key in ("k", "v"):
                d[:, :, : leaf.shape[2]].copy_(leaf)
            else:
                d.copy_(leaf)


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
    """A pool invariant does not hold; ``rule`` names it as the analyzer
    does (POOL001 refcounts, POOL002 table ownership, POOL003 free list,
    POOL005 quant scale layout).  Raised by ``check_invariants`` and by the
    ``REPRO_SANITIZE=1`` runtime sanitizer (``analysis.poolcheck``)."""

    def __init__(self, rule: str, msg: str):
        super().__init__(f"{rule}: {msg}")
        self.rule = rule


class BlockAllocator:
    """Refcounted free list over physical blocks 1..num_blocks-1.

    ``alloc`` is all-or-nothing; blocks come out at refcount 1, sharers take
    more references with ``incref``, and every ``free`` drops one: a block
    returns to the (LIFO) free list when its last reference goes.
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
        """Physical blocks held (a shared block counts once)."""
        return len(self._ref)

    @property
    def shared_count(self) -> int:
        """Physical blocks referenced by more than one holder."""
        return sum(1 for r in self._ref.values() if r > 1)

    @property
    def total_refs(self) -> int:
        """Logical references; ``total_refs - used_count`` copies avoided."""
        return sum(self._ref.values())

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

    def incref(self, pages: list[int]) -> None:
        """Add one reference per page (sharing an allocated block)."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"cannot share unallocated page {p}")
        for p in pages:
            self._ref[p] += 1

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

    def check_invariants(self, holders=None, registry_use=None) -> None:
        """Raise :class:`PoolInvariantError` unless the free list holds each
        usable page at most once, never trash or a referenced page, and
        together with the references accounts for every page; with
        ``holders`` (per-slot owned pages) and ``registry_use`` (the prefix
        registry's distinct retained blocks, one reference each), each
        refcount equals the page's occurrences across the holders plus its
        registry retention, and the refcount sum equals mapped pages plus
        registry references (POOL001)."""
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
        if registry_use is not None:
            expect.update(dict.fromkeys(registry_use, 1))
        for p in self._ref.keys() | expect.keys():
            if self._ref.get(p, 0) != expect.get(p, 0):
                raise PoolInvariantError(
                    "POOL001", f"page {p}: refcount {self._ref.get(p, 0)} != "
                    f"{expect.get(p, 0)} holders (slot mappings + registry retention)")
        if self.total_refs != sum(expect.values()):
            raise PoolInvariantError(
                "POOL001", f"refcount sum {self.total_refs} != "
                f"{sum(expect.values())} mapped pages + registry refs")


class PrefixRegistry:
    """Host-side LRU map: page-aligned prompt-prefix tokens -> block list
    (reference ``kv_cache.PrefixRegistry``).

    The key is a digest of the token bytes, and the stored bytes are
    compared on a hit, so a digest collision never aliases two prefixes.
    Entries of one prompt nest (lengths 1..n pages share blocks), so the
    registry counts each block's use across entries and holds exactly one
    allocator reference per distinct block: ``put`` / ``pop_lru`` /
    ``clear`` / ``drop_stranded`` return the blocks whose registry-wide use
    crossed zero, for the caller to ``incref`` / ``free``.
    """

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        # digest -> (token bytes, blocks)
        self._entries: collections.OrderedDict[bytes, tuple[bytes, list[int]]] = (
            collections.OrderedDict())
        self._block_use: collections.Counter = collections.Counter()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def blocks_held(self) -> int:
        """Distinct blocks the registry holds a retention reference on."""
        return len(self._block_use)

    def entries(self) -> list[tuple[bytes, list[int]]]:
        """(token bytes, blocks) per entry, least recently used first."""
        return [(tb, list(blocks)) for tb, blocks in self._entries.values()]

    @staticmethod
    def _digest(token_bytes: bytes) -> bytes:
        return hashlib.sha1(token_bytes).digest()

    def _retain(self, blocks: list[int]) -> list[int]:
        """Track an entry's blocks; returns those newly used (0 -> 1)."""
        fresh = [b for b in blocks if self._block_use[b] == 0]
        self._block_use.update(blocks)
        return fresh

    def _release(self, blocks: list[int]) -> list[int]:
        """Untrack an entry's blocks; returns those no longer used."""
        gone = []
        for b in blocks:
            self._block_use[b] -= 1
            if self._block_use[b] == 0:
                del self._block_use[b]
                gone.append(b)
        return gone

    def get(self, tokens: np.ndarray, *, count: bool = True) -> list[int] | None:
        """Exact-length probe.  ``count=False`` leaves the hit / miss
        counters alone: a longest-match descent probes many lengths for one
        logical lookup and records its one outcome with ``record_lookup``."""
        tb = np.ascontiguousarray(tokens).tobytes()
        d = self._digest(tb)
        entry = self._entries.get(d)
        if entry is None or entry[0] != tb:
            if count:
                self.misses += 1
            return None
        self._entries.move_to_end(d)
        if count:
            self.hits += 1
        return list(entry[1])

    def record_lookup(self, hit: bool) -> None:
        """Count one logical (admission-level) lookup outcome."""
        if hit:
            self.hits += 1
        else:
            self.misses += 1

    def put(self, tokens: np.ndarray, blocks: list[int]) -> tuple[list[int], list[int]]:
        """Insert; returns (blocks to incref, blocks to free): the
        registry-wide reference changes this insert caused, LRU overflow
        and digest-collision drops included."""
        tb = np.ascontiguousarray(tokens).tobytes()
        d = self._digest(tb)
        released: list[int] = []
        if d in self._entries:
            if self._entries[d][0] == tb:
                self._entries.move_to_end(d)
                return [], []
            released += self._release(self._entries.pop(d)[1])  # collision
        self._entries[d] = (tb, list(blocks))
        retained = self._retain(blocks)
        while len(self._entries) > self.max_entries:
            released += self._release(self._entries.popitem(last=False)[1][1])
        return retained, released

    def pop_lru(self) -> list[int] | None:
        """Drop the least recently used entry; returns the blocks it was
        the last entry to use (None when the registry is empty)."""
        if not self._entries:
            return None
        return self._release(self._entries.popitem(last=False)[1][1])

    def clear(self) -> list[int]:
        """Drop every entry; returns every block the registry used."""
        out = list(self._block_use)
        self._entries.clear()
        self._block_use.clear()
        return out

    def drop_stranded(self, align_tokens: int) -> list[int]:
        """Drop entries whose token length is not a multiple of
        ``align_tokens`` (stranded by a change of the prefill chunk: the
        chunk-aligned lookup never probes their lengths again); returns the
        blocks no surviving entry uses."""
        if align_tokens < 1:
            raise ValueError(f"align_tokens must be >= 1, got {align_tokens}")
        stranded = [d for d, (tb, _) in self._entries.items()
                    if (len(tb) // 4) % align_tokens]  # int32 token bytes
        released: list[int] = []
        for d in stranded:
            released += self._release(self._entries.pop(d)[1])
        return released


def _config_digest(cfg: ModelConfig) -> str:
    """The reference's stable hash over every ``ModelConfig`` field, types
    by their canonical names (a torch type by its name without
    ``torch.``), so a config and its reference twin hash alike: the prefix
    store's staleness key."""

    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {k: norm(x) for k, x in sorted(dataclasses.asdict(v).items())}
        if isinstance(v, torch.dtype):
            return str(v).removeprefix("torch.")
        try:
            return np.dtype(v).name
        except TypeError:
            return v

    fields = {f.name: norm(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


def _page_array(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of page rows for the store: the numpy array where numpy
    has the type, else (bf16, fp8) the bytes as unsigned integers of the
    same width; ``load_prefixes`` reinterprets the bytes as the pool's
    type."""
    leaf = leaf.cpu().contiguous()
    try:
        return leaf.numpy()
    except TypeError:
        return leaf.view({1: torch.uint8, 2: torch.uint16}[leaf.element_size()]).numpy()


@dataclasses.dataclass(frozen=True)
class PoolStats:
    """Point-in-time pool accounting."""

    capacity: int  # usable pages
    in_use: int
    peak_in_use: int
    page_bytes: int  # bytes of one page across all layers (K + V)
    active_slots: int
    shared_pages: int = 0  # physical pages referenced by more than one holder
    total_refs: int = 0  # logical references (slot mappings + registry)
    registry_pages: int = 0  # pages the prefix registry retains

    @property
    def utilization(self) -> float:
        return self.in_use / self.capacity if self.capacity else 0.0

    @property
    def bytes_in_use(self) -> int:
        return self.in_use * self.page_bytes

    @property
    def bytes_saved(self) -> int:
        """Device bytes that slot mappings beyond the first copy would have
        duplicated without sharing; the registry's own retention reference
        saves nothing by itself and is left out."""
        return max(0, self.total_refs - self.in_use - self.registry_pages) * self.page_bytes


class PagedKVCache:
    """Device page pools + host page tables for the batched engine.

    The page moves (``scatter``, ``gather``, ``load_prefix``) run as step
    graphs keyed by page count, in LRU caches capped by ``jit_cache_cap``
    (``_JIT_CACHE_CAP`` when None), as the reference's jitted helpers.  The
    page list and the slot are static index inputs, so a graph bakes in
    neither.  A move reads or writes the b=1 ``staging`` cache (the
    engine's request cache, or the pool's own made at first use); a cache
    that is not it is copied in or out around the graph."""

    def __init__(self, cfg: ModelConfig, *, max_batch: int, max_seq: int,
                 block_size: int, num_blocks: int | None = None,
                 kv_dtype: str = "fp32", device=None, jit_cache_cap: int | None = None,
                 graphs: Graphs | None = None, staging=None):
        if max_seq % block_size != 0:
            raise ValueError(
                f"max_seq {max_seq} must be a multiple of block_size {block_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
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
        self.registry = PrefixRegistry()
        self.pools = T.init_paged_cache(cfg, max_batch, num_blocks, block_size, kv_dtype,
                                        device=self.device)
        self.page_table = np.full((max_batch, self.max_pages), TRASH_PAGE, np.int32)
        self._owned: list[list[int]] = [[] for _ in range(max_batch)]
        self.peak_pages_in_use = 0
        self.cow_forks = 0
        # Did the newest lookup_prefix probe at all?  (The engine counts one
        # outcome per admission, and none for a prompt too short to probe.)
        self.last_lookup_probed = False
        self.graphs = graphs if graphs is not None else Graphs(self.device)
        self._jit_cap = jit_cache_cap if jit_cache_cap else _JIT_CACHE_CAP
        self._scatter_jit: collections.OrderedDict = collections.OrderedDict()
        self._gather_jit: collections.OrderedDict = collections.OrderedDict()
        self._load_jit: collections.OrderedDict = collections.OrderedDict()
        self._staging_fn = staging
        self._staging: dict | None = None
        # Opt-in runtime sanitizer: re-check the full invariant set after
        # every mutating method (analysis.poolcheck shares the predicates
        # with the static audit).  Counted so callers can see it ran.
        self.sanitize_checks = 0
        if os.environ.get("REPRO_SANITIZE"):
            from repro_torch.analysis.poolcheck import attach_sanitizer
            attach_sanitizer(self)

    def staging(self) -> dict:
        """The b=1 full-length cache the page moves read and write."""
        if self._staging_fn is not None:
            return self._staging_fn()
        if self._staging is None:
            self._staging = T.init_cache(self.cfg, 1, self.max_seq, ring=False,
                                         device=self.device)
        return self._staging

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
                         page_bytes=self.page_bytes, active_slots=active_slots,
                         shared_pages=self.allocator.shared_count,
                         total_refs=self.allocator.total_refs,
                         registry_pages=self.registry.blocks_held)

    def slot_pages(self, slot: int) -> list[int]:
        return list(self._owned[slot])

    # -- allocation ------------------------------------------------------------

    def _alloc_blocks(self, n: int) -> list[int] | None:
        """Free-list alloc with prefix reclaim: while short, drop the least
        recently used registry entry (its blocks free once no slot shares
        them) until the request fits or the registry is empty."""
        pages = self.allocator.alloc(n)
        while pages is None:
            dropped = self.registry.pop_lru()
            if dropped is None:
                return None
            self.allocator.free(dropped)
            pages = self.allocator.alloc(n)
        return pages

    def alloc(self, slot: int, length: int) -> bool:
        """Grow ``slot``'s pages to cover ``length`` rows (only the missing
        tail).  All-or-nothing; False = the free list can't satisfy it,
        even after reclaiming registered prefixes."""
        need = self.pages_for(length) - len(self._owned[slot])
        if need <= 0:
            return True
        pages = self._alloc_blocks(need)
        if pages is None:
            return False
        start = len(self._owned[slot])
        self._owned[slot].extend(pages)
        self.page_table[slot, start: start + len(pages)] = pages
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return True

    def map_shared(self, slot: int, blocks: list[int]) -> None:
        """Map resident prefix blocks into the front of ``slot``'s table at
        refcount + 1 (the SYNC prefix staged once, not copied).  The slot
        must be empty: sharing happens at admission and readmission."""
        assert not self._owned[slot], (slot, self._owned[slot])
        self.allocator.incref(blocks)
        self._owned[slot] = list(blocks)
        self.page_table[slot, : len(blocks)] = blocks

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

    @tick_path(allowed_fetches=0)
    def ensure_write(self, slot: int, pos: int) -> bool:
        """Make position ``pos`` writable for ``slot`` (the lazy page fault
        as decode advances).  A shared target page is forked first
        (copy-on-write): the write lands in a private copy, so the other
        sharers never see this slot's divergence.  False = no free page
        (a shared mapping stays valid)."""
        if not self.alloc(slot, pos + 1):
            return False
        idx = pos // self.block_size
        blk = self._owned[slot][idx]
        if self.allocator.refcount(blk) == 1:
            return True
        fresh = self._alloc_blocks(1)
        if fresh is None:
            return False
        self._copy_block(blk, fresh[0])
        self.allocator.free([blk])  # this slot's reference only
        self._owned[slot][idx] = fresh[0]
        self.page_table[slot, idx] = fresh[0]
        self.cow_forks += 1
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return True

    def _copy_block(self, src: int, dst: int) -> None:
        """The COW fork's page copy on the device: every page leaf of every
        layer, the scale rows of a quantized page with it."""
        for c in self.pools["blocks"].values():
            for key, leaf in c.items():
                if key in PAGED_LEAVES:
                    leaf[:, dst].copy_(leaf[:, src])

    @tick_path(allowed_fetches=0)
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
        """Drop ``slot``'s page references and point its table row at
        trash; blocks other slots or the registry still hold stay."""
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
        pages, and the target pages must be its alone.  ``caches`` that is
        not the staging cache (a readmission's gathered pages) is copied
        into its front first."""
        n_total = self.pages_for(length)
        n = n_total - start_page
        assert n > 0 and len(self._owned[slot]) >= n_total, (
            slot, length, start_page, self._owned[slot])
        target = self._owned[slot][start_page:n_total]
        assert all(self.allocator.refcount(p) == 1 for p in target), (
            "scatter into a shared page would corrupt its sharers", target)
        if caches is not self.staging():
            copy_front(self.staging(), caches)
        row0 = start_page * self.block_size
        step = lru_get(self._scatter_jit, n, lambda: self._make_scatter(n), cap=self._jit_cap)
        step(pages=target, rows=np.arange(row0, row0 + n * self.block_size), slot=slot)

    @transfer_budget(d2h_arrays=0, d2h_outputs=())
    def _make_scatter(self, n: int) -> StepGraph:
        """Static inputs ``pages`` (n,), ``rows`` (n * block_size,) of the
        staging cache, ``slot`` (1,)."""
        bs, pools, src_tree, kv_dtype = self.block_size, self.pools, self.staging(), self.kv_dtype

        @torch.inference_mode()
        def fn(pages, rows, slot):
            for name, c in pools["blocks"].items():
                src = src_tree["blocks"][name]
                for key, leaf in c.items():
                    if key not in PAGED_LEAVES:  # per-slot state (ssm/conv, cross K/V)
                        leaf.index_copy_(1, slot, src[key])
                        continue
                    if key.endswith("_scale"):
                        continue  # written beside its data leaf
                    r = src[key][:, 0].index_select(1, rows)
                    r = r.reshape(r.shape[0], n, bs, *r.shape[2:])
                    skey = f"{key}_scale"
                    if skey in c:
                        scales = quant.scales_of(r, kv_dtype)
                        leaf[:, pages] = quant.quantize(r, scales, kv_dtype)
                        c[skey][:, pages] = scales
                    else:
                        leaf[:, pages] = r.to(leaf.dtype)
        return StepGraph(self.graphs, fn, {"pages": ((n,), torch.long),
                                           "rows": ((n * bs,), torch.long),
                                           "slot": ((1,), torch.long)})

    def gather(self, slot: int, length: int) -> dict:
        """``slot``'s first ``pages_for(length)`` pages as a b=1 contiguous
        cache of ``n_pages * block_size`` rows, dequantized to
        ``compute_dtype`` over int8/fp8 pools, beside a copy of its per-slot
        state rows (evict: the page contents travel with the request).
        Always a copy of its own."""
        n = self.pages_for(length)
        assert len(self._owned[slot]) >= n, (slot, length, self._owned[slot])
        step = lru_get(self._gather_jit, n, lambda: self._make_gather(n), cap=self._jit_cap)
        out = step(pages=self._owned[slot][:n]) if step is not None else {}
        blocks = {}
        for name, c in self.pools["blocks"].items():
            oc = {k: v.clone() for k, v in out.get(name, {}).items()}
            for key, leaf in c.items():
                # Per-slot state is copied outside the graph: a graph's outputs
                # stay in its pool, and whisper's cross K/V are ~147 MB a slot.
                if key not in PAGED_LEAVES:
                    oc[key] = leaf[:, slot: slot + 1].clone()
            blocks[name] = oc
        return {"blocks": blocks}

    @transfer_budget(d2h_arrays=0, d2h_outputs=())
    def _make_gather(self, n: int) -> StepGraph | None:
        """Static input ``pages`` (n,); the graph gathers the paged leaves
        only (None when there are none: a pure mamba pool)."""
        bs, pools, dtype = self.block_size, self.pools, self.compute_dtype
        if not any(k in PAGED_LEAVES for c in pools["blocks"].values() for k in c):
            return None

        @torch.inference_mode()
        def fn(pages):
            out = {}
            for name, c in pools["blocks"].items():
                oc = {}
                for key, leaf in c.items():
                    if key not in PAGED_LEAVES or key.endswith("_scale"):
                        continue  # per-slot state; scales fold into the rows
                    g = leaf[:, pages]  # (r, n, bs, hkv, hd), a copy
                    skey = f"{key}_scale"
                    if skey in c:
                        g = quant.dequantize(g, c[skey][:, pages]).to(dtype)
                    oc[key] = g.reshape(g.shape[0], n * bs, *g.shape[3:])[:, None]
                out[name] = oc
            return out
        return StepGraph(self.graphs, fn, {"pages": ((n,), torch.long)})

    def load_prefix(self, caches: dict, blocks: list[int]) -> dict:
        """Copy ``blocks``' rows into the front of a b=1 contiguous cache,
        dequantized over int8 / fp8 pools: the prefill context of a
        non-fused admission's uncovered tail.  In place; returns
        ``caches`` (copied out of the staging cache when it is not it)."""
        n = len(blocks)
        assert n > 0
        step = lru_get(self._load_jit, n, lambda: self._make_load(n), cap=self._jit_cap)
        step(pages=blocks)
        staged = self.staging()
        if caches is not staged:
            rows = n * self.block_size
            for name, dst in caches["blocks"].items():
                for key in ("k", "v"):
                    if key in dst and key in self.pools["blocks"].get(name, {}):
                        dst[key][:, 0, :rows] = staged["blocks"][name][key][:, 0, :rows]
        return caches

    @transfer_budget(d2h_arrays=0, d2h_outputs=())
    def _make_load(self, n: int) -> StepGraph:
        """Static input ``pages`` (n,); writes the staging cache's first
        ``n * block_size`` K/V rows."""
        bs, pools, dst_tree = self.block_size, self.pools, self.staging()

        @torch.inference_mode()
        def fn(pages):
            for name, dst in dst_tree["blocks"].items():
                c = pools["blocks"].get(name, {})
                for key in ("k", "v"):
                    if key not in c or key not in dst:
                        continue
                    g = c[key][:, pages]  # (r, n, bs, hkv, hd)
                    skey = f"{key}_scale"
                    if skey in c:
                        g = quant.dequantize(g, c[skey][:, pages])
                    rows = g.reshape(g.shape[0], n * bs, *g.shape[3:])
                    dst[key][:, 0, : n * bs] = rows.to(dst[key].dtype)
        return StepGraph(self.graphs, fn, {"pages": ((n,), torch.long)})

    @tick_path(allowed_fetches=0)
    def device_page_table(self) -> torch.Tensor:
        """The host table as an int32 tensor on the pools' device; on a card
        through pinned memory, with no host wait."""
        table = torch.from_numpy(self.page_table.copy())
        if self.device.type == "cuda":
            table = table.pin_memory()
        return table.to(self.device, non_blocking=True)

    def check_invariants(self) -> None:
        """Raise :class:`PoolInvariantError` unless allocator refcounts
        match the slots' owned pages plus the registry's retentions
        (POOL001 / POOL003), every table row maps exactly its slot's pages
        (or trash while shielded), never another slot's, and the registry
        retains only allocated pages, never trash (POOL002), and a
        quantized pool's scale leaves travel with their pages (POOL005).
        Host-side metadata only: nothing waits on the device."""
        use = self.registry._block_use
        self.allocator.check_invariants(self._owned, use)
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
        for b in use:
            if b == TRASH_PAGE:
                raise PoolInvariantError("POOL002", "the prefix registry retains the trash page")
            if self.allocator.refcount(b) < 1:
                raise PoolInvariantError("POOL001", f"registry retains unallocated page {b}")
        if quant.is_quantized(self.kv_dtype):
            st = quant.storage_dtype(self.kv_dtype)
            for name, c in self.pools["blocks"].items():
                for key in ("k", "v"):
                    leaf = c.get(key)
                    if leaf is None or leaf.dim() < 2 or leaf.shape[1] != self.num_blocks:
                        continue  # per-slot state, not a page pool
                    if leaf.dtype != st:
                        raise PoolInvariantError(
                            "POOL005", f"{name}.{key}: pool dtype {leaf.dtype} != declared "
                            f"storage {st}")
                    sc = c.get(f"{key}_scale")
                    if sc is None:
                        raise PoolInvariantError(
                            "POOL005", f"{name}.{key}: quantized pool leaf has no scale "
                            "leaf (scales must travel with their page)")
                    if sc.dtype != torch.float32 or sc.shape[:2] != leaf.shape[:2]:
                        raise PoolInvariantError(
                            "POOL005", f"{name}.{key}_scale: scale layout "
                            f"{tuple(sc.shape)}/{sc.dtype} does not ride the page axis of "
                            f"{tuple(leaf.shape)} as f32")
        self.sanitize_checks += 1

    # -- prefix registry (the SYNC transfer, staged once) ------------------------

    def lookup_prefix(self, tokens: np.ndarray, *, min_pages: int = 1,
                      align_tokens: int = 1, count: bool = True) -> tuple[int, list[int]]:
        """Longest registered page-aligned *proper* prefix of ``tokens`` ->
        (n_pages, blocks); (0, []) on a miss.  ``align_tokens`` keeps matches
        on multiples of the prefill chunk, so the uncovered tail re-runs the
        chunk tasks a full prefill would.  The descent is one logical
        lookup: with ``count`` at most one hit or miss lands on the
        registry's counters, and none when no length was probed
        (``last_lookup_probed`` says which)."""
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        probed = False
        hit: tuple[int, list[int]] | None = None
        for n in range((len(tokens) - 1) // bs, max(1, min_pages) - 1, -1):
            if align_tokens > 1 and (n * bs) % align_tokens:
                continue
            probed = True
            blocks = self.registry.get(tokens[: n * bs], count=False)
            if blocks is not None:
                hit = (n, blocks)
                break
        self.last_lookup_probed = probed
        if count and probed:
            self.registry.record_lookup(hit is not None)
        return hit if hit is not None else (0, [])

    def register_prefix(self, tokens: np.ndarray, slot: int, *, min_pages: int = 1,
                        align_tokens: int = 1) -> None:
        """Publish the page-aligned prefixes of ``slot``'s prompt (at the
        lengths an ``align_tokens`` lookup probes) so later admissions can
        map its blocks.  The slot's decode writes start at ``len(tokens)``,
        so registered whole pages stay immutable until a COW fork or a
        reclaim."""
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        owned = self._owned[slot]
        for n in range(max(1, min_pages), len(tokens) // bs + 1):
            if align_tokens > 1 and (n * bs) % align_tokens:
                continue
            retained, released = self.registry.put(tokens[: n * bs], owned[:n])
            if retained:
                self.allocator.incref(retained)
            if released:
                self.allocator.free(released)

    def reclaim_for(self, n: int) -> bool:
        """Drop least recently used prefix entries until ``n`` pages are
        free.  False = the registry ran dry first (the pool is full of
        slot-held pages: backpressure or preempt)."""
        while self.allocator.free_count < n:
            dropped = self.registry.pop_lru()
            if dropped is None:
                return False
            self.allocator.free(dropped)
        return True

    def clear_prefixes(self) -> None:
        """Drop every registry entry (frees blocks no slot still shares)."""
        self.allocator.free(self.registry.clear())

    def clear_stranded_prefixes(self, align_tokens: int) -> int:
        """Drop entries stranded by a prefill-chunk change (their lengths
        are off the new chunk grid, so no lookup matches them again);
        returns how many were dropped."""
        before = len(self.registry)
        self.allocator.free(self.registry.drop_stranded(align_tokens))
        return before - len(self.registry)

    # -- prefix persistence (the registry outlives an engine) --------------------

    def save_prefixes(self, path: str | os.PathLike) -> int:
        """Write the registry (token keys, block lists and the pages they
        use) to ``path`` as the reference's npz, through a temporary file
        and ``os.replace``.  Returns the entries written; 0 writes nothing
        and leaves an existing file as it is."""
        entries = self.registry.entries()
        if not entries:
            return 0
        distinct = list(dict.fromkeys(b for _, blocks in entries for b in blocks))
        idx = torch.tensor(distinct, dtype=torch.long, device=self.device)
        arrays: dict[str, np.ndarray] = {}
        for name, c in self.pools["blocks"].items():
            for key in PAGED_LEAVES:
                if key in c:
                    arrays[f"pool.{name}.{key}"] = _page_array(c[key][:, idx])
        for i, (tb, blocks) in enumerate(entries):
            arrays[f"entry{i}.tokens"] = np.frombuffer(tb, np.int32)
            arrays[f"entry{i}.blocks"] = np.asarray(blocks, np.int64)
        # The pool's type is a staleness key: codes are not loadable rows of
        # a pool of another type, so a mismatched store is rejected.
        meta = {"schema": PREFIX_STORE_SCHEMA, "model": _config_digest(self.cfg),
                "block_size": self.block_size, "kv_dtype": self.kv_dtype,
                "blocks": distinct, "n_entries": len(entries)}
        arrays["meta"] = np.frombuffer(json.dumps(meta, sort_keys=True).encode(), np.uint8)
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        return len(entries)

    def load_prefixes(self, path: str | os.PathLike) -> int:
        """Restore a saved registry into this pool; returns the entries
        restored.  A store of another schema, model config, block size or
        ``kv_dtype``, with page arrays of another shape or width, or that
        cannot be read, restores nothing (0), and so does a pool too small
        for it.  Saved blocks are remapped onto fresh blocks whose one
        reference is the registry's retention, as if a slot that has since
        retired had registered them."""
        path = pathlib.Path(path)
        if not path.exists():
            return 0
        try:
            data = np.load(path, allow_pickle=False)
        except (OSError, ValueError):
            return 0
        try:
            if "meta" not in data:
                return 0
            meta = json.loads(bytes(data["meta"].tobytes()))
            if (meta.get("schema") != PREFIX_STORE_SCHEMA
                    or meta.get("model") != _config_digest(self.cfg)
                    or meta.get("block_size") != self.block_size
                    or meta.get("kv_dtype", "fp32") != self.kv_dtype):
                return 0
            old_ids = [int(b) for b in meta.get("blocks", [])]
            n = len(old_ids)
            if n == 0 or len(set(old_ids)) != n:
                return 0
            pages: dict[tuple[str, str], np.ndarray] = {}
            for name, c in self.pools["blocks"].items():
                for key in PAGED_LEAVES:
                    if key not in c:
                        continue
                    akey = f"pool.{name}.{key}"
                    if akey not in data:
                        return 0
                    arr, leaf = data[akey], c[key]
                    want = (leaf.shape[0], n, *leaf.shape[2:])
                    if tuple(arr.shape) != want or arr.itemsize != leaf.element_size():
                        return 0
                    pages[(name, key)] = arr
            raw_entries: list[tuple[np.ndarray, list[int]]] = []
            for i in range(int(meta.get("n_entries", 0))):
                toks = np.asarray(data[f"entry{i}.tokens"], np.int32)
                blocks = [int(b) for b in data[f"entry{i}.blocks"]]
                if not blocks or any(b not in old_ids for b in blocks):
                    return 0
                raw_entries.append((toks, blocks))
        except (KeyError, ValueError):
            return 0
        finally:
            data.close()
        if not raw_entries:
            return 0
        new = self.allocator.alloc(n)
        if new is None:  # the pool is too small for the store: cold start
            return 0
        mapping = dict(zip(old_ids, new))
        nidx = torch.tensor(new, dtype=torch.long, device=self.device)
        for (name, key), arr in pages.items():
            leaf = self.pools["blocks"][name][key]
            rows = torch.frombuffer(bytearray(np.ascontiguousarray(arr).tobytes()),
                                    dtype=leaf.dtype).reshape(arr.shape)
            leaf[:, nidx] = rows.to(self.device)
        new_set = set(new)
        released_ext: list[int] = []
        for toks, blocks in raw_entries:  # oldest first: the LRU order survives
            # alloc's reference is the retention reference (no incref here);
            # blocks outside this restore settle in the sweep below.
            _, released = self.registry.put(toks, [mapping[b] for b in blocks])
            released_ext += [b for b in released if b not in new_set]
        use = self.registry._block_use
        self.allocator.free([b for b in released_ext if b not in use])
        self.allocator.free([b for b in new if b not in use])
        return len(raw_entries)


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

    def clear(self) -> None:
        self._entries.clear()
