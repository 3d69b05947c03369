"""The port's block allocator and paged pool against the reference's: the
same scripted (and seeded random) sequences of alloc, shield, publish,
ensure_write and release leave equal page tables, owned lists, refcounts
and free lists, and ``check_invariants`` holds throughout."""

import numpy as np
import pytest

import repro.configs as RC
from repro.runtime import kv_cache as RK
from repro_torch import configs as PC
from repro_torch.runtime import kv_cache as PK

GEOM = dict(max_batch=3, max_seq=32, block_size=8, num_blocks=10)


@pytest.fixture(scope="module")
def cfgs():
    return RC.get_smoke_config("qwen3-4b"), PC.get_smoke_config("qwen3-4b")


def _pair(cfgs):
    rcfg, pcfg = cfgs
    return RK.PagedKVCache(rcfg, **GEOM), PK.PagedKVCache(pcfg, device="cpu", **GEOM)


def _assert_same(ref, port):
    np.testing.assert_array_equal(port.page_table, ref.page_table)
    assert port._owned == ref._owned
    assert port.allocator._free == ref.allocator._free
    assert port.allocator._ref == ref.allocator._ref
    assert (port.free_pages, port.pages_in_use, port.peak_pages_in_use) == (
        ref.free_pages, ref.pages_in_use, ref.peak_pages_in_use)
    port.check_invariants()
    ref.check_invariants()


SCRIPT = [
    ("alloc", 0, 9), ("shield", 0), ("publish", 0), ("alloc", 1, 20),
    ("ensure_write", 0, 16), ("ensure_write", 0, 17), ("shield", 1),
    ("release", 1), ("alloc", 2, 30), ("shield", 2), ("ensure_write", 2, 31),
    ("publish", 2), ("alloc", 1, 32), ("alloc", 1, 8), ("ensure_write", 1, 8),
    ("ensure_write", 1, 16), ("release", 0), ("ensure_write", 1, 24),
    ("release", 2), ("release", 1),
]


def _apply(kv, op):
    name, slot, *arg = op
    return getattr(kv, name)(slot, *arg)


def test_scripted_sequence_matches_reference(cfgs):
    ref, port = _pair(cfgs)
    for op in SCRIPT:
        assert _apply(port, op) == _apply(ref, op), op
        _assert_same(ref, port)
    assert port.pages_in_use == 0 and port.free_pages == port.allocator.capacity


def test_random_sequence_matches_reference(cfgs):
    ref, port = _pair(cfgs)
    rng = np.random.default_rng(0)
    for _ in range(300):
        slot = int(rng.integers(GEOM["max_batch"]))
        kind = rng.choice(["alloc", "ensure_write", "shield", "publish", "release"])
        op = ((kind, slot, int(rng.integers(1, GEOM["max_seq"] + 1)))
              if kind in ("alloc", "ensure_write") else (kind, slot))
        if kind == "ensure_write":
            op = (kind, slot, op[2] - 1)
        assert _apply(port, op) == _apply(ref, op), op
        _assert_same(ref, port)


def test_pool_layout_and_accounting(cfgs):
    ref, port = _pair(cfgs)
    for name, leaf in port.pools["blocks"].items():
        for key in ("k", "v"):
            assert tuple(leaf[key].shape) == ref.pools["blocks"][name][key].shape
    assert port.page_bytes == ref.page_bytes
    assert port.pages_for(17) == ref.pages_for(17) == 3
    port.alloc(0, 12)
    st = port.stats(active_slots=1)
    assert (st.capacity, st.in_use, st.active_slots) == (9, 2, 1)
    snap = port.device_page_table()
    np.testing.assert_array_equal(snap.numpy(), port.page_table)
    first = int(port.page_table[0, 0])
    port.page_table[0, 0] = 7  # the device copy is a snapshot, not a view
    assert snap[0, 0].item() == first
    assert port.device_page_table()[0, 0].item() == 7


def test_invariant_checks_catch_corruption(cfgs):
    _, port = _pair(cfgs)
    port.alloc(0, 16)
    port.alloc(1, 8)
    port.page_table[1, 0] = port._owned[0][0]  # alias another slot's page
    with pytest.raises(PK.PoolInvariantError, match="POOL002"):
        port.check_invariants()
    port.publish(1)
    port.allocator._free.append(port._owned[0][0])  # free while referenced
    with pytest.raises(PK.PoolInvariantError, match="POOL003"):
        port.check_invariants()
    port.allocator._free.pop()
    port.check_invariants()
    with pytest.raises(ValueError, match="double free"):
        port.allocator.free([port.allocator._free[-1]])
    with pytest.raises(ValueError, match="trash"):
        PK.BlockAllocator(1)
