"""Prefix sharing with copy-on-write in the port against the JAX engine and
pool on the CPU, f32, equal weights through the bridge.  Each scenario of
``tests/test_kv_cache.py`` (refcounted allocator, COW isolation, token
parity with fewer pages, registry reclaim, registry counters, stranded
entries), ``tests/test_quant_kv.py`` (the scale rows fork with their page,
int8 sharing, the store's ``kv_dtype`` key) and ``tests/test_spec_decode.py``
(spec with sharing, the readmission re-map and its gate) runs the same
script on both: what it observes, the tokens per uid and the sharing
counters (``prefix_hits``, ``prefix_pages_shared``, ``cow_forks``,
``peak_pages_in_use``, the registry's hits and misses, ``readmit_prefix_*``)
must be equal.  The prefix store round-trips, rejects a store of another
``kv_dtype``, block size or config, and keeps the reference's npz layout:
a store either engine saved loads into the other."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import kv_cache as RK
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.models import transformer as PT
from repro_torch.runtime import kv_cache as PK
from repro_torch.runtime import serving as PS


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, rmsnorm scales set to random non-zero values."""
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def fill(t):
        for k, v in t.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "scale":
                t[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
    fill(tree)
    return tree


@pytest.fixture(scope="module")
def qwen():
    rcfg, pcfg = RC.get_smoke_config("qwen3-4b"), PC.get_smoke_config("qwen3-4b")
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, tree, bridge.params_from_numpy(tree, pcfg, device="cpu")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _shared(vocab, head, tails, seed):
    """Prompts that start with one ``head``-token system prompt."""
    system = _prompts(vocab, (head,), seed)[0]
    return [np.concatenate([system, t]) for t in _prompts(vocab, tails, seed + 1)]


COUNTERS = ("decode_steps", "admissions", "peak_active", "preemptions", "spec_ticks",
            "spec_accepted", "prefix_hits", "prefix_pages_shared", "readmit_prefix_hits",
            "readmit_prefix_pages")


def _pool_state(eng):
    kv = eng.kv
    return dict(cow_forks=kv.cow_forks, peak=kv.peak_pages_in_use, in_use=kv.pages_in_use,
                hits=kv.registry.hits, misses=kv.registry.misses, entries=len(kv.registry),
                held=kv.registry.blocks_held)


def _on_both(setup, kw, script):
    """Run ``script(engine)`` on the JAX engine and the port's with
    ``ServeConfig(**kw)``; assert equal observations, counters and pool
    state; return (port engine, its observations)."""
    rcfg, pcfg, tree, params = setup
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**kw))
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    want, got = script(ref), script(eng)
    assert set(got) == set(want)
    for key in want:
        a, b = got[key], want[key]
        if isinstance(b, dict):  # uid -> tokens
            assert a.keys() == b.keys(), key
            for u in b:
                np.testing.assert_array_equal(a[u], b[u], err_msg=f"{key}[{u}]")
        else:
            assert a == b, (key, a, b)
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(ref, name), name
    if eng.paged:
        assert _pool_state(eng) == _pool_state(ref)
        eng.kv.check_invariants()
    return eng, got


def _generate(setup, kw, prompt):
    """The port's b=1 greedy oracle for ``prompt``."""
    _, pcfg, _, params = setup
    single = PS.ServingEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu",
                              unembed=PT.unembed_f32(pcfg, params))
    return single.generate(prompt[None])[0].numpy()


# -- the refcounted pool -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_refcounted_share_free_matches_reference(seed):
    """tests/test_kv_cache.py:80: alloc / incref / free sequences leave the
    port's allocator and the reference's with equal free lists, refcounts,
    shared counts and reference sums, and full reclaim at the end."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 24))
    ref, port = RK.BlockAllocator(n), PK.BlockAllocator(n)
    held: list[list[int]] = []
    for _ in range(300):
        r = rng.random()
        if held and r < 0.3:
            grant = held.pop(int(rng.integers(len(held))))
            ref.free(grant)
            port.free(grant)
        elif held and r < 0.55:
            grant = held[int(rng.integers(len(held)))]
            ref.incref(grant)
            port.incref(grant)
            held.append(list(grant))
        else:
            k = int(rng.integers(0, port.capacity + 1))
            got, want = port.alloc(k), ref.alloc(k)
            assert got == want
            if got:
                held.append(got)
        counts = collections.Counter(p for g in held for p in g)
        assert (port._free, port._ref) == (ref._free, ref._ref)
        assert port.total_refs == ref.total_refs == sum(counts.values())
        assert port.shared_count == ref.shared_count
        port.check_invariants(held)
    for grant in held:
        port.free(grant)
    port.check_invariants([])
    assert port.free_count == port.capacity and port.total_refs == 0
    with pytest.raises(ValueError, match="unallocated"):
        port.incref([1])


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_cow_fork_isolation(qwen, kv_dtype):
    """tests/test_kv_cache.py:282 and tests/test_quant_kv.py:183: a write
    into a shared page forks it; the fork starts as an exact copy (codes
    and scale rows), the sharer's page never changes, and the tables and
    refcounts match the reference pool's after the same operations."""
    rcfg, pcfg, _, _ = qwen
    geom = dict(max_batch=2, max_seq=64, block_size=16, kv_dtype=kv_dtype)
    ref, kv = RK.PagedKVCache(rcfg, **geom), PK.PagedKVCache(pcfg, device="cpu", **geom)
    for pool in (ref, kv):
        assert pool.alloc(0, 16)
    blk = kv.slot_pages(0)[0]
    assert ref.slot_pages(0)[0] == blk
    for c in kv.pools["blocks"].values():
        c["k"][:, blk] = 3 if kv_dtype == "int8" else 1.0
        c["v"][:, blk] = 3 if kv_dtype == "int8" else 1.0
        if kv_dtype == "int8":
            c["k_scale"][:, blk] = 0.5
            c["v_scale"][:, blk] = 0.5
    for pool in (ref, kv):
        pool.map_shared(1, [blk])
    st = kv.stats()
    assert (st.shared_pages, st.total_refs, st.in_use) == (1, 2, 1)
    assert st.bytes_saved == st.page_bytes
    assert kv.ensure_write(1, 3) and ref.ensure_write(1, 3)
    fork = kv.slot_pages(1)[0]
    assert fork != blk and kv.cow_forks == ref.cow_forks == 1
    np.testing.assert_array_equal(kv.page_table, ref.page_table)
    assert kv.allocator._ref == ref.allocator._ref and kv._owned == ref._owned
    for c in kv.pools["blocks"].values():
        for key in PK.PAGED_LEAVES:
            if key in c:  # codes and scales travel together
                assert torch.equal(c[key][:, fork], c[key][:, blk]), key
    c0 = next(iter(kv.pools["blocks"].values()))
    before = c0["k"][:, blk].clone()
    c0["k"][:, fork] = 2 if kv_dtype == "int8" else 2.0
    if kv_dtype == "int8":
        c0["k_scale"][:, fork] = 2.0
        assert bool((c0["k_scale"][:, blk] == 0.5).all())
    assert torch.equal(c0["k"][:, blk], before)
    kv.check_invariants()
    kv.release(0)
    kv.release(1)
    assert kv.pages_in_use == 0


def test_registry_counters_and_stranded_entries(qwen):
    """tests/test_kv_cache.py:455, :476 and :487: the longest-match descent
    is one outcome, a direct probe still counts, a sub-page prompt probes
    nothing, and entries off a new chunk grid are dropped with their pages;
    the port's pool and the reference's agree at every step."""
    rcfg, pcfg, _, _ = qwen
    geom = dict(max_batch=2, max_seq=64, block_size=8)
    ref, kv = RK.PagedKVCache(rcfg, **geom), PK.PagedKVCache(pcfg, device="cpu", **geom)
    tokens = np.arange(40, dtype=np.int32)
    query = np.concatenate([tokens[:16], 1000 + np.arange(25)]).astype(np.int32)
    miss = (2000 + np.arange(20)).astype(np.int32)

    def state(pool):
        return (pool.registry.hits, pool.registry.misses, len(pool.registry),
                pool.registry.blocks_held, pool.pages_in_use, pool.last_lookup_probed)

    steps = [lambda p: p.alloc(0, 40),
             lambda p: p.register_prefix(tokens, 0, align_tokens=8),
             lambda p: p.lookup_prefix(query, align_tokens=8),
             lambda p: p.lookup_prefix(miss, align_tokens=8),
             lambda p: p.lookup_prefix(miss[:4], align_tokens=4),
             lambda p: p.registry.get(np.arange(8, dtype=np.int32)),
             lambda p: p.registry.get(np.arange(8, dtype=np.int32), count=False),
             lambda p: p.clear_stranded_prefixes(16),
             lambda p: p.lookup_prefix(np.concatenate([tokens[:32], [99]]).astype(np.int32),
                                       align_tokens=16),
             lambda p: p.release(0),
             lambda p: p.clear_prefixes()]
    for i, step in enumerate(steps):
        assert step(kv) == step(ref), i
        assert state(kv) == state(ref), i
        kv.check_invariants()
    assert kv.lookup_prefix(query, align_tokens=8, count=False) == (0, [])
    assert kv.pages_in_use == 0 and (kv.registry.hits, kv.registry.misses) == (3, 1)


# -- the engine --------------------------------------------------------------------


@pytest.mark.parametrize("extra", [dict(), dict(fused_prefill=False)],
                         ids=["fused", "non-fused"])
def test_token_parity_and_fewer_pages(qwen, extra):
    """tests/test_kv_cache.py:324: four requests sharing a 2-page system
    prompt give the JAX engine's tokens, the unshared serve's and the b=1
    oracle's, with 3 hits, 6 pages mapped and a strictly lower peak; the
    fused admission's tail runs on the chunk grid of a full prefill."""
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=6, max_batch=4, paged=True,
              block_size=16, **extra)
    prompts = _shared(qwen[0].vocab_size, 32, (8, 16, 24, 8), 41)

    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        out = eng.run()
        retained = eng.kv.pages_in_use
        eng.kv.clear_prefixes()
        return dict(out=out, uids=tuple(uids), retained=retained)

    on, got = _on_both(qwen, dict(kw, prefix_sharing=True, prefix_min_pages=2), script)
    off, base = _on_both(qwen, kw, script)
    assert on.prefix_hits == 3 and on.prefix_pages_shared == 6
    assert on.kv.peak_pages_in_use < off.kv.peak_pages_in_use
    assert got["retained"] > 0 and on.kv.pages_in_use == 0
    assert on.prefill_chunks == off.prefill_chunks - 6  # each sharer skips 2 chunks of 16
    for u, bu, p in zip(got["uids"], base["uids"], prompts):
        np.testing.assert_array_equal(got["out"][u], base["out"][bu])
        np.testing.assert_array_equal(got["out"][u], _generate(qwen, kw, p))


def test_int8_sharing_parity(qwen):
    """tests/test_quant_kv.py:259: sharing over int8 pages: the counters
    equal the JAX engine's, and the tokens agree with it and with the f32
    oracle at the reference's floor (0.5)."""
    rcfg, pcfg, tree, params = qwen
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=6, max_batch=3, paged=True,
              block_size=16, kv_dtype="int8", prefix_sharing=True, prefix_min_pages=2)
    prompts = _shared(rcfg.vocab_size, 32, (8, 16, 8), 41)
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**kw))
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    r_uids, p_uids = [ref.submit(p) for p in prompts], [eng.submit(p) for p in prompts]
    want, got = ref.run(), eng.run()
    oracle = [_generate(qwen, dict(max_seq=96, prefill_chunk=16, max_new_tokens=6), p)
              for p in prompts]
    vs_ref = np.mean([np.mean(got[p] == want[r]) for p, r in zip(p_uids, r_uids)])
    vs_oracle = np.mean([np.mean(got[p] == o) for p, o in zip(p_uids, oracle)])
    assert vs_ref >= 0.5 and vs_oracle >= 0.5, (vs_ref, vs_oracle)
    for name in ("prefix_hits", "prefix_pages_shared", "decode_steps"):
        assert getattr(eng, name) == getattr(ref, name), name
    assert eng.prefix_hits == 2
    assert _pool_state(eng) == _pool_state(ref)
    eng.kv.check_invariants()


def test_spec_decode_with_sharing(qwen):
    """tests/test_spec_decode.py:207: sharing stays engaged under spec
    decode, with the JAX engine's tokens and the b=1 oracle's."""
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=8, max_batch=3, paged=True,
              block_size=16)
    prompts = _shared(qwen[0].vocab_size, 32, (8, 16, 24), 41)

    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        return dict(out=eng.run(), uids=tuple(uids))

    eng, got = _on_both(qwen, dict(kw, prefix_sharing=True, prefix_min_pages=2,
                                   spec_decode=True, spec_k=3), script)
    assert eng.prefix_hits == 2 and eng.spec_ticks > 0
    for u, p in zip(got["uids"], prompts):
        np.testing.assert_array_equal(got["out"][u], _generate(qwen, kw, p))


def test_registry_reclaim_unblocks_admission(qwen):
    """tests/test_kv_cache.py:358: retained prefix pages are reclaimed (LRU)
    for a request that needs them instead of leaving it waiting."""
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=8, max_batch=2, paged=True,
              block_size=16, num_blocks=7, prefix_sharing=True)
    p0, p1 = _prompts(qwen[0].vocab_size, (48, 64), 61)

    def script(eng):
        u0 = eng.submit(p0)
        first = eng.run()
        retained = eng.kv.pages_in_use
        u1 = eng.submit(p1, max_new_tokens=8)
        second = eng.run()
        return dict(first=first, second=second, retained=retained, uids=(u0, u1),
                    dropped=eng.kv.lookup_prefix(p0, count=False) == (0, []))

    _, got = _on_both(qwen, kw, script)
    assert got["retained"] > 0 and got["dropped"]
    assert len(got["second"][got["uids"][1]]) == 8


def test_backpressured_admission_counts_once(qwen):
    """tests/test_kv_cache.py:508: the gate's polls record nothing; one miss
    lands when the request is finally admitted."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=4, max_batch=2, paged=True,
              block_size=16, num_blocks=4, prefix_sharing=True)

    def script(eng):
        grab = eng.kv.allocator.alloc(1)
        eng.submit(np.arange(32, dtype=np.int32))
        for _ in range(5):
            eng.step()
        polled = (len(eng.queue), eng.kv.registry.hits, eng.kv.registry.misses)
        eng.kv.allocator.free(grab)
        return dict(polled=polled, out=eng.run())

    _, got = _on_both(qwen, kw, script)
    assert got["polled"] == (1, 0, 0)


def test_readmit_remaps_registered_prefix(qwen):
    """tests/test_spec_decode.py:381: a preempted sharer re-maps its
    registered prefix on readmission (shared, not copied) and finishes with
    the oracle's tokens."""
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=8, max_batch=2, paged=True,
              block_size=16, prefix_sharing=True)
    p0 = _shared(qwen[0].vocab_size, 32, (16,), 5)[0]

    def script(eng):
        u0 = eng.submit(p0)
        eng.step()  # admit: registers the 2-page prefix
        eng.step()  # one tick
        ev = eng.evict(u0)
        evicted = eng.kv.pages_in_use
        eng.readmit(ev)
        st = eng.kv.stats()
        return dict(evicted=evicted, shared=st.shared_pages, in_use=eng.kv.pages_in_use,
                    cur=ev.cur, out=eng.run(), uid=u0)

    eng, got = _on_both(qwen, kw, script)
    assert eng.readmit_prefix_hits == 1 and eng.readmit_prefix_pages == 2
    assert got["shared"] >= 2
    assert got["in_use"] == got["evicted"] + eng.kv.pages_for(got["cur"] + 1) - 2
    np.testing.assert_array_equal(got["out"][got["uid"]], _generate(qwen, kw, p0))


def test_readmit_gate_credits_the_match(qwen):
    """tests/test_spec_decode.py:408: a pool one tail page short of a full
    re-scatter readmits because the gate credits the registered prefix."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=2, paged=True,
              block_size=16, num_blocks=7, prefix_sharing=True)
    p0 = _shared(qwen[0].vocab_size, 32, (8,), 25)[0]

    def script(eng):
        u0 = eng.submit(p0)
        eng.step()
        ev = eng.evict(u0)
        eng._preempted.append(ev)
        retained = eng.kv.pages_in_use
        grab = eng.kv.allocator.alloc(2)
        eng.step()
        back = any(s.uid == u0 for s in eng.slots)
        eng.kv.allocator.free(grab)
        return dict(retained=retained, back=back, out=eng.run(), uid=u0)

    eng, got = _on_both(qwen, kw, script)
    assert got["retained"] == 2 and got["back"] and eng.readmit_prefix_hits == 1
    assert len(got["out"][got["uid"]]) == 8


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_pressured_pool_with_sharing(qwen, kv_dtype):
    """A pool too small for the sharers' growth preempts; the pressure
    reclaims the registry, a later sharer registers the head again, and
    the victim's readmission re-maps it.  Every count equals the JAX
    engine's (tokens too at f32, where they also equal the unpressured
    serve's).  The lengths are those of the chip smoke's pressured serve."""
    base = dict(max_seq=144, prefill_chunk=64, max_new_tokens=16, max_batch=4, paged=True,
                block_size=16, prefix_sharing=True, kv_dtype=kv_dtype)
    prompts = _shared(qwen[0].vocab_size, 64, (64, 36, 13, 64, 16, 8), 83)

    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        out = eng.run()
        return dict(out=out if kv_dtype == "fp32" else {}, uids=tuple(uids))

    eng, got = _on_both(qwen, dict(base, num_blocks=19), script)
    assert eng.preemptions >= 1 and eng.readmit_prefix_hits >= 1
    if kv_dtype == "fp32":
        _, free = _on_both(qwen, base, script)
        for u in got["uids"]:
            np.testing.assert_array_equal(got["out"][u], free["out"][u])


# -- the prefix store --------------------------------------------------------------


def test_config_digest_matches_reference(qwen):
    rcfg, pcfg, _, _ = qwen
    assert PK._config_digest(pcfg) == RK._config_digest(rcfg)
    assert PK._config_digest(PC.get_config("qwen3-4b")) == RK._config_digest(
        RC.get_config("qwen3-4b"))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "non-fused"])
def test_store_round_trip(qwen, tmp_path, fused):
    """A registry saved by one engine and restored by a second gives the
    cold serve's tokens with hits from the first admission on; a store of
    another kv_dtype, block size or config restores nothing."""
    _, pcfg, _, params = qwen
    path = tmp_path / "prefixes.npz"
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=6, max_batch=2, paged=True,
              block_size=16, prefix_sharing=True, prefix_store=str(path),
              fused_prefill=fused)
    prompts = _shared(pcfg.vocab_size, 32, (8, 16, 24), 91)

    def serve(**over):
        eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**dict(kw, **over)),
                                     device="cpu")
        uids = [eng.submit(p) for p in prompts]
        out = eng.run()
        return eng, [out[u] for u in uids]

    cold, want = serve()
    assert cold.prefixes_restored == 0 and cold.prefix_hits == 2
    assert cold.save_prefixes() == len(cold.kv.registry) > 0
    assert not (tmp_path / "prefixes.npz.tmp").exists()
    warm, got = serve()
    assert warm.prefixes_restored == len(cold.kv.registry)
    assert warm.prefix_hits == 3  # the first admission hits too
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    warm.kv.check_invariants()
    assert PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**dict(
        kw, kv_dtype="int8")), device="cpu").prefixes_restored == 0
    assert PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**dict(
        kw, block_size=8)), device="cpu").prefixes_restored == 0
    other = PC.get_smoke_config("qwen3-4b")
    other = type(other)(**{**other.__dict__, "rope_theta": 123.0})
    kv = PK.PagedKVCache(other, max_batch=2, max_seq=96, block_size=16, device="cpu")
    assert kv.load_prefixes(path) == 0 and kv.pages_in_use == 0
    (tmp_path / "junk.npz").write_bytes(b"not a store")
    assert kv.load_prefixes(tmp_path / "junk.npz") == 0
    assert kv.load_prefixes(tmp_path / "absent.npz") == 0


def _stocked(pool_cls, cfg, kv_dtype, **dev):
    """A pool with a 2-page entry over random rows (a b=1 cache scattered in)."""
    kv = pool_cls(cfg, max_batch=2, max_seq=64, block_size=16, kv_dtype=kv_dtype, **dev)
    assert kv.alloc(0, 32)
    return kv


def test_store_pins_kv_dtype_and_loads_across_engines(qwen, tmp_path):
    """tests/test_quant_kv.py:342, and the reference's layout: an int8 store
    saved by the JAX pool is rejected by an f32 pool and restores its codes
    and scales bit for bit into the port's int8 pool; an f32 store saved by
    the port restores into the reference's pool with equal rows."""
    rcfg, pcfg, _, _ = qwen
    rng = np.random.default_rng(61)
    tokens = rng.integers(0, rcfg.vocab_size, 32).astype(np.int32)
    cache = {"blocks": {name: {key: rng.normal(size=(pcfg.n_repeats, 1, 64, pcfg.n_kv_heads,
                                                     pcfg.head_dim)).astype(np.float32)
                               for key in ("k", "v")}
                        for name in PT.init_cache(pcfg, 1, 64, device="cpu")["blocks"]}}
    probe = np.concatenate([tokens, rng.integers(0, rcfg.vocab_size, 8).astype(np.int32)])

    ref = _stocked(RK.PagedKVCache, rcfg, "int8")
    ref.scatter(0, jax.tree.map(jnp.asarray, cache), 32)
    ref.register_prefix(tokens, 0, align_tokens=16)
    path = tmp_path / "ref.npz"
    assert ref.save_prefixes(path) > 0
    assert PK.PagedKVCache(pcfg, max_batch=2, max_seq=64, block_size=16,
                           device="cpu").load_prefixes(path) == 0
    port = PK.PagedKVCache(pcfg, max_batch=2, max_seq=64, block_size=16, kv_dtype="int8",
                           device="cpu")
    assert port.load_prefixes(path) == len(ref.registry)
    n, blocks = port.lookup_prefix(probe, align_tokens=16)
    assert n == 2
    rn, rblocks = ref.lookup_prefix(probe, align_tokens=16)
    for name, c in port.pools["blocks"].items():
        for key in PK.PAGED_LEAVES:
            np.testing.assert_array_equal(
                c[key][:, blocks].float().numpy(),
                np.asarray(ref.pools["blocks"][name][key][:, np.asarray(rblocks)],
                           np.float32), err_msg=f"{name}.{key}")
    port.check_invariants()

    mine = _stocked(PK.PagedKVCache, pcfg, "fp32", device="cpu")
    mine.scatter(0, {"blocks": {n_: {k: torch.from_numpy(v) for k, v in c.items()}
                                for n_, c in cache["blocks"].items()}}, 32)
    mine.register_prefix(tokens, 0, align_tokens=16)
    path = tmp_path / "port.npz"
    assert mine.save_prefixes(path) > 0
    back = RK.PagedKVCache(rcfg, max_batch=2, max_seq=64, block_size=16)
    assert back.load_prefixes(path) == len(mine.registry)
    rn, rblocks = back.lookup_prefix(probe, align_tokens=16)
    back.map_shared(0, rblocks)
    got = back.gather(0, 32)
    for name, c in cache["blocks"].items():
        for key in ("k", "v"):
            np.testing.assert_array_equal(np.asarray(got["blocks"][name][key]),
                                          c[key][:, :, :32])
