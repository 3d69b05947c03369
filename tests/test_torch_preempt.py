"""Evict, readmit and page-pressure preemption in the port's engine against
the JAX StreamedBatchEngine on the CPU, f32, equal weights through the
bridge.  Each scenario of ``tests/test_serving.py`` (evict / readmit
positions, readmit restoring the admission order, the two-slot thrash, the
admission and readmit gates), ``tests/test_kv_cache.py`` (backpressure,
pages travelling with an evicted request, readmit without pages) and
``tests/test_zoo.py`` (mamba evict / readmit, contiguous and beside a pool)
runs the same script on both engines: what the script observes, the greedy
tokens per uid and the counters (``preemptions`` among them) must be
equal, and the tokens equal to the port's own ``ServingEngine.generate``
where the reference test holds them to its ``generate``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.models import transformer as PT
from repro_torch.runtime import serving as PS


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, rmsnorm scales set to random non-zero values
    (zero at init, so the ``1 + scale`` gain would otherwise go untested)."""
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


def _setup(arch):
    rcfg, pcfg = RC.get_smoke_config(arch), PC.get_smoke_config(arch)
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, tree, bridge.params_from_numpy(tree, pcfg, device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _setup("qwen3-4b")


@pytest.fixture(scope="module")
def mamba():
    return _setup("mamba2-2.7b")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


COUNTERS = ("decode_steps", "admissions", "peak_active", "preemptions", "spec_ticks",
            "spec_accepted")


def _on_both(setup, kw, script):
    """Run ``script(engine)`` on the JAX engine and on the port's
    with ``ServeConfig(**kw)``; assert that both return the same
    observations and counters; return (port engine, its observations)."""
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
        assert eng.kv.pages_in_use == 0
        eng.kv.check_invariants()
    return eng, got


def _generate(setup, kw, prompt):
    """The port's b=1 greedy oracle for ``prompt``."""
    _, pcfg, _, params = setup
    single = PS.ServingEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu",
                              unembed=PT.unembed_f32(pcfg, params))
    return single.generate(prompt[None])[0].numpy()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_evict_readmit_preserves_positions(qwen, paged):
    """tests/test_serving.py:63 (contiguous) and tests/test_kv_cache.py:382
    (paged): evicted mid-decode, the request's rows travel with it and it
    resumes in another slot with the same tokens."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=2)
    if paged:
        kw.update(paged=True, block_size=16)
    p0, p1 = _prompts(qwen[0].vocab_size, (24, 32), 3)

    def script(eng):
        u0 = eng.submit(p0)
        eng.step()  # admit
        for _ in range(3):
            eng.step()  # partial decode
        before = eng.kv.pages_in_use if paged else 0
        ev = eng.evict(u0)
        obs = dict(cur=ev.cur, n_pages=ev.n_pages, emitted=list(ev.emitted),
                   freed=(before - eng.kv.pages_in_use) if paged else 0)
        assert ev.cur == len(p0) + len(ev.emitted) - 1
        u1 = eng.submit(p1)
        eng.step()  # the freed slot (and pages) go to p1
        for _ in range(2):
            eng.step()
        new_slot = eng.readmit(ev)
        obs.update(slot=new_slot, uid=eng.slots[new_slot].uid,
                   cur_after=eng.slots[new_slot].cur, out=eng.run(), uids=(u0, u1))
        return obs

    eng, got = _on_both(qwen, kw, script)
    assert got["uid"] == got["uids"][0]
    assert got["cur_after"] == got["cur"]
    if paged:
        assert got["n_pages"] == eng.kv.pages_for(got["cur"]) and got["freed"] > 0
    np.testing.assert_array_equal(got["out"][got["uids"][0]], _generate(qwen, kw, p0))


def test_readmit_restores_admission_seq(qwen):
    """tests/test_serving.py:117: the seq travels with the eviction, so the
    genuinely younger request is the next victim."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=2, paged=True,
              block_size=16)
    p0, p1 = _prompts(qwen[0].vocab_size, (24, 24), 71)

    def script(eng):
        u0, u1 = eng.submit(p0), eng.submit(p1)
        eng.step()  # admits both, u0 first
        orig = next(s for s in eng.slots if s.uid == u0).seq
        ev = eng.evict(u0)
        assert ev.seq == orig
        eng.readmit(ev)
        seq_after = next(s for s in eng.slots if s.uid == u0).seq
        preempted = eng._preempt_for_pages(frozenset())
        victim = eng._preempted[0].uid
        return dict(orig=orig, seq_after=seq_after, preempted=preempted, victim=victim,
                    uids=(u0, u1), out=eng.run())

    _, got = _on_both(qwen, kw, script)
    assert got["seq_after"] == got["orig"] and got["preempted"]
    assert got["victim"] == got["uids"][1]
    for u, p in zip(got["uids"], (p0, p1)):
        np.testing.assert_array_equal(got["out"][u], _generate(qwen, kw, p))


@pytest.mark.parametrize("extra", [dict(), dict(kv_dtype="int8"), dict(kv_dtype="fp8"),
                                   dict(spec_decode=True, spec_k=3),
                                   dict(fused_prefill=False)], ids=str)
def test_two_slot_thrash_completes(qwen, extra):
    """tests/test_serving.py:143: two slots squeezed into a pool too small
    for both requests' growth preempt and readmit until both finish, with
    the JAX engine's tokens and preemption count (over int8 / fp8 pages
    the gather dequantizes and the readmit requantizes, as in the
    reference)."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=32, max_batch=2, paged=True,
              block_size=16, num_blocks=8, **extra)
    prompts = _prompts(qwen[0].vocab_size, (32, 32), 73)

    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        return dict(out=eng.run(), uids=tuple(uids))

    eng, got = _on_both(qwen, kw, script)
    assert eng.preemptions >= 1
    if not extra:
        for u, p in zip(got["uids"], prompts):
            np.testing.assert_array_equal(got["out"][u], _generate(qwen, kw, p))


def test_admission_gate_covers_next_write(qwen):
    """tests/test_serving.py:162: a page-aligned prompt with one free page
    waits (pages_for(len + 1) = 2) instead of being admitted and bounced."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=4, max_batch=2, paged=True,
              block_size=16, num_blocks=4)

    def script(eng):
        grab = eng.kv.allocator.alloc(2)  # leave 1 of 3 usable pages
        u0 = eng.submit(np.arange(16, dtype=np.int32))
        eng.step()
        held = all(s.free for s in eng.slots) and len(eng.queue) == 1
        eng.kv.allocator.free(grab)
        return dict(held=held, out=eng.run(), uid=u0)

    eng, got = _on_both(qwen, kw, script)
    assert got["held"] and len(got["out"][got["uid"]]) == 4 and eng.preemptions == 0


def test_readmit_gate_covers_next_write(qwen):
    """tests/test_serving.py:180: with cur page-aligned and exactly
    pages_for(cur) free, the readmit waits for pages_for(cur + 1)."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=2, paged=True,
              block_size=16, num_blocks=5)
    p0 = _prompts(qwen[0].vocab_size, (15,), 79)[0]

    def script(eng):
        u0 = eng.submit(p0)
        eng.step()  # admit (1 page)
        eng.step()  # one tick: cur 15 -> 16, page-aligned
        ev = eng.evict(u0)
        eng._preempted.append(ev)
        grab = eng.kv.allocator.alloc(3)  # exactly one free page left
        eng.step()
        held = len(eng._preempted) == 1 and all(s.free for s in eng.slots)
        eng.kv.allocator.free(grab)
        eng.step()  # two pages free: readmit
        back = any(s.uid == u0 for s in eng.slots)
        return dict(cur=ev.cur, held=held, back=back, out=eng.run(), uid=u0)

    eng, got = _on_both(qwen, kw, script)
    assert got["cur"] == 16 and got["held"] and got["back"] and eng.preemptions == 0
    np.testing.assert_array_equal(got["out"][got["uid"]], _generate(qwen, kw, p0))


def test_backpressure_with_a_small_pool(qwen):
    """tests/test_kv_cache.py:243: 4 usable pages for three requests that
    peak at 3 pages each; every request finishes with the contiguous
    engine's tokens and the pool never over-allocates."""
    base = dict(max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=3)
    kw = dict(base, paged=True, block_size=16, num_blocks=5)
    prompts = _prompts(qwen[0].vocab_size, (32, 32, 32), 11)

    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        return dict(out=eng.run(), uids=tuple(uids), peak=eng.kv.peak_pages_in_use)

    eng, got = _on_both(qwen, kw, script)
    assert got["peak"] <= eng.kv.allocator.capacity and eng.peak_active < len(prompts)
    for u, p in zip(got["uids"], prompts):
        np.testing.assert_array_equal(got["out"][u], _generate(qwen, base, p))


def test_readmit_without_pages_raises(qwen):
    """tests/test_kv_cache.py:430."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=2, paged=True,
              block_size=16, num_blocks=4)
    p0, p1 = _prompts(qwen[0].vocab_size, (32, 40), 17)

    def script(eng):
        u0 = eng.submit(p0)
        eng.step()  # admit p0 (2 pages + 1 through its next write)
        ev = eng.evict(u0)
        eng.submit(p1, max_new_tokens=8)
        eng.step()  # admit p1: its prompt takes every page
        eng.step()  # one tick inside its last page
        short = eng.kv.free_pages < eng.kv.pages_for(ev.cur)
        with pytest.raises(RuntimeError):
            eng.readmit(ev)
        return dict(short=short, slots=[s.uid for s in eng.slots],
                    free=eng.kv.free_pages, out=eng.run())

    _, got = _on_both(qwen, kw, script)
    assert got["short"]


def test_submit_rejects_a_request_larger_than_the_pool(qwen):
    _, pcfg, _, params = qwen
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(
        max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=2, paged=True,
        block_size=16, num_blocks=4), device="cpu")
    with pytest.raises(ValueError, match="pages"):  # needs 4 pages, the pool holds 3
        eng.submit(np.zeros(56, np.int32), max_new_tokens=8)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_mamba_evict_readmit(mamba, paged):
    """tests/test_zoo.py::_parity_with_evict: one forced evict / readmit
    mid-decode; the SSM state travels as per-slot leaves (a copy of the
    slot's rows, or beside the pool's pages)."""
    kw = dict(max_seq=128, prefill_chunk=16, max_new_tokens=6, max_batch=2)
    if paged:
        kw.update(paged=True, block_size=16)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, mamba[0].vocab_size, n).astype(np.int32)
               for n in (20, 33, 17)]

    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        for _ in range(3):
            if eng.pending:
                eng.step()
        ev = eng.evict(eng.active_slots[0].uid)
        return dict(evicted=ev.uid, cur=ev.cur, slot=eng.readmit(ev), out=eng.run(),
                    uids=tuple(uids))

    _, got = _on_both(mamba, kw, script)
    for u, p in zip(got["uids"], prompts):
        np.testing.assert_array_equal(got["out"][u], _generate(mamba, kw, p))


def test_mamba_paged_engine_preempts_under_pressure(mamba):
    """SSM state rides the preemption: a pool too small for both slots."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=32, max_batch=2, paged=True,
              block_size=16, num_blocks=8)
    prompts = _prompts(mamba[0].vocab_size, (32, 32), 73)

    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        return dict(out=eng.run(), uids=tuple(uids))

    eng, got = _on_both(mamba, kw, script)
    assert eng.preemptions >= 1
    for u, p in zip(got["uids"], prompts):
        np.testing.assert_array_equal(got["out"][u], _generate(mamba, kw, p))
