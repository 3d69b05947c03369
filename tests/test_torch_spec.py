"""Speculative decode in the port against the reference: the n-gram drafter
and greedy acceptance rule, engine parity with the JAX spec engine (smoke
qwen3-4b, paged, equal weights through the bridge), full acceptance with
an oracle drafter, the empty-draft fallback, and the rollback's
``truncate``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import kv_cache as RK
from repro.runtime import serving as RS
from repro.runtime.spec import drafter as RD
from repro.runtime.spec import verify as RV
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.runtime import kv_cache as PK
from repro_torch.runtime import serving as PS
from repro_torch.runtime import spec as PSP

NEW, CHUNK, BLOCK, SLOTS, MAX_SEQ = 12, 16, 8, 2, 40


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, rmsnorm scales set to random values."""
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


def _tiled_prompts(vocab, seed=3):
    """Prompts made by tiling a random segment, so prompt lookup proposes;
    one plain random prompt where it (almost surely) misses."""
    rng = np.random.default_rng(seed)
    out = []
    for seg, reps in ((6, 4), (5, 3), (8, 2), (4, 5)):
        out.append(np.tile(rng.integers(0, vocab, seg), reps).astype(np.int32))
    out.append(rng.integers(0, vocab, 19).astype(np.int32))
    return out


@pytest.fixture(scope="module")
def setup():
    rcfg = RC.get_smoke_config("qwen3-4b")
    pcfg = PC.get_smoke_config("qwen3-4b")
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, tree, _tiled_prompts(rcfg.vocab_size)


class _OracleDrafter:
    """Replays known outputs: full acceptance by construction (the
    reference test's drafter, keyed by the first emitted token)."""

    def __init__(self, refs: dict[int, np.ndarray], prompt_len: dict[int, int]):
        self.refs, self.prompt_len = refs, prompt_len

    def propose(self, context, k):
        for first, ref in self.refs.items():
            plen = self.prompt_len[first]
            if len(context) > plen and context[plen] == first:
                done = len(context) - plen
                return np.asarray(ref[done: done + k], np.int32)
        return np.zeros(0, np.int32)


class _EmptyDrafter:
    def propose(self, context, k):
        return np.zeros(0, np.int32)


def _kw(**extra):
    return dict(dict(max_seq=MAX_SEQ, prefill_chunk=CHUNK, max_new_tokens=NEW,
                     max_batch=SLOTS, block_size=BLOCK), **extra)


def _port(setup, prompts, drafter=None, **extra):
    _, pcfg, tree, _ = setup
    eng = PS.StreamedBatchEngine(pcfg, bridge.params_from_numpy(tree, pcfg, device="cpu"),
                                 PS.ServeConfig(paged=True, **_kw(**extra)), device="cpu",
                                 drafter=drafter)
    uids = [eng.submit(p) for p in prompts]
    out = eng.run()
    return eng, [out[u] for u in uids]


def test_ngram_drafter_matches_reference():
    rng = np.random.default_rng(0)
    contexts = [rng.integers(0, 6, n).astype(np.int32) for n in (1, 2, 5, 17, 40, 80)]
    contexts += [np.tile(rng.integers(0, 50, 7), 4).astype(np.int32),
                 np.array([3, 3, 3, 3, 3], np.int32), np.arange(30, dtype=np.int32)]
    for max_n in (1, 2, 3, 5):
        ref, port = RD.NGramDrafter(max_n), PSP.NGramDrafter(max_n)
        for ctx in contexts:
            for k in (0, 1, 3, 4, 9):
                np.testing.assert_array_equal(port.propose(ctx, k), ref.propose(ctx, k))
    with pytest.raises(ValueError, match="max_n"):
        PSP.NGramDrafter(0)
    assert isinstance(PSP.NGramDrafter(), PSP.Drafter)


def test_greedy_accept_matches_reference():
    rng = np.random.default_rng(1)
    for t in (2, 5):
        target = rng.integers(0, 3, (64, t)).astype(np.int32)
        draft = np.where(rng.random((64, t - 1)) < 0.8, target[:, :-1],
                         rng.integers(0, 3, (64, t - 1))).astype(np.int32)
        d_len = rng.integers(0, t, 64).astype(np.int32)
        want = RV.greedy_accept(jnp.asarray(target), jnp.asarray(draft), jnp.asarray(d_len))
        got = PSP.greedy_accept(torch.from_numpy(target), torch.from_numpy(draft),
                                torch.from_numpy(d_len))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        logits = rng.standard_normal((64, t, 11)).astype(np.float32)
        e_r, n_r = RV.verify_greedy(jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(d_len))
        e_p, n_p = PSP.verify_greedy(torch.from_numpy(logits), torch.from_numpy(draft),
                                     torch.from_numpy(d_len))
        np.testing.assert_array_equal(e_p.numpy(), np.asarray(e_r))
        np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_r))


def test_spec_engine_matches_reference_and_plain(setup):
    rcfg, _, tree, prompts = setup
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(
        paged=True, spec_decode=True, spec_k=4, **_kw()))
    r_uids = [ref.submit(p) for p in prompts]
    want = ref.run()
    eng, got = _port(setup, prompts, spec_decode=True, spec_k=4)
    for g, ru in zip(got, r_uids):
        np.testing.assert_array_equal(g, want[ru])
    # Drafts both accepted and rejected (rolled back) along the way.
    assert eng.spec_ticks > 0 and 0 < eng.spec_accepted < eng.spec_proposed
    for name in ("decode_steps", "spec_ticks", "spec_proposed", "spec_accepted"):
        assert getattr(eng, name) == getattr(ref, name), name
    _, plain = _port(setup, prompts)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p)
    eng.kv.check_invariants()
    assert eng.kv.pages_in_use == 0


def test_oracle_drafter_full_acceptance_in_fewer_ticks(setup):
    """Replaying the plain engine's output, every draft is accepted and the
    15 decode tokens arrive in at most ceil(15 / 5) + 1 verify steps."""
    _, _, _, prompts = setup
    p = prompts[4]
    _, (want,) = _port(setup, [p], max_new_tokens=16)
    oracle = _OracleDrafter({int(want[0]): want}, {int(want[0]): len(p)})
    eng, (got,) = _port(setup, [p], drafter=oracle, max_new_tokens=16, spec_decode=True,
                        spec_k=4)
    np.testing.assert_array_equal(got, want)
    assert eng.spec_accepted == eng.spec_proposed > 0
    assert eng.spec_ticks <= 4
    assert eng.kv.pages_in_use == 0


def test_empty_drafter_takes_the_plain_tick(setup):
    _, _, _, prompts = setup
    eng, got = _port(setup, prompts[:3], drafter=_EmptyDrafter(), spec_decode=True)
    _, plain = _port(setup, prompts[:3])
    assert eng.spec_ticks == 0 and eng.spec_proposed == 0 and eng.decode_steps > 0
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p)


def test_truncate_frees_only_the_exclusive_tail(setup):
    rcfg, pcfg, _, _ = setup
    geom = dict(max_batch=2, max_seq=32, block_size=8, num_blocks=10)
    ref, port = RK.PagedKVCache(rcfg, **geom), PK.PagedKVCache(pcfg, device="cpu", **geom)
    for kv in (ref, port):
        kv.alloc(0, 9)
        kv.alloc(1, 5)
        for pos in range(9, 27):  # draft positions faulted in
            assert kv.ensure_write(0, pos)
        kv.truncate(0, 12)  # accepted through row 11: two pages stay
        kv.truncate(1, 5)  # nothing past its pages: a no-op
    np.testing.assert_array_equal(port.page_table, ref.page_table)
    assert port._owned == ref._owned and len(port._owned[0]) == 2
    assert port.allocator._free == ref.allocator._free
    port.check_invariants()
    port.allocator._ref[port._owned[0][1]] = 2  # pretend the tail page is shared
    with pytest.raises(AssertionError, match="shared"):
        port.truncate(0, 8)
