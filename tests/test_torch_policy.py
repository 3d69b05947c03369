"""The port's serving policy against the JAX engine's, on the CPU:
``plan_decode_policy`` and ``plan_block_size`` over a grid of stage times,
prompt lengths and ``max_seq`` (the cases of ``tests/test_serving.py``'s
``TestPolicy``) equal the reference's, ``ServingPlan`` rejects the same
fields; ``autotune`` applies its plan; ``measure_stage_times`` leaves every
live cache byte-equal with slots active (paged, contiguous, mamba's slot
state beside the pages, at temperature) and whisper's chunk probe runs on
``probe_enc_out``; and with the same stage times injected into both
engines, ``autotune`` makes the same plan, the same pool (a rebuild at a
new page size, or none while an eviction is out, the stranded prefixes
dropped) and the same tokens after it, with no graph built over the old
pool run again."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.core import rmetric as RR
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.core import rmetric as PR
from repro_torch.models import transformer as PT
from repro_torch.runtime import serving as PS
from repro_torch.runtime.graphs import StepGraph

STAGE_TIMES = [(0.004, 0.002), (0.0001, 0.1), (0.02, 0.001), (0.001, 0.001),
               (0.05, 0.05), (0.003, 0.0007), (0.0, 0.0), (0.2, 0.0001)]
PROMPT_LENS = (1, 16, 24, 77, 100, 256, 1000)
MAX_SEQS = (None, 96, 100, 72, 30, 7, 1, 144, 4096)


@pytest.mark.parametrize("h2d,kex", STAGE_TIMES, ids=str)
def test_plans_match_reference(h2d, kex):
    for prompt_len in PROMPT_LENS:
        for max_seq in MAX_SEQS:
            want = RS.plan_decode_policy(RR.StageTimes(h2d=h2d, kex=kex),
                                         prompt_len=prompt_len, max_seq=max_seq)
            got = PS.plan_decode_policy(PR.StageTimes(h2d=h2d, kex=kex),
                                        prompt_len=prompt_len, max_seq=max_seq)
            assert ((got.decision, got.prefill_chunk, got.decode_interleave, got.block_size)
                    == (want.decision, want.prefill_chunk, want.decode_interleave,
                        want.block_size)), (prompt_len, max_seq)
            assert dataclasses.astuple(got.stage_times) == dataclasses.astuple(
                want.stage_times)
            if max_seq is not None:  # the planned geometry constructs
                PS.ServeConfig(max_seq=max_seq, paged=True, block_size=got.block_size)
        for chunk in (1, 16, 64, 200):
            for kw in ({}, dict(min_block=4, max_block=32), dict(max_seq=100)):
                assert (PS.plan_block_size(PR.StageTimes(h2d=h2d, kex=kex),
                                           prefill_chunk=chunk, **kw)
                        == RS.plan_block_size(RR.StageTimes(h2d=h2d, kex=kex),
                                              prefill_chunk=chunk, **kw)), (chunk, kw)


@pytest.mark.parametrize("fields", [dict(prefill_chunk=0), dict(decode_interleave=0),
                                    dict(block_size=0), dict(block_size=-3)], ids=str)
def test_serving_plan_rejects_what_the_reference_rejects(fields):
    kw = dict(dict(decision="stream", prefill_chunk=16, decode_interleave=1), **fields)
    with pytest.raises(ValueError) as want:
        RS.ServingPlan(stage_times=RR.StageTimes(h2d=0.001, kex=0.001), **kw)
    with pytest.raises(ValueError) as got:
        PS.ServingPlan(stage_times=PR.StageTimes(h2d=0.001, kex=0.001), **kw)
    assert str(got.value) == str(want.value)


def _numpy_params(cfg, seed=0):
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


def _serve(eng, prompts):
    uids = [eng.submit(p) for p in prompts]
    out = eng.run()
    return [out[u] for u in uids]


def test_autotune_applies_plan(qwen):
    """tests/test_serving.py test_autotune_applies_plan and
    tests/test_tuning.py test_autotune_retains_plan_and_stage_times."""
    _, pcfg, _, params = qwen
    scfg = PS.ServeConfig(max_seq=64, prefill_chunk=16, max_new_tokens=2, max_batch=2)
    eng = PS.StreamedBatchEngine(pcfg, params, scfg, device="cpu")
    assert eng.last_plan is None and eng.last_stage_times is None
    plan = eng.autotune(32)
    assert scfg.prefill_chunk == plan.prefill_chunk
    assert scfg.decode_interleave == plan.decode_interleave
    assert plan.stage_times.h2d > 0 and plan.stage_times.kex > 0
    assert eng.last_plan is plan and eng.last_stage_times == plan.stage_times
    assert len(_serve(eng, _prompts(pcfg.vocab_size, (20,), 1))[0]) == 2


def _state(eng) -> list[torch.Tensor]:
    tree = eng.kv.pools if eng.paged else eng.caches
    return [leaf.clone() for c in tree["blocks"].values() for leaf in c.values()]


PROBE_CASES = {
    "qwen paged": ("qwen", dict(paged=True, block_size=16)),
    "qwen paged, temperature": ("qwen", dict(paged=True, block_size=16, temperature=0.8)),
    "qwen contiguous": ("qwen", {}),
    "qwen paged, not fused, int8": ("qwen", dict(paged=True, block_size=16,
                                                 fused_prefill=False, kv_dtype="int8")),
    "mamba paged": ("mamba", dict(paged=True, block_size=16)),
    "mamba contiguous": ("mamba", {}),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_leaves_live_state_alone(request, case):
    """With slots active mid decode, the probe leaves every leaf of the
    pool (or slot cache), the page table and the slots as they were, and
    the serve then gives the tokens of a serve never probed."""
    arch, fields = PROBE_CASES[case]
    _, pcfg, _, params = request.getfixturevalue(arch)
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=16, max_batch=3, **fields)
    prompts = _prompts(pcfg.vocab_size, (24, 17, 30), 5)
    want = _serve(PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu"),
                  prompts)
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    uids = [eng.submit(p) for p in prompts]
    for _ in range(3):
        eng.step()
    assert len(eng.active_slots) == 3
    before = _state(eng)
    table = eng.kv.page_table.copy() if eng.paged else None
    slots = [dataclasses.replace(s, emitted=list(s.emitted)) for s in eng.slots]
    st = eng.measure_stage_times(24)
    assert st.h2d > 0 and st.kex > 0 and eng.last_stage_times is st
    after = _state(eng)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    if eng.paged:
        np.testing.assert_array_equal(eng.kv.page_table, table)
    assert eng.slots == slots
    out = eng.run()
    for u, w in zip(uids, want):
        np.testing.assert_array_equal(out[u], w)


def test_whisper_probe_runs_on_probe_enc_out(monkeypatch):
    """Whisper's chunk probe is the first-chunk graph, whose encoder output
    is ``probe_enc_out``'s zeros."""
    cfg = PC.get_smoke_config("whisper-medium")
    params = PT.init_params(cfg, 0, device="cpu")
    eng = PS.StreamedBatchEngine(cfg, params, PS.ServeConfig(
        max_seq=64, prefill_chunk=16, max_new_tokens=4, max_batch=2), device="cpu")
    calls = []
    probe = eng.servable.probe_enc_out
    monkeypatch.setattr(eng.servable, "probe_enc_out",
                        lambda: calls.append(1) or probe())
    st = eng.measure_stage_times(24)
    assert calls == [1] and st.h2d > 0 and st.kex > 0
    step = eng.servable.single._chunk_jit[(16, True, 0)]
    assert step.uses == 2 and not step.inputs["enc_out"].any()
    enc = np.random.default_rng(0).standard_normal((cfg.encoder_seq, cfg.d_model))
    uid = eng.submit(np.arange(20, dtype=np.int32), enc_inputs=enc.astype(np.float32))
    assert len(eng.run()[uid]) == 4


def _pool_graphs(eng) -> list[StepGraph]:
    """The step graphs that hold the engine's pool: the ticks, the fused
    chunks and the pool's page moves (the b=1 chunk graphs hold the request
    cache, which a rebuild keeps)."""
    out = [eng._decode] + ([eng._verify] if eng._verify is not None else [])
    out += [g for k, g in eng.servable.single._chunk_jit.items() if k[0] == "fused"]
    for cache in (eng.kv._scatter_jit, eng.kv._gather_jit, eng.kv._load_jit):
        out += [g for g in cache.values() if g is not None]
    return out


def _rebuild(eng, prompts, seen):
    """Serve, autotune to a new page size on the idle pool, serve again;
    ``seen`` collects the port's graphs over the old pool and their uses
    after the rebuild."""
    first = _serve(eng, prompts)
    old = _pool_graphs(eng) if isinstance(eng, PS.StreamedBatchEngine) else []
    plan = eng.autotune(24)  # a probe would run the old decode graph, then the rebuild
    seen += [(g, g.uses) for g in old]
    return dict(first=first, plan=(plan.decision, plan.prefill_chunk, plan.decode_interleave,
                                   plan.block_size),
                block=eng.kv.block_size, blocks=eng.kv.num_blocks,
                second=_serve(eng, prompts))


def _pinned(eng, prompts, seen):
    """An outstanding eviction pins the page size (tests/test_kv_cache.py
    test_outstanding_eviction_pins_pool_geometry)."""
    uid = eng.submit(prompts[0])
    eng.step()
    ev = eng.evict(uid)
    plan = eng.autotune(24)
    block = eng.kv.block_size
    eng.readmit(ev)
    out = eng.run()
    return dict(plan=plan.block_size, block=block, out=out[uid],
                second=_serve(eng, prompts))


def _stranded(eng, prompts, seen):
    """tests/test_tuning.py test_chunk_change_clears_stranded_prefixes."""
    eng.submit(np.arange(24, dtype=np.int32))
    eng.run()
    held = (len(eng.kv.registry), eng.kv.registry.blocks_held)
    plan = eng.autotune(64)
    return dict(held=held, plan=(plan.prefill_chunk, plan.block_size),
                left=(len(eng.kv.registry), eng.kv.pages_in_use), out=_serve(eng, prompts))


REBUILD_CASES = {  # name -> (arch, ServeConfig fields, script, injected (h2d, kex))
    "qwen paged, fused": ("qwen", dict(paged=True, block_size=16), _rebuild, (0.004, 0.002)),
    "qwen paged, spec, explicit pool": (
        "qwen", dict(paged=True, block_size=16, num_blocks=13, spec_decode=True, spec_k=3),
        _rebuild, (0.004, 0.002)),
    "qwen paged, sharing, coarser pages": (
        "qwen", dict(paged=True, block_size=8, prefix_sharing=True), _rebuild, (0.0001, 0.1)),
    "mamba paged": ("mamba", dict(paged=True, block_size=16), _rebuild, (0.004, 0.002)),
    "qwen paged, eviction out": ("qwen", dict(paged=True, block_size=8), _pinned,
                                 (0.0001, 0.1)),
    "qwen sharing, stranded prefixes": (
        "qwen", dict(max_seq=96, prefill_chunk=24, paged=True, block_size=8,
                     prefix_sharing=True), _stranded, (0.004, 0.002)),
}


@pytest.mark.parametrize("case", sorted(REBUILD_CASES))
def test_autotune_matches_reference(request, case):
    """The same stage times injected into both engines: the same plan, the
    same pool after it and the same tokens before and after; after a
    rebuild no graph made over the old pool runs again, nor is held."""
    arch, fields, script, (h2d, kex) = REBUILD_CASES[case]
    rcfg, pcfg, tree, params = request.getfixturevalue(arch)
    kw = dict(dict(max_seq=64, prefill_chunk=16, max_new_tokens=6, max_batch=2), **fields)
    prompts = _prompts(pcfg.vocab_size, (24, 17, 30), 8)
    if "sharing" in case:  # a shared 16-token head
        prompts = [np.concatenate([prompts[0][:16], p]) for p in prompts]
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**kw))
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    ref.measure_stage_times = lambda n: RR.StageTimes(h2d=h2d, kex=kex)
    eng.measure_stage_times = lambda n: PR.StageTimes(h2d=h2d, kex=kex)
    seen: list = []
    want, got = script(ref, prompts, []), script(eng, prompts, seen)
    assert set(got) == set(want)
    for key in want:
        a, b = got[key], want[key]
        if isinstance(b, (list, np.ndarray)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            assert a == b, (key, a, b)
    assert eng.kv.pages_in_use == eng.kv.registry.blocks_held  # no slot holds a page
    eng.kv.check_invariants()
    if script is _rebuild:
        assert got["block"] != kw["block_size"] and seen
        assert all(g.uses == uses for g, uses in seen)  # none ran after the rebuild
        held = _pool_graphs(eng)
        assert not any(g is h for g, _ in seen for h in held)
        assert eng._decode.uses > 0
        assert eng.kv.page_table.shape[1] == kw["max_seq"] // got["block"]
