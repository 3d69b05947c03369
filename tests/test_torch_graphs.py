"""The port's compiled ticks (``runtime/graphs.py``) on the CPU: the LRU
cache against the reference's ``_lru_jit``, the ``ServeConfig`` caps
against the reference's validation, the chunk-graph and page-move cache
keys of the port's engine equal to the JAX engine's ``_chunk_jit`` and
``_scatter_jit`` / ``_gather_jit`` / ``_load_jit`` after the same request
scripts (fused, not fused, contiguous, mamba, evict / readmit, a shared
prefix), the caps bounding both caches, and ``StepGraph``'s first-use /
capture / replay policy and launch accounting through a capture stand-in.
On the CPU the engine runs every step eagerly over its static buffers;
the other ``tests/test_torch_*.py`` parity tests run through that path."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import kv_cache as RKV
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.kernels import _build
from repro_torch.runtime import graphs as G
from repro_torch.runtime import serving as PS


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


# -- the LRU cache and the caps ---------------------------------------------------


@pytest.mark.parametrize("cap", [1, 2, 3, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_lru_get_matches_reference(cap, seed):
    """The same key sequence through ``lru_get`` and the reference's
    ``_lru_jit``: the same builds, contents and order after every call."""
    keys = np.random.default_rng(seed).integers(0, 6, 60).tolist()
    mine, ref = collections.OrderedDict(), collections.OrderedDict()
    built_mine, built_ref = [], []
    for k in keys:
        a = G.lru_get(mine, k, lambda k=k: built_mine.append(k) or f"fn{k}", cap=cap)
        b = RKV._lru_jit(ref, k, lambda k=k: built_ref.append(k) or f"fn{k}", cap=cap)
        assert a == b == f"fn{k}"
        assert list(mine.items()) == list(ref.items())
    assert built_mine == built_ref
    assert len(mine) <= cap


def test_module_caps_are_the_reference_caps():
    assert G._CHUNK_JIT_CAP == RS._CHUNK_JIT_CAP
    assert G._JIT_CACHE_CAP == RKV._JIT_CACHE_CAP


@pytest.mark.parametrize("cap", ["chunk_jit_cap", "page_jit_cap"])
@pytest.mark.parametrize("value", [0, -3])
def test_cap_validation_matches_reference(cap, value):
    for cls in (PS.ServeConfig, RS.ServeConfig):
        with pytest.raises(ValueError, match=f"{cap} must be >= 1 when set, got {value}"):
            cls(**{cap: value})
    for ok in (None, 1, 7):
        assert getattr(PS.ServeConfig(**{cap: ok}), cap) == getattr(
            RS.ServeConfig(**{cap: ok}), cap)


def test_caps_reach_the_caches(qwen):
    _, pcfg, _, params = qwen
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(
        max_seq=64, prefill_chunk=16, max_batch=2, paged=True, block_size=16,
        chunk_jit_cap=3, page_jit_cap=2), device="cpu")
    assert eng.servable.single._chunk_jit_cap == 3 and eng.kv._jit_cap == 2
    dflt = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(
        max_seq=64, prefill_chunk=16, max_batch=2, paged=True, block_size=16), device="cpu")
    assert dflt.servable.single._chunk_jit_cap == G._CHUNK_JIT_CAP
    assert dflt.kv._jit_cap == G._JIT_CACHE_CAP
    # One engine, one graph state: the servable's chunk cache and the
    # pool's page moves capture on the engine's pool.
    assert eng.servable.single.graphs is eng.graphs and eng.kv.graphs is eng.graphs


# -- cache keys against the JAX engine ----------------------------------------------


def _keys_on_both(setup, kw, script):
    """Run ``script`` on the JAX engine and the port's; the chunk cache's
    keys (in LRU order) and, paged, the pool's page-move keys must be equal,
    and so must the tokens per uid."""
    rcfg, pcfg, tree, params = setup
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**kw))
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    want, got = script(ref), script(eng)
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])
    keys = list(eng.servable.single._chunk_jit)
    assert keys == list(ref.single._chunk_jit)
    assert len(keys) <= eng.servable.single._chunk_jit_cap
    if eng.paged:
        for name in ("_scatter_jit", "_gather_jit", "_load_jit"):
            mine = list(getattr(eng.kv, name))
            assert mine == list(getattr(ref.kv, name)), name
            assert len(mine) <= eng.kv._jit_cap
    return eng, keys


def _run_all(prompts):
    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        out = eng.run()
        return {i: out[u] for i, u in enumerate(uids)}
    return script


def _evict_readmit(prompts, after=3):
    def script(eng):
        uids = [eng.submit(p) for p in prompts]
        for _ in range(after):
            if eng.pending:
                eng.step()
        ev = eng.evict(eng.active_slots[0].uid)
        eng.readmit(ev)
        out = eng.run()
        return {i: out[u] for i, u in enumerate(uids)}
    return script


SERVE_LENS = (24, 17, 40, 9, 33, 16)
SERVE_KW = dict(max_seq=48, prefill_chunk=16, max_new_tokens=6, max_batch=2, block_size=8)


@pytest.mark.parametrize("extra", [dict(paged=True), dict(paged=True, fused_prefill=False),
                                   dict(paged=False),
                                   dict(paged=True, spec_decode=True, spec_k=2)],
                         ids=["fused", "not-fused", "contiguous", "fused-spec"])
def test_chunk_and_page_keys_match_reference(qwen, extra):
    """tests/test_torch_serving.py's request set on both engines."""
    prompts = _prompts(qwen[0].vocab_size, SERVE_LENS, 7)
    eng, keys = _keys_on_both(qwen, dict(SERVE_KW, **extra), _run_all(prompts))
    fused = [k for k in keys if k[0] == "fused"]
    assert bool(fused) == bool(eng.scfg.fused_prefill) and keys
    if eng.paged and not eng.scfg.fused_prefill:
        assert list(eng.kv._scatter_jit)  # every admission scatters its pages


@pytest.mark.parametrize("extra", [dict(), dict(kv_dtype="int8"),
                                   dict(fused_prefill=False)], ids=str)
def test_page_keys_under_preemption_match_reference(qwen, extra):
    """tests/test_torch_preempt.py's two-slot thrash: gathers on evict,
    scatters on readmit, keyed by page count on both engines."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=32, max_batch=2, paged=True,
              block_size=16, num_blocks=8, **extra)
    prompts = _prompts(qwen[0].vocab_size, (32, 32), 73)
    eng, _ = _keys_on_both(qwen, kw, _run_all(prompts))
    assert eng.preemptions >= 1 and list(eng.kv._gather_jit) and list(eng.kv._scatter_jit)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_evict_readmit_keys_match_reference(qwen, paged):
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=2)
    if paged:
        kw.update(paged=True, block_size=16)
    prompts = _prompts(qwen[0].vocab_size, (24, 32), 3)
    eng, _ = _keys_on_both(qwen, kw, _evict_readmit(prompts))
    if paged:
        assert list(eng.kv._gather_jit) and list(eng.kv._scatter_jit)


@pytest.mark.parametrize("extra", [dict(paged=False), dict(paged=True, block_size=16),
                                   dict(paged=False, state_snapshots=True)],
                         ids=["contiguous", "paged", "snapshots"])
def test_mamba_keys_match_reference(mamba, extra):
    """The b=1 chunks are keyed (chunk_len, first, pos0) on both engines; a
    restored snapshot continues with first = False."""
    kw = dict(max_seq=128, prefill_chunk=16, max_new_tokens=6, max_batch=2, **extra)
    rng = np.random.default_rng(1)
    head = rng.integers(0, mamba[0].vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, mamba[0].vocab_size, n)
                               .astype(np.int32)]) for n in (20, 1, 17)]
    script = (_run_all(prompts) if extra.get("state_snapshots")
              else _evict_readmit(prompts))
    eng, keys = _keys_on_both(mamba, kw, script)
    assert all(k[0] != "fused" for k in keys)
    if extra.get("state_snapshots"):
        assert eng.snapshot_hits > 0 and any(not k[1] and k[2] for k in keys)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "not-fused"])
def test_shared_prefix_keys_match_reference(qwen, fused):
    """Prefix sharing: the tail's chunks keyed from the shared length on, and
    (not fused) the shared pages loaded through a ``_load_jit`` graph."""
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=4, max_batch=2, paged=True,
              block_size=8, prefix_sharing=True, fused_prefill=fused)
    rng = np.random.default_rng(5)
    head = rng.integers(0, qwen[0].vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, qwen[0].vocab_size, n)
                               .astype(np.int32)]) for n in (20, 9, 30)]
    eng, _ = _keys_on_both(qwen, kw, _run_all(prompts))
    assert eng.prefix_hits > 0
    assert bool(list(eng.kv._load_jit)) == (not fused)


@pytest.mark.parametrize("caps", [dict(chunk_jit_cap=1, page_jit_cap=1),
                                  dict(chunk_jit_cap=2, page_jit_cap=2)], ids=str)
def test_caps_bound_both_caches(qwen, caps):
    """Small caps evict the oldest graphs on both engines alike; tokens are
    unchanged (an evicted key is rebuilt)."""
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=16, max_batch=2, paged=True,
              block_size=16, num_blocks=8, fused_prefill=False, **caps)
    prompts = _prompts(qwen[0].vocab_size, (32, 32, 20, 45), 73)
    eng, keys = _keys_on_both(qwen, kw, _run_all(prompts))
    assert len(keys) == caps["chunk_jit_cap"]
    assert len(eng.kv._scatter_jit) <= caps["page_jit_cap"]


# -- StepGraph's policy through a capture stand-in ------------------------------------


class _Capture:
    """A capture backend for the CPU: records that a capture happened and
    returns a graph whose replay only counts (a real replay runs the
    recorded kernels; the host function does not run again)."""

    def __init__(self):
        self.captures = 0
        self.capturing = False
        self.replays = 0

    def __call__(self, fn):
        self.captures += 1
        self.capturing = True
        try:
            out = fn()
        finally:
            self.capturing = False
        backend = self

        class Graph:
            def replay(self):
                backend.replays += 1
        return Graph(), out


def _kernel():
    return _build.CudaKernel("paged_attention.cu", "test_only", [])


def test_step_graph_eager_capture_replay():
    cap = _Capture()
    graphs = G.Graphs(torch.device("cpu"), capture=cap)
    kernel = _kernel()
    try:
        runs = []

        def fn(x):
            runs.append("capture" if cap.capturing else "eager")
            kernel.launches += 2  # two host launches a step
            return x * 2

        step = G.StepGraph(graphs, fn, {"x": ((3,), torch.int32)})
        out = step(x=np.array([1, 2, 3]))
        assert runs == ["eager"] and cap.captures == 0 and cap.replays == 0
        assert out.tolist() == [2, 4, 6] and kernel.launches == 2
        out = step(x=np.array([4, 5, 6]))  # second use: capture, then replay
        assert runs == ["eager", "capture"] and cap.captures == 1 and cap.replays == 1
        assert graphs.captured == 1 and graphs.replays == 1
        assert step.launches == {kernel: 2}
        assert kernel.launches == 4  # the capture's calls taken out, the replay's in
        assert out is step.outputs and step.inputs["x"].tolist() == [4, 5, 6]
        for i in range(5):
            assert step(x=np.array([i, i, i])) is step.outputs
            assert step.inputs["x"].tolist() == [i, i, i]  # filled before each replay
        assert runs == ["eager", "capture"] and cap.captures == 1
        assert cap.replays == graphs.replays == 6 and kernel.launches == 2 * 7
    finally:
        _build.KERNELS.remove(kernel)


def test_step_graph_on_cpu_without_capture_is_eager():
    graphs = G.Graphs(torch.device("cpu"))
    assert graphs.capture is None
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b

    step = G.StepGraph(graphs, fn, {"a": ((2, 2), torch.int64), "b": ((2, 2), torch.int64)})
    for i in range(4):
        out = step(a=np.full((2, 2), i), b=np.ones((2, 2)))
        assert out.tolist() == [[i + 1] * 2] * 2
    assert len(calls) == 4 and graphs.captured == 0 and graphs.replays == 0


def test_capture_failure_raises():
    def broken(fn):
        raise RuntimeError("capture failed")
    step = G.StepGraph(G.Graphs(torch.device("cpu"), capture=broken), lambda: 1, {})
    assert step() == 1
    with pytest.raises(RuntimeError, match="capture failed"):
        step()


def test_engine_under_capture_stand_in_counts_graphs(qwen):
    """The whole engine with the stand-in backend: its tick, chunk and page
    graphs capture once per key, from the key's second use, and replay
    after; the first runs are eager.  The stand-in's replay runs nothing,
    so only the counts are checked here (the card tests hold the outputs)."""
    _, pcfg, _, params = qwen
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=6, max_batch=2, paged=True,
              block_size=16, fused_prefill=False)
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    cap = _Capture()
    eng.graphs.capture = cap
    steps = [eng._decode]
    eng.submit(_prompts(pcfg.vocab_size, (20,), 1)[0])
    eng.step()  # admission: chunks (eager), the scatter (eager)
    assert cap.captures == 0
    eng.step()  # first tick: eager
    assert cap.captures == 0 and eng._decode.uses == 1
    eng.step()  # second tick: capture + replay
    assert cap.captures == 1 and cap.replays == 1 and eng._decode.graph is not None
    eng.step()
    assert cap.captures == 1 and cap.replays == 2
    graphs = [s for s in (*steps, *eng.servable.single._chunk_jit.values(),
                          *eng.kv._scatter_jit.values())]
    assert all((s.graph is not None) == (s.uses > 1) for s in graphs)
