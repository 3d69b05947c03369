"""The port's engine telemetry against the JAX engine's, on the CPU, f32,
equal weights through the bridge: for the modes of ``tests/test_obs.py``
(contiguous, paged, paged with a shared prefix, paged spec decode) plus
int8 pages, mamba2 with state snapshots and a 22-block pool that preempts
(phase 5's requests), both engines serve the same requests twice — traced
with an always-met ``SLOPolicy`` (targets at infinity), then untraced with
an always-violated one (targets at 1e-12 s) — and must record the same
span sequence (track, name and every argument but the queue wait's
seconds, in record order and in time order), the same counters but the
two clocks, the same histogram counts, snapshots with the same keys and
the same SLO counters under both policies.  Tracing leaves the tokens as
they were, the untraced run records nothing, no honest tick trips the live
STR002 gate and an overfetch trips it once; the counter attributes stay
assignable and the latency fields ride through evict and readmit; the
launcher's ``--trace`` and ``--metrics-out`` files read back."""

import json
import math
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as RC
from repro import obs as RO
from repro.analysis.budget import TransferBudget as RTB
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch import obs as PO
from repro_torch.analysis.budget import TransferBudget as PTB
from repro_torch.runtime import serving as PS

TIME_ARGS = ("queue_wait_s",)  # span arguments that are clock readings
CLOCKS = ("time.tick_seconds", "serving.admit_seconds")  # counters that are seconds
MET = dict(ttft_s=math.inf, itl_s=math.inf)
VIOLATED = dict(ttft_s=1e-12, itl_s=1e-12)
PHASE5_LENS = (128, 100, 77, 128, 64, 33)  # chip_smoke's requests, and its pool of 22


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


def _random(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _headed(vocab, head, tails, seed):
    """Prompts that all start with one ``head``-token prefix."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, vocab, head)
    return [np.concatenate([h, rng.integers(0, vocab, n)]).astype(np.int32) for n in tails]


def _tiled(vocab, seed):
    """Repeating prompts, on which the n-gram drafter hits."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, vocab, 8), reps).astype(np.int32) for reps in (3, 4, 5, 2)]


BASE = dict(max_seq=64, prefill_chunk=16, max_new_tokens=5, max_batch=2)
MODES = {  # name -> (arch fixture, ServeConfig fields, prompts(vocab))
    "contiguous": ("qwen", {}, lambda v: _random(v, (24, 32, 16), 7)),
    "paged": ("qwen", dict(paged=True, block_size=16), lambda v: _random(v, (24, 32, 16), 7)),
    "paged_sharing": ("qwen", dict(paged=True, block_size=16, prefix_sharing=True),
                      lambda v: _headed(v, 16, (8, 16, 24), 50)),
    "paged_spec": ("qwen", dict(paged=True, block_size=16, spec_decode=True, spec_k=4,
                                max_seq=96, max_new_tokens=12), lambda v: _tiled(v, 3)),
    "int8": ("qwen", dict(paged=True, block_size=16, kv_dtype="int8"),
             lambda v: _random(v, (24, 32, 16), 7)),
    "mamba2_snapshots": ("mamba", dict(state_snapshots=True),
                         lambda v: _headed(v, 16, (8, 16, 24), 51)),
    "preempt_22": ("qwen", dict(max_seq=144, prefill_chunk=64, max_new_tokens=16, max_batch=4,
                                paged=True, block_size=16, num_blocks=22),
                   lambda v: _random(v, PHASE5_LENS, 0)),
}


def _serve(eng, prompts):
    uids = [eng.submit(p) for p in prompts]
    out = eng.run()
    return [out[u] for u in uids]


def _observe(eng, tracer, prompts):
    return {"tokens": _serve(eng, prompts), "record": list(tracer._buf),
            "spans": tracer.spans(), "dropped": tracer.dropped,
            "snapshot": eng.metrics_snapshot()}


@pytest.fixture(scope="module")
def runs(request):
    """mode -> {"reference": (run 1, run 2, engine), "port": (...)}, made on
    first use.  Run 1 is traced with the always-met policy; run 2 serves the
    same requests on the same engine with a disabled tracer, a fresh
    registry and the always-violated policy."""
    cache = {}

    def get(mode):
        if mode in cache:
            return cache[mode]
        arch, fields, prompts_of = MODES[mode]
        rcfg, pcfg, tree, params = request.getfixturevalue(arch)
        kw = dict(BASE, **fields)
        prompts = prompts_of(rcfg.vocab_size)
        engines = {
            "reference": (RO, RS.StreamedBatchEngine(
                rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**kw),
                tracer=RO.Tracer(), slo=RO.SLOPolicy(**MET))),
            "port": (PO, PS.StreamedBatchEngine(
                pcfg, params, PS.ServeConfig(**kw), device="cpu", tracer=PO.Tracer(),
                slo=PO.SLOPolicy(**MET)))}
        out = {}
        for name, (O, eng) in engines.items():
            first = _observe(eng, eng.obs, prompts)
            eng.obs, eng.metrics, eng.slo = (O.Tracer(enabled=False), O.MetricsRegistry(),
                                             O.SLOPolicy(**VIOLATED))
            out[name] = (first, _observe(eng, eng.obs, prompts), eng)
        cache[mode] = out
        return out
    return get


def _seq(spans):
    return [(s.track, s.name, {k: v for k, v in s.args.items() if k not in TIME_ARGS})
            for s in spans]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_span_sequences_match_reference(runs, mode):
    got = runs(mode)
    ref, port = got["reference"][0], got["port"][0]
    assert port["dropped"] == ref["dropped"] == 0
    assert _seq(port["record"]) == _seq(ref["record"])
    assert _seq(port["spans"]) == _seq(ref["spans"])
    assert all(s.t1_ns >= s.t0_ns for s in port["spans"])
    names = {s.name for s in port["spans"]}
    assert {"admit", "h2d_stage", "prefill_chunk"} <= names
    assert ("spec_tick" if mode == "paged_spec" else "decode_tick") in names
    if mode == "preempt_22":
        assert {"evict", "readmit"} <= names


@pytest.mark.parametrize("mode", sorted(MODES))
def test_counters_and_histograms_match_reference(runs, mode):
    got = runs(mode)
    for run in (0, 1):
        ref, port = (got[n][run]["snapshot"] for n in ("reference", "port"))
        assert ({k: v for k, v in port["counters"].items() if k not in CLOCKS}
                == {k: v for k, v in ref["counters"].items() if k not in CLOCKS})
        assert ({k: h["count"] for k, h in port["histograms"].items()}
                == {k: h["count"] for k, h in ref["histograms"].items()})
        assert "analysis.str002_live" not in port["counters"]  # honest ticks
    c = got["port"][0]["snapshot"]["counters"]
    assert c["serving.decode_steps"] > 0 and c["transfer.d2h_bytes"] > 0
    if mode == "preempt_22":
        assert c["serving.preemptions"] >= 2
    if mode == "paged_spec":
        assert c["serving.spec_ticks"] > 0 and c["serving.spec_accepted"] > 0
    if mode == "paged_sharing":
        assert c["serving.prefix_hits"] > 0
    if mode == "mamba2_snapshots":
        assert c["serving.snapshot_hits"] > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_snapshot_keys_and_slo_match_reference(runs, mode):
    got = runs(mode)
    for run, policy in ((0, "met"), (1, "violated")):
        ref, port = (got[n][run]["snapshot"] for n in ("reference", "port"))

        def keys(s):
            d = s["derived"]
            return (s["schema"], sorted(s["counters"]), sorted(s["histograms"]),
                    {k: sorted(v) for k, v in s["histograms"].items()}, sorted(d),
                    sorted(d["slo"]), sorted(d.get("pool", {})))
        assert keys(port) == keys(ref)
        slo_p = {k: v for k, v in port["derived"]["slo"].items() if k != "goodput_tokens_per_s"}
        slo_r = {k: v for k, v in ref["derived"]["slo"].items() if k != "goodput_tokens_per_s"}
        assert slo_p == slo_r
        n = len(MODES[mode][2](1000))
        assert slo_p["requests"] == n
        assert slo_p["attainment"] == (1.0 if policy == "met" else 0.0)
        if policy == "violated":
            assert slo_p["ttft_violations"] == n and slo_p["itl_violations"] == n
        json.dumps(port)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tracing_leaves_tokens_and_untraced_records_nothing(runs, mode):
    got = runs(mode)
    (first, second, eng), (rfirst, _, ref) = got["port"], got["reference"]
    for a, b in zip(first["tokens"], second["tokens"]):
        np.testing.assert_array_equal(a, b)
    if eng.scfg.kv_dtype == "fp32":
        for a, b in zip(first["tokens"], rfirst["tokens"]):
            np.testing.assert_array_equal(a, b)
    assert not eng.obs.enabled and second["spans"] == [] and second["record"] == []
    assert second["snapshot"]["counters"]["serving.decode_steps"] > 0  # counters stay live


def test_untraced_engine_has_a_disabled_tracer(qwen):
    _, pcfg, _, params = qwen
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**BASE), device="cpu")
    _serve(eng, _random(pcfg.vocab_size, (16,), 1))
    assert not eng.obs.enabled and eng.obs.spans() == [] and eng.obs.t() == 0
    assert eng.decode_steps > 0 and "slo" not in eng.metrics_snapshot()["derived"]


def test_counter_attributes_stay_assignable(qwen):
    """The counters are views of the registry (tests/test_obs.py
    test_counter_shims_route_through_registry): read, reset, incremented."""
    _, pcfg, _, params = qwen
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**BASE), device="cpu")
    _serve(eng, _random(pcfg.vocab_size, (24,), 2))
    assert eng.decode_steps == eng.metrics.value("serving.decode_steps") > 0
    assert eng.admissions == eng.metrics.value("serving.admissions") == 1
    eng.decode_steps = 0
    assert eng.metrics.value("serving.decode_steps") == 0
    eng.metrics.inc("serving.decode_steps", 3)
    assert eng.decode_steps == 3
    assert isinstance(PS.StreamedBatchEngine.decode_steps, PS._MetricAttr)
    names = sorted(k for k, v in vars(PS.StreamedBatchEngine).items()
                   if isinstance(v, PS._MetricAttr))
    assert names == sorted(k for k, v in vars(RS.StreamedBatchEngine).items()
                           if isinstance(v, RS._MetricAttr))
    assert "serving.prefill_chunks" not in eng.metrics.snapshot()["counters"]
    assert eng.prefill_chunks > 0  # the port's own counter stays an attribute


def test_live_str002_on_overfetch(qwen):
    """A declared budget below the tick's honest 4 B a slot: every tick is
    a live STR002 (counter, instant span on the transfer track), one warning
    an engine, as the reference's; off without a tracer."""
    rcfg, pcfg, tree, params = qwen
    prompts = _random(pcfg.vocab_size, (16, 24), 4)
    got = {}
    for name, O, eng, tb in (
            ("reference", RO, RS.StreamedBatchEngine(
                rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**BASE),
                tracer=RO.Tracer()), RTB),
            ("port", PO, PS.StreamedBatchEngine(
                pcfg, params, PS.ServeConfig(**BASE), device="cpu", tracer=PO.Tracer()), PTB)):
        eng._decode_budget = tb(1, (0,), 1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _serve(eng, prompts)
        flagged = [s for s in eng.obs.spans() if s.name == "STR002"]
        assert [str(w.message)[:15] for w in caught
                if issubclass(w.category, RuntimeWarning)] == ["STR002 (live): "]
        assert flagged and all(s.track == "transfer" for s in flagged)
        assert all(s.args["d2h_bytes"] > s.args["limit"] for s in flagged)
        got[name] = (eng.metrics.value("analysis.str002_live"), _seq(flagged))
        assert got[name][0] == len(flagged) == eng.decode_steps
        eng.obs, eng.metrics = O.Tracer(enabled=False), O.MetricsRegistry()
        _serve(eng, prompts)  # untraced: the accounting is off
        assert eng.metrics.value("analysis.str002_live") == 0
    assert got["port"] == got["reference"]


def test_latency_fields_ride_evict_and_readmit(qwen):
    """A request evicted mid decode keeps its TTFT, last-token clock and
    worst ITL; after readmission its next tick's gap holds the stall, and
    its trace timeline shows the eviction, the stall and both slots; the
    spans equal the reference engine's under the same script."""
    rcfg, pcfg, tree, params = qwen
    kw = dict(BASE, max_new_tokens=8, paged=True, block_size=16)
    prompts = _random(pcfg.vocab_size, (24, 16), 9)
    seqs = {}
    for name, O, eng in (
            ("reference", RO, RS.StreamedBatchEngine(
                rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**kw),
                tracer=RO.Tracer())),
            ("port", PO, PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw),
                                                device="cpu", tracer=PO.Tracer()))):
        uid_a, uid_b = [eng.submit(p) for p in prompts]
        for _ in range(3):
            eng.step()
        slot = next(s for s in eng.slots if s.uid == uid_a)
        before = (slot.ttft_s, slot.t_last, slot.itl_max)
        assert before[0] > 0 and before[1] > 0
        ev = eng.evict(uid_a)
        assert (ev.ttft_s, ev.t_last, ev.itl_max, ev.evictions) == before + (1,)
        eng.step()
        time.sleep(0.02)  # the stall
        slot = eng.slots[eng.readmit(ev)]
        assert (slot.ttft_s, slot.t_last, slot.itl_max, slot.evictions) == before + (1,)
        out = eng.run()
        tls = {t.uid: t for t in O.reconstruct_timelines(eng.obs.spans())}
        tl = tls[uid_a]
        assert tl.evictions == 1 and not tl.open_stall and len(tl.slots) == 2
        assert tl.finished and tl.tokens == len(out[uid_a])
        assert tl.stall_s >= 0.02 and tl.itl_max_s >= tl.stall_s
        assert eng.metrics.histogram("latency.itl_s").max >= 0.02
        seqs[name] = _seq(eng.obs.spans())
    assert seqs["port"] == seqs["reference"]


def test_launcher_writes_trace_and_metrics(tmp_path, capsys):
    """``--trace`` and ``--metrics-out`` on the CPU: the Chrome trace reads
    back through both packages' timelines and doctors alike, the snapshot
    is the reference's schema with the SLO block."""
    from repro_torch.launch import serve as pserve
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    pserve.main(["--device", "cpu", "--paged", "--requests", "3", "--prompt-len", "24",
                 "--new-tokens", "4", "--prefill-chunk", "8", "--max-batch", "2",
                 "--trace", str(trace), "--metrics-out", str(metrics),
                 "--slo-ttft-ms", "60000", "--slo-itl-ms", "60000"])
    out = capsys.readouterr().out
    assert f"[serve] trace: {trace}" in out and "[serve] requests: 3 timelines" in out
    snap = json.loads(metrics.read_text())
    assert snap["schema"] == RO.SCHEMA_VERSION and snap["derived"]["slo"]["attainment"] == 1.0
    tls = PO.timelines_from_trace(str(trace))
    assert len(tls) == 3 and all(t.finished and t.tokens == 4 for t in tls)
    assert ([(t.uid, t.tokens, t.itl_s) for t in RO.timelines_from_trace(str(trace))]
            == [(t.uid, t.tokens, t.itl_s) for t in tls])
    from repro.obs.doctor import diagnose as rdiag
    from repro_torch.obs.doctor import diagnose as pdiag
    spans = PO.read_trace(str(trace))
    assert ([f.as_dict() for f in pdiag(spans, snapshot=snap)]
            == [f.as_dict() for f in rdiag(RO.read_trace(str(trace)), snapshot=snap)])
    with pytest.raises(SystemExit):
        pserve.main(["--device", "cpu", "--sequential", "--trace", str(trace)])


@pytest.mark.slow
def test_trace_overhead_guard(qwen):
    """Tracing costs < 5% tokens/s (tests/test_obs.py's guard, on the
    port's CPU engine): median of 5 interleaved runs of each."""
    _, pcfg, _, params = qwen
    scfg = PS.ServeConfig(**dict(BASE, paged=True, block_size=16))
    prompts = _random(pcfg.vocab_size, (24, 32, 16, 24), 13)

    def build(tr):
        eng = PS.StreamedBatchEngine(pcfg, params, scfg, device="cpu", tracer=tr)
        _serve(eng, prompts[:1])
        return eng

    engines = {False: build(None), True: build(PO.Tracer())}
    walls = {False: [], True: []}
    for _ in range(5):
        for traced, eng in engines.items():
            if traced:
                eng.obs.clear()
            t0 = time.perf_counter()
            _serve(eng, prompts)
            walls[traced].append(time.perf_counter() - t0)
    ratio = float(np.median(walls[False]) / np.median(walls[True]))
    assert ratio >= 0.95, f"tracing overhead too high: {ratio:.3f}x"
