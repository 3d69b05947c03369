"""The port's observability modules (``repro_torch.obs``) against the JAX
package's (``repro.obs``): every synthetic case of ``tests/test_obs.py``
(histogram, registry, tracer, overlap), ``tests/test_obs_requests.py``
(timelines, SLO) and ``tests/test_obs_doctor.py`` (one fixture a rule, the
ranking, the reports, the CLI) runs through both packages, which must give
equal results; and the trace format both ways: a Chrome trace written by
either package's ``Tracer.to_chrome`` (the port's from a traced CPU serve)
reads back through the other's ``read_trace``, ``timelines_from_trace`` and
``diagnose`` exactly as through its own."""

import contextlib
import dataclasses
import enum
import io
import json
import time

import numpy as np
import pytest

import repro.obs as RO
import repro.obs.doctor as RD
from repro.core import rmetric as RR
import repro_torch.obs as PO
import repro_torch.obs.doctor as PD
from repro_torch import configs as PC
from repro_torch.core import rmetric as PR
from repro_torch.models import transformer as PT
from repro_torch.runtime import serving as PS

MS = 1_000_000  # ns
PACKAGES = {"reference": (RO, RD, RR), "port": (PO, PD, PR)}


def _norm(x):
    """A comparable plain form: dataclasses (spans, timelines, findings,
    stage times) as dicts, enums as their values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"type": type(x).__name__,
                **{f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, enum.Enum):
        return x.value
    return x


def _admit(O, uid, t0, t1, *, queue_wait_s=0.0, prompt_len=8, max_new=4, slot=0, chunks=1,
           shared_len=0):
    return O.Span("prefill", "admit", t0, t1, dict(
        uid=uid, chunks=chunks, shared_len=shared_len, prompt_len=prompt_len, slot=slot,
        queue_wait_s=queue_wait_s, max_new=max_new))


def _tick(O, t0, t1, uids=(), toks=(), name="decode_tick"):
    return O.Span("decode", name, t0, t1, dict(uids=list(uids), toks=list(toks),
                                              slot_ids=list(range(len(uids)))))


def _evict(O, uid, t0, t1, pages=3):
    return O.Span("transfer", "evict", t0, t1, dict(uid=uid, pages=pages, cur=9, slot=0))


def _readmit(O, uid, t0, t1, slot=1):
    return O.Span("transfer", "readmit", t0, t1, dict(uid=uid, pages=2, shared_pages=0,
                                                      slot=slot))


# -- metrics, tracer, overlap (tests/test_obs.py) -------------------------------------

def _histogram(O, D, R):
    h = O.Histogram()
    for v in range(1, 101):
        h.observe(v * 1e-3)
    one = O.Histogram()
    one.observe(3.0)
    return [h.snapshot(), one.quantile(0.0), one.quantile(1.0), O.Histogram().snapshot()]


def _registry(O, D, R):
    m = O.MetricsRegistry()
    m.inc("a")
    m.inc("a", 4)
    m.set_value("b", 7)
    m.max_value("b", 3)
    m.max_value("b", 9)
    m.inc("x")
    m.observe("lat", 0.5)
    return [m.value("a"), m.value("b"), m.value("missing", -1), sorted(m.names()),
            m.snapshot(), O.SCHEMA_VERSION]


def _tracer(O, D, R):
    off = O.Tracer(enabled=False)
    off.add("decode", "tick", off.t())
    off.instant("transfer", "STR002")
    ring = O.Tracer(capacity=4)
    for i in range(6):
        ring.add("decode", f"s{i}", ring.t())
    with pytest.raises(ValueError) as err:
        O.Tracer(capacity=0)
    return [off.t(), off.spans(), off.dropped, [s.name for s in ring.spans()], ring.dropped,
            str(err.value), list(O.TRACKS)]


def _span_tree(O, D, R):
    spans = [O.Span("prefill", "admit", 0, 100, {}),
             O.Span("prefill", "prefill_chunk", 10, 40, {}),
             O.Span("prefill", "prefill_chunk", 50, 90, {}),
             O.Span("decode", "decode_tick", 0, 30, {})]
    return O.span_tree(spans)


def _overlap(O, D, R):
    spans = [O.Span("decode", "decode_tick", 0, 20 * MS, {}),
             O.Span("transfer", "h2d_stage", 5 * MS, 15 * MS, {}),
             O.Span("transfer", "evict", 25 * MS, 35 * MS, {})]
    balanced = R.StageTimes(h2d=1.0, kex=1.0, d2h=1.0)
    return [O.measured_overlap(spans), O.measured_overlap([O.Span("decode", "t", 0, 10, {})]),
            O.measured_overlap(spans, dropped=3),
            O.predicted_overlap(balanced),
            O.predicted_overlap(R.StageTimes(h2d=1e-3, kex=1.0, d2h=1e-3)),
            O.predicted_overlap(R.StageTimes(h2d=0.02, kex=0.001)),
            O.overlap_report(spans[:2], stage_times=balanced, category="independent"),
            O.overlap_report(spans)]


def _stage_times(O, D, R):
    spans = []
    for i in range(3):
        base = 100 * i * MS
        spans.append(_admit(O, i, base, base + 40 * MS, chunks=2))
        spans.append(O.Span("decode", "decode_tick", base + 10 * MS, base + 20 * MS, {}))
    return [O.stage_times_from_trace(spans), O.stage_times_from_trace(spans[:2])]


# -- timelines and SLO (tests/test_obs_requests.py) ------------------------------------

def _timelines(O, D, R):
    cases = [
        [],
        [_admit(O, 7, 0, 10 * MS, queue_wait_s=0.005, max_new=3),
         _tick(O, 10 * MS, 14 * MS, [7], [1]), _tick(O, 14 * MS, 20 * MS, [7], [1])],
        [_admit(O, 1, 0, 10 * MS, max_new=7),
         _tick(O, 10 * MS, 22 * MS, [1], [3], name="spec_tick"),
         _tick(O, 22 * MS, 30 * MS, [1], [3], name="spec_tick")],
        [_admit(O, 1, 0, 10 * MS, max_new=16), _tick(O, 10 * MS, 15 * MS, [1], [1])],
        [_admit(O, 1, 0, 10 * MS, max_new=8), _tick(O, 10 * MS, 15 * MS, [1], [1]),
         _evict(O, 1, 15 * MS, 16 * MS), _tick(O, 16 * MS, 40 * MS)],
        [_admit(O, 1, 0, 10 * MS, max_new=4), _tick(O, 10 * MS, 14 * MS, [1], [1]),
         _evict(O, 1, 14 * MS, 15 * MS, pages=2), _readmit(O, 1, 30 * MS, 31 * MS),
         _tick(O, 31 * MS, 35 * MS, [1], [1]), _tick(O, 35 * MS, 39 * MS, [1], [1])],
        [_tick(O, 0, 5 * MS, [3], [1])],
        [_admit(O, 1, 0, 10 * MS, queue_wait_s=0.002, max_new=2),
         _admit(O, 2, 0, 20 * MS, queue_wait_s=0.004, max_new=2, slot=1),
         _tick(O, 20 * MS, 24 * MS, [1, 2], [1, 1]),
         O.Span("transfer", "h2d_stage", 0, MS, dict(uid=2, h2d_bytes=64)),
         O.Span("transfer", "page_scatter", MS, 2 * MS, dict(uid=2, pages=2))],
    ]
    out = []
    for spans in cases:
        tls = O.reconstruct_timelines(spans)
        out.append([tls, [(t.stall_s, t.itl_mean_s, t.itl_max_s) for t in tls],
                    O.timeline_aggregates(tls)])
    spans = cases[1]
    with pytest.warns(RuntimeWarning, match="dropped 5 spans"):
        out.append(O.reconstruct_timelines(spans, dropped=5))
    out.append(O.reconstruct_timelines(spans, dropped=5, warn=False))
    return out


def _slo(O, D, R):
    p = O.SLOPolicy(ttft_s=0.1, itl_s=0.05)
    with pytest.raises(ValueError) as err:
        O.SLOPolicy(ttft_s=0.0)
    spans = [_admit(O, 1, 0, 10 * MS, max_new=2), _tick(O, 10 * MS, 14 * MS, [1], [1]),
             _admit(O, 2, 0, 10 * MS, max_new=99), _tick(O, 0, 5 * MS, [9], [1])]
    tls = O.reconstruct_timelines(spans)
    return [p.met(ttft_s=0.1, itl_s=0.05), p.met(ttft_s=0.11, itl_s=0.01),
            p.met(ttft_s=0.01, itl_s=0.06), O.SLOPolicy.from_ms(ttft_ms=250).as_dict(),
            O.SLOPolicy.from_ms().as_dict(), str(err.value),
            O.score_timelines(tls, O.SLOPolicy(ttft_s=1.0, itl_s=1.0), wall_s=2.0),
            O.score_timelines(tls[:1], O.SLOPolicy(ttft_s=1e-6, itl_s=1.0))]


# -- the doctor (tests/test_obs_doctor.py) ---------------------------------------------

def _doctor_fixtures(O):
    """{name: (spans, kwargs of diagnose)}, one a rule and the ranking."""
    queue = []
    for uid in range(4):
        t0 = uid * 100 * MS
        queue += [_admit(O, uid, t0, t0 + 10 * MS, chunks=0, queue_wait_s=0.090, max_new=2),
                  _tick(O, t0 + 10 * MS, t0 + 14 * MS, [uid], [1])]
    spec = []
    for i in range(20):
        t = 3 * i * MS
        spec += [O.Span("decode", "spec_draft", t, t + MS, dict(proposed=4)),
                 O.Span("decode", "spec_rollback", t + MS, t + 2 * MS, dict(accepted=0))]
    thrash = []
    for uid in range(4):
        t0 = uid * 20 * MS
        thrash += [_admit(O, uid, t0, t0 + 5 * MS, max_new=99),
                   O.Span("transfer", "evict", t0 + 6 * MS, t0 + 7 * MS,
                          dict(uid=uid, pages=4, cur=9, slot=0)),
                   O.Span("transfer", "readmit", t0 + 9 * MS, t0 + 10 * MS,
                          dict(uid=uid, pages=4, shared_pages=0, slot=0))]
    return {
        "DOC001": ([_admit(O, 1, 0, 1000 * MS, chunks=10, max_new=3),
                    _tick(O, 1000 * MS, 1100 * MS, [1], [1]),
                    _tick(O, 1100 * MS, 1200 * MS, [1], [1])], {}),
        "DOC002": (queue, {}),
        "DOC002 info": (queue[:4], {}),
        "DOC003 snapshot": ([], dict(snapshot={"counters": {"serving.spec_proposed": 200,
                                                            "serving.spec_accepted": 20}})),
        "DOC003 spans": (spec, {}),
        "DOC003 floor": ([], dict(snapshot={"counters": {"serving.spec_proposed": 8}})),
        "DOC004": (thrash, {}),
        "DOC005 marker": ([O.Span("transfer", "STR002", 5 * MS, 5 * MS,
                                  dict(tick=3, d2h_bytes=4096, budget=128))], {}),
        "DOC005 counter": ([], dict(snapshot={"counters": {"analysis.str002_live": 2}})),
        "DOC006": ([_admit(O, 1, 0, 10 * MS, chunks=0, max_new=2),
                    _tick(O, 10 * MS, 14 * MS, [1], [1])], dict(dropped=17)),
        "ranking": ([s for s in thrash if s.name != "readmit"], dict(dropped=3)),
    }


def _doctor(O, D, R):
    out = {}
    for name, (spans, kw) in _doctor_fixtures(O).items():
        findings = D.diagnose(spans, **kw)
        out[name] = [[f.as_dict() for f in findings],
                     D.render(findings, spans=len(spans), requests=3, dropped=0),
                     D.report_json(findings, spans=len(spans), requests=3, dropped=0)]
    f = D.Finding(rule="DOCX", severity="high", title="t", detail="d", category="c",
                  knobs=["k"])
    out["render"] = [D.render([f], spans=5, requests=2, dropped=0),
                     D.render([], spans=5, requests=2, dropped=0), list(D.SEVERITIES)]
    return out


CASES = {"histogram": _histogram, "registry": _registry, "tracer": _tracer,
         "span_tree": _span_tree, "overlap": _overlap, "stage_times": _stage_times,
         "timelines": _timelines, "slo": _slo, "doctor": _doctor}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_cases_match_reference(case):
    got = {name: _norm(CASES[case](*mods)) for name, mods in PACKAGES.items()}
    assert got["port"] == got["reference"]


def test_schema_and_thresholds_match_reference():
    assert PO.SCHEMA_VERSION == RO.SCHEMA_VERSION
    assert PO.TRACKS == RO.TRACKS
    assert sorted(PO.__all__) == sorted(RO.__all__)
    names = ("OVERLAP_GAP_INFO", "OVERLAP_GAP_MEDIUM", "OVERLAP_PRED_MIN",
             "QUEUE_FRACTION_MEDIUM", "QUEUE_MIN_REQUESTS", "SPEC_PROPOSED_MIN",
             "SPEC_ACCEPT_COLLAPSE", "THRASH_PER_REQUEST", "THRASH_MIN_EVICTIONS",
             "SEVERITIES")
    assert {n: getattr(PD, n) for n in names} == {n: getattr(RD, n) for n in names}


# -- the trace format, both ways -------------------------------------------------------

@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A traced CPU serve of the port's engine (paged, 4 requests through 2
    slots, one evicted and readmitted mid decode), on disk as ``serve.py
    --trace`` / ``--metrics-out`` leave them."""
    cfg = PC.get_smoke_config("qwen3-4b")
    params = PT.init_params(cfg, 0, device="cpu")
    scfg = PS.ServeConfig(max_seq=64, prefill_chunk=16, max_new_tokens=5, max_batch=2,
                          paged=True, block_size=16)
    eng = PS.StreamedBatchEngine(cfg, params, scfg, device="cpu", tracer=PO.Tracer(),
                                 slo=PO.SLOPolicy(ttft_s=60.0, itl_s=60.0))
    rng = np.random.default_rng(30)
    uids = [eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32))
            for n in (24, 16, 32, 16)]
    for _ in range(3):
        eng.step()
    eng.readmit(eng.evict(uids[0]))
    eng.run()
    d = tmp_path_factory.mktemp("port_trace")
    eng.obs.to_chrome(str(d / "trace.json"))
    (d / "metrics.json").write_text(json.dumps(eng.metrics_snapshot()))
    return str(d / "trace.json"), str(d / "metrics.json")


@pytest.fixture(scope="module")
def reference_trace(tmp_path_factory):
    """A trace written by the reference's ``Tracer``: two requests' admit,
    staging, chunk, tick, evict and readmit spans, real clock reads."""
    tr = RO.Tracer()
    for uid in range(2):
        t0 = tr.t()
        tr.add("transfer", "h2d_stage", tr.t(), uid=uid, h2d_bytes=96)
        tr.add("prefill", "prefill_chunk", tr.t(), uid=uid, pos=16, fused=True)
        time.sleep(1e-4)
        tr.add("prefill", "admit", t0, uid=uid, chunks=1, shared_len=0, prompt_len=24,
               slot=uid, queue_wait_s=1e-4 * uid, max_new=3)
    for tick in range(1, 3):
        t0 = tr.t()
        time.sleep(1e-4)
        tr.add("decode", "decode_tick", t0, tick=tick, slots=2, tokens=2, d2h_bytes=8,
               h2d_bytes=16, uids=[0, 1], slot_ids=[0, 1], toks=[1, 1])
    tr.add("transfer", "evict", tr.t(), uid=1, pages=2, cur=25, slot=1)
    tr.add("transfer", "readmit", tr.t(), uid=1, pages=2, shared_pages=0, slot=0)
    tr.instant("transfer", "STR002", tick=2, d2h_bytes=8, limit=4)
    path = tmp_path_factory.mktemp("ref_trace") / "trace.json"
    tr.to_chrome(str(path))
    return str(path), None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_files_read_alike(writer, port_trace, reference_trace):
    path, metrics = port_trace if writer == "port" else reference_trace
    snapshot = json.loads(open(metrics).read()) if metrics else None
    got = {}
    for name, (O, D, _) in PACKAGES.items():
        spans = O.read_trace(path)
        got[name] = _norm([spans, O.timelines_from_trace(path),
                           D.diagnose(spans, snapshot=snapshot),
                           O.overlap_report(spans), O.stage_times_from_trace(spans)])
        assert spans and all(s.t1_ns >= s.t0_ns for s in spans)
    assert got["port"] == got["reference"]
    if writer == "port":  # a real serve: every request's whole lifecycle
        tls = PO.timelines_from_trace(path)
        assert len(tls) == 4 and all(t.finished and not t.partial for t in tls)
        assert sum(t.evictions for t in tls) == 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_doctor_cli_reads_alike(writer, port_trace, reference_trace):
    path, metrics = port_trace if writer == "port" else reference_trace
    argv = [path, "--json"] + (["--metrics", metrics] if metrics else [])
    outs = {}
    for name, (_, D, _) in PACKAGES.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = D.main(argv)
        outs[name] = (rc, json.loads(buf.getvalue()))
    assert outs["port"] == outs["reference"]
    rc, doc = outs["port"]
    assert rc == 0 and doc["schema"] == 1
    if writer == "reference":  # its STR002 marker: DOC005 fails a high bar
        with contextlib.redirect_stdout(io.StringIO()):
            assert PD.main([path, "--fail-on", "high"]) == 1
            assert RD.main([path, "--fail-on", "high"]) == 1
