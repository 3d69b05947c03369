"""The port's stream-safety analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

The port's audit of the real engine must report what the reference's
reports, path by path (d2h counts, bytes per slot, budgets, categories),
with equal step footprints, and both must be clean.  Each known-bad
fixture (written inline: AST fixtures as source strings, step and pool
fixtures as small objects) must trip *exactly* its rule.  The runtime
sanitizer must fire on a corrupted pool and stay off by default.  The
live audit's fetch accounting runs here; its sync checks need a card
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import json
import pathlib
import types
import unittest.mock

import numpy as np
import pytest
import torch

import repro_torch.configs as C
from repro_torch.analysis import (RULES, Finding, apply_waivers, astlint, host_fetch,
                                  kernelcheck, load_waivers, poolcheck, synccheck,
                                  tick_path, transfer_budget)
from repro_torch.analysis import __main__ as cli
from repro_torch.core import dependency as dep
from repro_torch.kernels import paged_attention as PA
from repro_torch.runtime.graphs import Graphs, StepGraph
from repro_torch.runtime.kv_cache import BlockAllocator, PagedKVCache, PoolInvariantError

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# Rule registry / waivers


def test_rule_catalog_matches_reference():
    from repro.analysis import RULES as REF_RULES

    assert set(RULES) == set(REF_RULES)
    for rid, desc in RULES.items():
        assert desc, rid


def test_waivers_match_by_rule_and_target():
    f1 = Finding("STR001", "transformer/paged:decode", "x", "sync")
    f2 = Finding("KRN001", "flash_attention:shape[0]", "y", "kernel")
    waivers = [{"rule": "STR001", "target": "transformer/paged", "reason": "known"}]
    unwaived, waived = apply_waivers([f1, f2], waivers)
    assert waived == [f1]
    assert unwaived == [f2]


def test_port_waiver_file_is_its_own_and_empty():
    from repro_torch.analysis import WAIVERS

    assert WAIVERS.parent.name == "analysis" and WAIVERS.name == "waivers.json"
    assert load_waivers(WAIVERS) == []


# ---------------------------------------------------------------------------
# Fixtures: each trips exactly its rule

HIDDEN_SYNC = '''
class BrokenEngine:
    @tick_path(allowed_fetches=1)
    def tick(self):
        out = self._decode(toks=self.toks)
        self.state = out
        return int(out.sum())
'''

DEVICE_BRANCH = '''
class BrokenEngine:
    @tick_path
    def tick(self):
        picks = torch.argmax(self.logits, dim=-1)
        if picks.any():
            self.done = picks.tolist()
'''

RESTAGE = '''
class BrokenEngine:
    @tick_path(allowed_fetches=1)
    def tick(self):
        prompt = torch.tensor(PROMPT, device=self.device)
        picks = host_fetch(self._decode(toks=prompt))
        return picks
'''

TWO_FETCHES = '''
class BrokenEngine:
    @tick_path(allowed_fetches=1)
    def tick(self):
        a = host_fetch(self._decode(toks=1))
        b = host_fetch(self._verify(toks=1))
        return a, b
'''


@pytest.mark.parametrize("source,rule", [(HIDDEN_SYNC, "STR001"), (DEVICE_BRANCH, "STR001"),
                                         (TWO_FETCHES, "STR002"), (RESTAGE, "STR004")],
                         ids=["int", "branch", "fetches", "restage"])
def test_ast_fixture_trips_its_rule(source, rule):
    findings = astlint.lint_source(source, "fixture")
    assert _rules(findings) == {rule}, findings


def _graph(fn, **inputs):
    return StepGraph(Graphs("cpu"), fn, inputs)


@transfer_budget(d2h_arrays=1, d2h_outputs=(0, 1), d2h_bytes_per_slot=4)
def _over_budget():
    return _graph(lambda x: (x * 2.0, x + 1.0, x.sum()), x=((2, 8), torch.float32))


def _scfg(b):
    return types.SimpleNamespace(max_batch=b)


def test_fixture_budget_violation_trips_str002():
    findings, reports = [], []
    synccheck.audit_step(path="fixture:budget", fn=_over_budget(), builder=_over_budget,
                         inputs={"x": "x"}, out_regions=("a", "b", "c"), scfg=_scfg(2),
                         findings=findings, reports=reports)
    assert _rules(findings) == {"STR002"}
    assert reports[0].d2h_arrays > reports[0].budget_arrays
    assert reports[0].d2h_bytes_per_slot > reports[0].budget_bytes_per_slot


@transfer_budget(d2h_arrays=1, d2h_outputs=(0,), d2h_bytes_per_slot=8)
def _one_output():
    return None


@pytest.mark.parametrize("body", [
    lambda x: x * x.sum().item(),
    lambda x: torch.nonzero(x),
    lambda x: x[x > 0],
], ids=["item", "nonzero", "mask"])
def test_fixture_data_dependent_step_trips_str001(body):
    findings, reports = [], []
    reads, writes, out = synccheck.audit_step(
        path="fixture:sync", fn=_graph(body, x=((2, 4), torch.float32)), builder=_one_output,
        inputs={"x": "x"}, out_regions=("a",), scfg=_scfg(2), findings=findings,
        reports=reports)
    assert _rules(findings) == {"STR001"}
    assert out is None and not reads and not writes


def test_plain_callable_trips_str003():
    findings, reports = [], []
    synccheck.audit_step(path="fixture:eager", fn=lambda x: x + 1, builder=_one_output,
                         inputs={"x": "x"}, args={"x": torch.zeros(2)}, out_regions=("a",),
                         scfg=_scfg(1), findings=findings, reports=reports)
    assert _rules(findings) == {"STR003"}


def test_missing_step_reports_no_arrays():
    """A pure mamba pool has no page gather (``_make_gather`` is None): the
    path is reported with no arrays, as the reference's is, and no rule."""
    findings, reports = [], []
    synccheck.audit_step(path="fixture:none", fn=None, builder=_one_output, inputs={},
                         out_regions=("evicted",), scfg=_scfg(2), findings=findings,
                         reports=reports)
    assert findings == []
    assert (reports[0].d2h_arrays, reports[0].d2h_bytes_per_slot) == (0, 0.0)


@transfer_budget(d2h_arrays=1, d2h_outputs=(0,), d2h_bytes_per_slot=4)
def _decode_without_carrier():
    return None


def test_fixture_uncarried_decode_trips_str005():
    """A decode step that never touches its KV: its footprint leaves the
    carrier out, the derived category is INDEPENDENT, the classifier says
    ITERATIVE."""
    kv = torch.zeros(2, 4)
    step = _graph(lambda toks: toks[:, 0] + 1, toks=((2, 1), torch.int32))
    findings, reports = [], []
    reads, writes, _ = synccheck.audit_step(
        path="fixture/x:decode", fn=step, builder=_decode_without_carrier,
        inputs={"toks": "tokens"}, state=[("kv", kv)], out_regions=("emit",),
        scfg=_scfg(2), findings=findings, reports=reports)
    assert "kv" not in reads and "kv" not in writes
    scfg = types.SimpleNamespace(max_batch=2, prefill_chunk=16)
    synccheck._derive_categories(
        "transformer", scfg, tag="fixture/x", decode_width=1,
        decode_carried="kv" in reads and "kv" in writes, prefill_carried=True,
        prefill_reads=frozenset({"kv", "params", "prompt"}), findings=findings,
        reports=reports)
    assert _rules(findings) == {"STR005"}
    assert [f.target for f in findings] == ["fixture/x:decode"]


def _bad_split(**shape):
    good = PA.plan_split(**shape)
    return dataclasses.replace(good, pages_per_split=max(1, good.pages_per_split - 1))


def test_fixture_bad_plan_trips_krn001():
    meta = {**PA.KERNEL_META["paged_attention"], "plan": _bad_split}
    findings = kernelcheck.check_layout("bad_plan", meta)
    assert _rules(findings) == {"KRN001"}
    assert all("page splits" in f.message for f in findings)


def test_fixture_arity_trips_krn001():
    kernel = types.SimpleNamespace(source="paged_attention.cu", symbol="paged_attention",
                                   argtypes=PA.KERNEL.argtypes[:-1])
    assert _rules(kernelcheck.check_arity("bad_arity", kernel)) == {"KRN001"}


def test_fixture_dropped_index_trips_krn002():
    """A launch that hands the kernel a copy of cur_len instead of the
    caller's lengths: the index operand never reaches the launch."""
    def launch_args(q, k_pool, v_pool, page_table, cur_len, out, **kw):
        return PA.launch_args(q, k_pool, v_pool, page_table, cur_len.clone(), out, **kw)

    shape = PA.KERNEL_META["paged_attention"]["lint_shapes"][0]
    findings = kernelcheck.check_launch_args("bad_index", 0, shape, launch_args)
    assert _rules(findings) == {"KRN002"}
    assert all(f.target.endswith(":cur_len") for f in findings)


def test_fixture_unfused_dequant_trips_krn003():
    """Entries that hand back the dequantized f32 instead of the query's
    type break the quant contract."""
    from repro_torch.kernels import ops

    def widen(name):
        return lambda *a, **kw: getattr(ops, name)(*a, **kw).float()

    broken = types.SimpleNamespace(
        paged_attention_quant=widen("paged_attention_quant"),
        paged_attention_multi_quant=widen("paged_attention_multi_quant"))
    findings = kernelcheck.check_quant_contract("cpu", ops=broken)
    assert _rules(findings) == {"KRN003"}
    assert len(findings) == 4  # two entries x int8 / fp8


def test_fixture_oracle_drift_trips_krn004():
    from repro_torch.kernels import ops, ref

    def matmul(x, y, *, transpose_y=False):
        return ops.matmul(x, y)

    drifted = types.SimpleNamespace(**{n: getattr(ops, n) for n, _ in kernelcheck.ORACLE_PAIRS})
    drifted.matmul = matmul
    del drifted.fwt
    findings = kernelcheck.check_oracle_parity(drifted, ref)
    assert _rules(findings) == {"KRN004"}
    assert {f.target for f in findings} == {"matmul", "fwt<->fwt_ref"}


def _small_pool(**kw):
    cfg = C.get_smoke_config("qwen3-4b")
    kw.setdefault("kv_dtype", "fp32")
    return PagedKVCache(cfg, max_batch=2, max_seq=64, block_size=16, num_blocks=9,
                        device="cpu", **kw)


def _leak(kv) -> int:
    """Bump an owned page's refcount with no holder behind it: the page can
    never return to the free list."""
    page = kv._owned[0][0]
    kv.allocator._ref[page] += 1
    return page


def test_fixture_refcount_leak_trips_pool001():
    kv = _small_pool()
    assert kv.alloc(0, 20)
    kv.publish(0)
    assert poolcheck.audit_pool(kv) == []
    _leak(kv)
    assert _rules(poolcheck.audit_pool(kv)) == {"POOL001"}


ROGUE_DIRECT = (
    "class BlockAllocator:\n"
    "    def rogue(self, p):\n"
    "        self._ref[p] += 1\n")

ROGUE_ALIAS = (
    "class PagedKVCache:\n"
    "    def rogue(self, pages):\n"
    "        bs, pools = self.block_size, self.pools\n"
    "        def fn(rows):\n"
    "            for name, c in pools['blocks'].items():\n"
    "                for key, leaf in c.items():\n"
    "                    leaf[:, pages].copy_(rows)\n"
    "        return fn\n"
    "    def reader(self, pages):\n"
    "        g = self.pools['blocks']['l0']['k'][:, pages]\n"
    "        g = g.float()\n"
    "        return g.sum()\n")


@pytest.mark.parametrize("src,target", [(ROGUE_DIRECT, "BlockAllocator.rogue"),
                                        (ROGUE_ALIAS, "PagedKVCache.rogue")],
                         ids=["self", "alias-in-closure"])
def test_mutation_site_audit_flags_unsanctioned(src, target):
    with unittest.mock.patch("inspect.getsource", return_value=src):
        findings = poolcheck.audit_mutation_sites(types.SimpleNamespace())
    assert _rules(findings) == {"POOL004"}
    assert [f.target for f in findings] == [target]


def test_mutation_site_audit_sees_the_ports_closures():
    """``_make_scatter`` writes the pools only through local aliases inside
    its step closure; the scan finds it, so unsanctioning it trips POOL004."""
    from repro_torch.runtime import kv_cache

    spec = poolcheck.PROTECTED["PagedKVCache"]
    narrowed = {**poolcheck.PROTECTED,
                "PagedKVCache": {**spec, "methods": spec["methods"] - {"_make_scatter"}}}
    with unittest.mock.patch.dict(poolcheck.PROTECTED, narrowed):
        findings = poolcheck.audit_mutation_sites(kv_cache)
    assert [(f.rule, f.target) for f in findings] == [("POOL004",
                                                       "PagedKVCache._make_scatter")]


def test_quant_pool_invariants_cover_scales():
    kv = _small_pool(kv_dtype="int8")
    assert kv.alloc(0, 20)
    kv.publish(0)
    kv.check_invariants()
    # Drop a layer's scale leaf: POOL005 must notice the pages lost their
    # scales.
    layer = next(iter(kv.pools["blocks"]))
    victim = next(k for k in kv.pools["blocks"][layer] if k.endswith("_scale"))
    del kv.pools["blocks"][layer][victim]
    with pytest.raises(PoolInvariantError) as ei:
        kv.check_invariants()
    assert ei.value.rule == "POOL005"


def test_quant_pool_mislaid_scale_trips_pool005():
    kv = _small_pool(kv_dtype="fp8")
    c = next(iter(kv.pools["blocks"].values()))
    c["v_scale"] = c["v_scale"][:, :-1]  # one page short: scales off the page axis
    assert _rules(poolcheck.audit_pool(kv)) == {"POOL005"}


# ---------------------------------------------------------------------------
# The real stack is clean, and equal to the reference's audit


@pytest.fixture(scope="module")
def both_audits():
    """The transformer paged + contiguous audits of both packages, with
    each path's footprint."""
    from repro.analysis import synccheck as ref_sync

    out = {}
    for name, mod in (("ref", ref_sync), ("port", synccheck)):
        fps = {}
        orig = mod.audit_step

        def spy(orig=orig, fps=fps, **kw):
            reads, writes, shape = orig(**kw)
            fps[kw["path"]] = (reads, writes)
            return reads, writes, shape

        with unittest.mock.patch.object(mod, "audit_step", spy):
            findings, reports = mod.audit_matrix(archs=["transformer"],
                                                 modes=["paged", "contiguous"])
        out[name] = (findings, [r.to_dict() for r in reports], fps)
    return out


def test_real_engine_paths_clean_and_equal_to_reference(both_audits):
    ref_f, ref_r, _ = both_audits["ref"]
    port_f, port_r, _ = both_audits["port"]
    assert ref_f == [] and port_f == []
    assert [r["path"] for r in port_r] == [r["path"] for r in ref_r]
    assert len(port_r) == 6
    for got, want in zip(port_r, ref_r):
        assert got == want, got["path"]


def test_step_footprints_equal_reference(both_audits):
    _, _, ref_fp = both_audits["ref"]
    _, _, port_fp = both_audits["port"]
    assert set(port_fp) == set(ref_fp)
    for path, (reads, writes) in port_fp.items():
        assert (reads, writes) == ref_fp[path], path
    assert port_fp["transformer/paged:decode"] == (
        {"kv", "page_table", "params", "pos", "tokens"}, {"emit", "kv"})


def test_step_footprint_follows_storage_through_views():
    """A write through a view and an ``index_copy_`` land on their base's
    region; an input no output depends on drops out of the reads."""
    pool = torch.zeros(3, 4)
    state = torch.zeros(2, 4)
    x = torch.ones(4)

    def fn(rows, slot, unused):
        pool[1:2, :] = rows * 2  # a view of the pool
        state.index_copy_(0, slot, rows[None])
        return pool.sum(0) + 1

    args = {"rows": x, "slot": torch.tensor([1]), "unused": torch.ones(2)}
    reads, writes = dep.step_footprint(
        fn, [*args.items(), ("kv", pool), ("state", state)], ("out",), args)
    assert reads == {"rows", "slot", "kv", "state"}
    assert writes == {"out", "kv", "state"}


def test_kernel_lint_clean():
    assert kernelcheck.audit_kernels("cpu") == []


def test_pool_audit_clean():
    assert poolcheck.audit_pools() == []


def test_cli_cpu_clean_over_the_reference_paths(tmp_path, capsys):
    """``python -m repro_torch.analysis --device cpu`` audits the 31 paths
    of the reference's committed report and finds nothing."""
    out = tmp_path / "report.json"
    assert cli.main(["--device", "cpu", "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    bench = json.loads((ROOT / "BENCH_analysis.json").read_text())
    assert [p["path"] for p in report["paths"]] == [p["path"] for p in bench["paths"]]
    assert report["paths_audited"] == 31 and report["findings"] == []
    assert set(report["rules"]) == set(bench["rules"])
    assert "clean: no unwaived findings" in capsys.readouterr().out


def test_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([])


@pytest.mark.parametrize("entry", [
    lambda: cli.run(archs=["transformer"], modes=["paged"]),
    lambda: kernelcheck.audit_kernels(),
    lambda: kernelcheck.check_quant_contract(),
    lambda: synccheck.build_engine("transformer", "paged"),
    lambda: synccheck.live_engine("transformer", "paged"),
], ids=["run", "audit_kernels", "check_quant_contract", "build_engine", "live_engine"])
def test_entry_points_default_to_the_card(entry):
    """Every entry point runs on the card unless the caller asks for the
    CPU: without one, the default raises rather than audit the plain
    versions and report clean."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


@pytest.mark.slow
def test_full_matrix_equal_to_reference():
    from repro.analysis import synccheck as ref_sync

    ref_f, ref_r = ref_sync.audit_matrix()
    port_f, port_r = synccheck.audit_matrix()
    assert ref_f == [] and port_f == []
    assert [r.to_dict() for r in port_r] == [r.to_dict() for r in ref_r]
    audited = {r.path.split(":")[0] for r in port_r}
    assert audited == {f"{a}/{m}" for a, ms in synccheck.ARCH_MODES.items() for m in ms}


# ---------------------------------------------------------------------------
# Allocator invariants + runtime sanitizer


def test_allocator_check_invariants_tracks_holders():
    alloc = BlockAllocator(8)
    a = alloc.alloc(3)
    b = alloc.alloc(2)
    alloc.check_invariants([a, b])
    alloc.incref(a)
    alloc.check_invariants([a, b, a])
    alloc.free(a)
    alloc.check_invariants([a, b])
    with pytest.raises(PoolInvariantError) as ei:
        alloc.check_invariants([b])  # a's pages have no holder
    assert ei.value.rule == "POOL001"


def test_allocator_free_list_corruption_detected():
    alloc = BlockAllocator(8)
    pages = alloc.alloc(2)
    alloc._free.append(pages[0])  # allocated page back on the free list
    with pytest.raises(PoolInvariantError) as ei:
        alloc.check_invariants()
    assert ei.value.rule == "POOL003"


def test_sanitizer_attaches_and_fires(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    kv = _small_pool()
    assert getattr(kv, "sanitized", False)
    assert kv.alloc(0, 20)
    kv.publish(0)
    assert kv.sanitize_checks >= 2  # every mutation audited
    _leak(kv)
    with pytest.raises(PoolInvariantError) as ei:
        kv.alloc(1, 8)  # next mutation runs the suite and catches it
    assert ei.value.rule == "POOL001"


def test_sanitizer_off_by_default(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    kv = _small_pool()
    assert not getattr(kv, "sanitized", False)
    assert kv.sanitize_checks == 0


def test_sanitized_engine_serves_the_same_tokens(monkeypatch):
    """A paged engine in a pool that preempts, with and without the
    sanitizer: the same tokens; the sanitized one ran the suite after its
    pool mutations."""
    def serve():
        eng = synccheck.build_engine("transformer", "paged", device="cpu", max_new_tokens=8,
                                     num_blocks=synccheck.LIVE_BLOCKS)
        for p in synccheck.live_prompts("transformer", "paged", eng.cfg.vocab_size):
            eng.submit(p)
        return eng, eng.run()

    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    plain, want = serve()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    eng, got = serve()
    assert eng.kv.sanitized and eng.preemptions == plain.preemptions >= 1
    assert eng.kv.sanitize_checks > 10 and plain.kv.sanitize_checks == 0
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


# ---------------------------------------------------------------------------
# The live audit's accounting (its sync checks run on a card)


class _Ticker:
    def __init__(self, n):
        self.n = n

    @tick_path(allowed_fetches=1)
    def tick(self):
        return [host_fetch(torch.arange(3)) for _ in range(self.n)]

    @tick_path
    def step(self):
        return self.tick()


def test_live_audit_counts_fetches_against_the_innermost_tick_path():
    ok = _Ticker(1)
    with synccheck.LiveAudit("cpu").watch(ok) as audit:
        ok.step()
        ok.step()
    assert audit.findings == []
    assert audit.calls == {"_Ticker.tick": 2, "_Ticker.step": 2}
    assert audit.max_fetches == {"_Ticker.tick": 1, "_Ticker.step": 0}
    assert "tick" not in vars(ok)  # unwrapped on exit

    greedy = _Ticker(2)
    with synccheck.LiveAudit("cpu").watch(greedy) as audit:
        greedy.step()
    assert _rules(audit.findings) == {"STR002"}
    assert [f.target for f in audit.findings] == ["live:_Ticker.tick"]


def test_live_engine_drives_every_tick_path_method_on_cpu():
    findings, rep = synccheck.live_engine("transformer", "spec", device="cpu")
    assert findings == [] and rep["preemptions"] >= 1 and rep["spec_ticks"] >= 1
    marked = {f"{type(o).__name__}.{n}" for o in (synccheck.build_engine(
                  "transformer", "spec", device="cpu"),)
              for n in dir(type(o)) if hasattr(getattr(type(o), n, None), "__tick_path__")}
    assert marked <= set(rep["calls"])
    for name, n in rep["max_fetches"].items():
        assert n <= rep["allowed_fetches"][name], name
    assert {"PagedKVCache.ensure_write", "PagedKVCache.truncate",
            "PagedKVCache.device_page_table"} <= set(rep["calls"])
