"""The port's measured tuner (``repro_torch.tuning``) against the JAX
package's (``repro.tuning``) on the CPU, f32, weights through the bridge.

Workload descriptors reject what the reference rejects, bucket alike and
synthesize the same prompts bit for bit; the classifier and the task
graphs give the same categories (by ``.value``) over a grid; fingerprints
with a fixed platform are equal; ``TunedPlan`` validates, applies and
sizes the graph caps as the reference's, and a tuning db written by
either package reads in the other; the search's neighbourhoods and pool
conversion are equal, and with the measurements stubbed by one
deterministic function both searches visit the same trials and return the
same plan.  Then a real CPU search (its tuned engine's tokens equal the
untuned port engine's and the JAX engine's), the stage profile, a
``RuntimeError`` inside a trial (it propagates: only configuration
rejections drop a candidate) and the launcher's ``--autotune``, searched
then cached."""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro import tuning as R
from repro.core import dependency as RD
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro.tuning import db as Rdb
from repro.tuning import profiler as Rprof
from repro.tuning import search as Rsearch
from repro.tuning import workload as Rwl
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch import tuning as P
from repro_torch.core import dependency as PD
from repro_torch.models import transformer as PT
from repro_torch.obs import Tracer, stage_times_from_trace
from repro_torch.runtime import serving as PS
from repro_torch.tuning import db as Pdb
from repro_torch.tuning import profiler as Pprof
from repro_torch.tuning import search as Psearch
from repro_torch.tuning import workload as Pwl


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


def _desc(mod, **kw):
    base = dict(prompt_len_mean=64, prompt_len_max=80, max_new_tokens=8, n_requests=4)
    base.update(kw)
    return mod.WorkloadDescriptor(**base)


# -- (a) workload descriptors --------------------------------------------------------

BAD_DESCS = [dict(prompt_len_mean=0), dict(prompt_len_max=0), dict(prompt_len_max=32),
             dict(max_new_tokens=0), dict(n_requests=0), dict(shared_prefix_fraction=1.5),
             dict(shared_prefix_fraction=-0.1), dict(arrival="weird")]


@pytest.mark.parametrize("kw", BAD_DESCS, ids=str)
def test_descriptor_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        _desc(Rwl, **kw)
    with pytest.raises(ValueError) as got:
        _desc(Pwl, **kw)
    assert str(got.value) == str(want.value)


DESC_GRID = [dict(prompt_len_mean=m, prompt_len_max=m + extra, max_new_tokens=new,
                  n_requests=n, shared_prefix_fraction=sh, arrival=arr)
             for m, extra, new, n, sh, arr in itertools.product(
                 (1, 7, 64, 100), (0, 33), (1, 16, 300), (1, 3, 5, 40), (0.0, 0.3, 1.0),
                 ("batch", "open"))]


def test_descriptor_bucket_and_synth_prompts_match_reference():
    """``bucket``, ``shared_prefix_len`` and ``synth_prompts`` (bit for bit,
    over several seeds and vocabularies) over a grid of descriptors, and
    ``from_prompts`` of those prompts."""
    for i, kw in enumerate(DESC_GRID):
        rd, pd = Rwl.WorkloadDescriptor(**kw), Pwl.WorkloadDescriptor(**kw)
        assert pd.bucket() == rd.bucket() and pd.shared_prefix_len == rd.shared_prefix_len
        seed, vocab = i % 5, (50, 1000, 151_936)[i % 3]
        want = Rwl.synth_prompts(rd, vocab_size=vocab, seed=seed)
        got = Pwl.synth_prompts(pd, vocab_size=vocab, seed=seed)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), kw
        for new in (1, 9):
            r = Rwl.WorkloadDescriptor.from_prompts(want, max_new_tokens=new,
                                                    arrival=kw["arrival"])
            p = Pwl.WorkloadDescriptor.from_prompts(got, max_new_tokens=new,
                                                    arrival=kw["arrival"])
            assert dataclasses.asdict(p) == dataclasses.asdict(r)
    shared = np.arange(32, dtype=np.int32)
    prompts = [np.concatenate([shared, np.full(16, 99 + i, np.int32)]) for i in range(3)]
    d = Pwl.WorkloadDescriptor.from_prompts(prompts, max_new_tokens=4)
    assert (d.n_requests, d.prompt_len_mean, d.shared_prefix_len) == (3, 48, 32)
    with pytest.raises(ValueError, match="at least one prompt"):
        Pwl.WorkloadDescriptor.from_prompts([], max_new_tokens=4)


# -- (b) categories --------------------------------------------------------------------

def _graph(w):
    return (w.name, [(t.name, sorted(t.reads), sorted(t.writes)) for t in w.tasks],
            w.kernel_iterations, w.sequential_kernel)


@pytest.mark.parametrize("arch", ("transformer", "mamba", "whisper", "prefix_lm"))
@pytest.mark.parametrize("spec", (False, True), ids=("plain", "spec"))
def test_categories_match_reference(arch, spec):
    """Requests, lengths, chunks, shared fractions on both sides of
    SHARE_DOMINANT, a staged prefix: the same task graph and category."""
    assert Pwl.SHARE_DOMINANT == Rwl.SHARE_DOMINANT
    assert PD.Workload.ITERATIVE_THRESHOLD == RD.Workload.ITERATIVE_THRESHOLD
    seen = set()
    for n, mean, new, chunk, sh, staged in itertools.product(
            (1, 3, 12), (8, 64, 200), (4, 64, 512), (16, 64, 256),
            (0.0, 0.5, 0.89, 0.9, 0.95), (False, True)):
        kw = dict(prompt_len_mean=mean, prompt_len_max=mean, max_new_tokens=new,
                  n_requests=n, shared_prefix_fraction=sh)
        rd, pd = Rwl.WorkloadDescriptor(**kw), Pwl.WorkloadDescriptor(**kw)
        ckw = dict(prefill_chunk=chunk, prefix_staged=staged, spec_decode=spec,
                   spec_k=4 if spec else 0, arch=arch)
        assert _graph(Pwl.to_task_graph(pd, **ckw)) == _graph(Rwl.to_task_graph(rd, **ckw))
        want = Rwl.classify_workload(rd, **ckw)
        got = Pwl.classify_workload(pd, **ckw)
        assert got.value == want.value and got.streamable == want.streamable, (kw, ckw)
        expected, match = Pwl.crosscheck_category(got, pd, **ckw)
        assert expected is got and match
        assert not Pwl.crosscheck_category(
            next(c for c in PD.Category if c is not got), pd, **ckw)[1]
        seen.add(got.value)
    assert len(seen) >= 3, seen
    for bad in (dict(prefill_chunk=0), dict(prefill_chunk=16, arch="rnn")):
        with pytest.raises(ValueError) as want:
            Rwl.to_task_graph(_desc(Rwl), **bad)
        with pytest.raises(ValueError) as got:
            Pwl.to_task_graph(_desc(Pwl), **bad)
        assert str(got.value) == str(want.value)


# -- (c) fingerprints ----------------------------------------------------------------

MODES = {"none": None, "contiguous": dict(max_seq=128), "paged": dict(max_seq=128, paged=True),
         "int8": dict(max_seq=128, paged=True, kv_dtype="int8"),
         "spec": dict(max_seq=128, paged=True, spec_decode=True, spec_k=2),
         "sharing, T 0.7": dict(max_seq=128, paged=True, prefix_sharing=True,
                                temperature=0.7),
         "snapshots": dict(max_seq=128, state_snapshots=True)}


@pytest.mark.parametrize("arch", ("qwen3-4b", "mamba2-2.7b"))
def test_fingerprint_matches_reference(arch):
    rcfg, pcfg = RC.get_smoke_config(arch), PC.get_smoke_config(arch)
    platforms = (("cpu", "cpu"), ("cuda", "NVIDIA H100 80GB HBM3"), ("tpu", "TPU v5 lite"))
    keys = set()
    for (name, mode), (backend, kind), kw in itertools.product(
            MODES.items(), platforms, (dict(), dict(prompt_len_mean=60, n_requests=3),
                                       dict(max_new_tokens=256))):
        if mode is not None and mode.get("state_snapshots") and arch != "mamba2-2.7b":
            continue
        rs = None if mode is None else RS.ServeConfig(**mode)
        ps = None if mode is None else PS.ServeConfig(**mode)
        plat = dict(backend=backend, device_kind=kind)
        want = Rdb.fingerprint(rcfg, _desc(Rwl, **kw), rs, **plat)
        got = Pdb.fingerprint(pcfg, _desc(Pwl, **kw), ps, **plat)
        assert got == want, (name, backend, kw)
        keys.add(got)
    # one bucket for the first two descriptors; every backend and mode apart
    n_modes = sum(1 for m in MODES.values()
                  if not (m and m.get("state_snapshots") and arch != "mamba2-2.7b"))
    assert len(keys) == n_modes * len(platforms) * 2
    d = _desc(Pwl)
    assert (Pdb.fingerprint(pcfg, d, device="cpu")
            == Pdb.fingerprint(pcfg, d, backend="cpu", device_kind="cpu")
            == Rdb.fingerprint(rcfg, _desc(Rwl), backend="cpu", device_kind="cpu"))


# -- (d) TunedPlan and the db ----------------------------------------------------------

def _plan(mod, fp="abc123", **kw):
    base = dict(
        fingerprint=fp, prefill_chunk=32, decode_interleave=2, block_size=16,
        num_blocks=None, max_batch=4, paged=True, paged_kernel=True, prefix_min_pages=1,
        tokens_per_s=120.0, admit_ms=3.5, baseline_tokens_per_s=100.0,
        baseline_admit_ms=5.0, stage_times=(0.004, 0.002, 0.0001), decision="stream",
        category="independent", max_seq=128, trials=6)
    base.update(kw)
    return mod.TunedPlan(**base)


BAD_PLANS = [dict(prefill_chunk=0), dict(decode_interleave=0), dict(block_size=24),
             dict(spec_k=0), dict(max_seq=0), dict(max_batch=0), dict(prefix_min_pages=0),
             dict(kv_dtype="int4"), dict(kv_dtype="int8", paged=False)]


@pytest.mark.parametrize("kw", BAD_PLANS, ids=str)
def test_plan_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        _plan(Rdb, **kw)
    with pytest.raises(ValueError) as got:
        _plan(Pdb, **kw)
    assert str(got.value) == str(want.value)


APPLY_CASES = [
    (dict(), dict(max_seq=128, prefill_chunk=16, max_new_tokens=4, max_batch=2, paged=True,
                  block_size=32)),
    (dict(), dict(max_seq=40, prefill_chunk=16, max_new_tokens=4, paged=True, block_size=8)),
    (dict(num_blocks=8), dict(max_seq=256, paged=True, block_size=32, num_blocks=20)),
    (dict(kv_dtype="int8", num_blocks=12), dict(max_seq=128, paged=True)),
    (dict(spec_decode=True, spec_k=2), dict(max_seq=128, paged=True, spec_decode=True)),
    (dict(paged=False, paged_kernel=False, block_size=16), dict(max_seq=96)),
    (dict(prefix_min_pages=2), dict(max_seq=128, paged=True, prefix_sharing=True)),
]


@pytest.mark.parametrize("plan_kw,base_kw", APPLY_CASES, ids=str)
def test_apply_matches_reference(plan_kw, base_kw):
    """``apply`` gives the reference's ``ServeConfig`` field for field (the
    fields both have: the port's has no ``paged_kernel``), the same caps."""
    rplan, pplan = _plan(Rdb, **plan_kw), _plan(Pdb, **plan_kw)
    assert pplan.jit_cache_caps() == rplan.jit_cache_caps()
    assert pplan.measured_stage_times == pplan.measured_stage_times.__class__(
        0.004, 0.002, 0.0001)
    want = dataclasses.asdict(rplan.apply(RS.ServeConfig(**base_kw)))
    got = dataclasses.asdict(pplan.apply(PS.ServeConfig(**base_kw)))
    assert set(got) == set(want) - {"paged_kernel"}
    assert got == {k: v for k, v in want.items() if k != "paged_kernel"}
    PS.ServeConfig(**got)  # still a valid config


def test_db_files_read_in_both_packages(tmp_path):
    """Plans stored by one package read back equal in the other."""
    plans = [dict(), dict(fp="q8", kv_dtype="int8", num_blocks=12),
             dict(fp="sp", spec_decode=True, spec_k=2), dict(fp="np", paged=False,
                                                           paged_kernel=False)]
    for writer, reader in ((Rdb, Pdb), (Pdb, Rdb)):
        path = tmp_path / f"{writer.__name__}.json"
        db = writer.TuningDB(path)
        for kw in plans:
            db.put(_plan(writer, **kw))
        back = reader.TuningDB(path)
        assert len(back) == len(plans)
        for kw in plans:
            got = back.get(kw.get("fp", "abc123"))
            assert got.to_json() == _plan(writer, **kw).to_json()
    assert json.loads((tmp_path / "repro.tuning.db.json").read_text()) == json.loads(
        (tmp_path / "repro_torch.tuning.db.json").read_text())


def _schema_script(mod, path):
    mod.TuningDB(path).put(_plan(mod))
    raw = json.loads(path.read_text())
    out = []
    raw["schema"] = mod.SCHEMA_VERSION + 1
    path.write_text(json.dumps(raw))
    out.append(mod.TuningDB(path).get("abc123"))
    raw["schema"] = mod.SCHEMA_VERSION
    raw["entries"][0]["schema"] = mod.SCHEMA_VERSION + 1
    path.write_text(json.dumps(raw))
    out.append(mod.TuningDB(path).get("abc123"))
    raw["schema"] = raw["entries"][0]["schema"] = mod.SCHEMA_VERSION - 1
    raw["entries"][0].pop("kv_dtype")
    path.write_text(json.dumps(raw))
    out.append(mod.TuningDB(path).get("abc123"))
    raw["schema"] = raw["entries"][0]["schema"] = mod.SCHEMA_VERSION
    raw["entries"][0]["block_size"] = 24  # a record that no longer validates
    path.write_text(json.dumps(raw))
    out.append(len(mod.TuningDB(path)))
    return out


def _corrupt_script(mod, path):
    path.write_text("{not json")
    db = mod.TuningDB(path)
    out = [len(db)]
    db.put(_plan(mod))  # the store recovers by overwriting
    out.append(mod.TuningDB(path).get("abc123") is not None)
    return out


def _lru_script(mod, path):
    db = mod.TuningDB(path, max_entries=3)
    for i in range(4):
        db.put(_plan(mod, fp=f"fp{i}"), save=False)
    out = [len(db), db.get("fp0") is None]
    db.get("fp1")  # bump fp1 so fp2 is now the LRU entry
    db.put(_plan(mod, fp="fp4"))
    out += [db.get("fp2") is None, db.get("fp1") is not None,
            list(mod.TuningDB(path, max_entries=3)._entries)]
    return out


@pytest.mark.parametrize("script", (_schema_script, _corrupt_script, _lru_script),
                         ids=lambda f: f.__name__)
def test_db_behaves_as_reference(script, tmp_path):
    """Schema mismatch (file, entry, v3), a corrupt file, the LRU bound."""
    assert Pdb.SCHEMA_VERSION == Rdb.SCHEMA_VERSION == 4
    want = script(Rdb, tmp_path / "r.json")
    got = script(Pdb, tmp_path / "p.json")
    assert got == want
    assert not any(x not in (None, False, True, 0) and not isinstance(x, (int, list))
                   for x in got)


def test_default_db_path(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TUNING_DB", str(tmp_path / "x.json"))
    assert Pdb.default_db_path() == Rdb.default_db_path() == tmp_path / "x.json"
    monkeypatch.delenv("REPRO_TUNING_DB")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert Pdb.default_db_path() == tmp_path / "repro_torch" / "tuning.json"
    assert Pdb.default_db_path() != Rdb.default_db_path()


# -- (e) the search's neighbourhoods -----------------------------------------------------

SCFGS = [dict(max_seq=128), dict(max_seq=128, paged=True), dict(max_seq=96, paged=True,
                                                               block_size=8, num_blocks=40),
         dict(max_seq=128, paged=True, num_blocks=20, kv_dtype="int8"),
         dict(max_seq=128, paged=True, num_blocks=30, kv_dtype="fp8", spec_decode=True),
         dict(max_seq=256, paged=True, prefix_sharing=True, prefix_min_pages=3),
         dict(max_seq=64, spec_decode=True, spec_k=8)]


@pytest.mark.parametrize("skw", SCFGS, ids=str)
def test_candidates_match_reference(skw, qwen):
    rcfg, pcfg, _, _ = qwen
    assert Psearch._DIMS == Rsearch._DIMS
    assert (Psearch._QUANT_PARITY_MIN, Psearch._MIN_CHUNK, Psearch._MAX_SPEC_K) == (
        Rsearch._QUANT_PARITY_MIN, Rsearch._MIN_CHUNK, Rsearch._MAX_SPEC_K) == (0.5, 16, 16)
    rs = RS.ServeConfig(**skw, paged_kernel=bool(skw.get("paged")))
    ps = PS.ServeConfig(**skw)
    n = 0
    for dkw, chunk, inter, block, nb, batch, spec_k, kvd, mp, streamable in itertools.product(
            (dict(), dict(prompt_len_mean=20, prompt_len_max=30, max_new_tokens=3,
                          n_requests=1), dict(prompt_len_mean=8, prompt_len_max=200,
                                              max_new_tokens=40, n_requests=16)),
            (16, 48), (1, 3), (8, 16, 32), (None, 7, 40), (1, 4), (1, 4), ("fp32", "int8"),
            (1, 2), (True, False)):
        asg = dict(prefill_chunk=chunk, decode_interleave=inter, block_size=block,
                   num_blocks=nb, max_batch=batch, paged_kernel=bool(skw.get("paged")),
                   prefix_min_pages=mp, spec_k=spec_k, kv_dtype=kvd)
        rd, pd = _desc(Rwl, **dkw), _desc(Pwl, **dkw)
        for dim in Psearch._DIMS:
            for backend in ("cpu", "gpu"):
                want = Rsearch._candidates(dim, asg, rs, rd, streamable=streamable,
                                           backend=backend)
                got = Psearch._candidates(dim, asg, ps, pd, streamable=streamable)
                assert got == want, (dim, asg, dkw, backend)
        assert (Psearch._resolved_num_blocks(pcfg, ps, asg)
                == Rsearch._resolved_num_blocks(rcfg, rs, asg)), asg
        n += 1
    assert n > 1000


# -- (f) the search's logic under one stub -------------------------------------------------

def _stub_search(mod, prof, search, monkeypatch, cfg, scfg, desc, *, parity_break,
                 low_agree, rejected, device_kw):
    """Run ``mod``'s search with the engine, the profile and the measurement
    stubbed: tok/s and outputs a deterministic function of the candidate's
    ``ServeConfig``.  Returns (plan, the visited configs in order, log)."""
    visited = []

    class Fake:
        paged = False

        def __init__(self, cfg, params, scfg, **kw):
            if rejected(scfg):
                raise NotImplementedError(f"stub rejects {scfg.kv_dtype}")
            self.scfg = scfg

    def measure(make_engine, desc, *, vocab_size, seed, timed_runs):
        sc = make_engine().scfg
        row = (sc.prefill_chunk, sc.decode_interleave, sc.block_size, sc.num_blocks,
               sc.max_batch, sc.prefix_min_pages, sc.spec_k, sc.kv_dtype)
        visited.append(row)
        tps = (100.0 + 40.0 * (sc.prefill_chunk in (32, 64)) + 7.0 * sc.decode_interleave
               + 3.0 * sc.max_batch - 0.01 * (sc.num_blocks or 0) + 2.0 * sc.spec_k
               + 5.0 * (sc.block_size == 8) + 60.0 * (sc.kv_dtype == "int8"))
        outs = {i: np.arange(desc.max_new_tokens, dtype=np.int32) + i
                for i in range(desc.n_requests)}
        if parity_break(sc):
            outs[0] = outs[0] + 1
            tps += 500.0
        if low_agree(sc):
            for i in outs:
                outs[i] = np.where(np.arange(desc.max_new_tokens) % 4 == 0, outs[i], -1)
            tps += 400.0
        return prof.WorkloadMeasurement(tokens_per_s=tps, admit_ms=1.0 + sc.prefill_chunk
                                        / 64, wall_s=1.0, decode_steps=3, preemptions=0,
                                        outputs=outs)
    monkeypatch.setattr(search, "StreamedBatchEngine", Fake)
    monkeypatch.setattr(prof, "profile_engine", lambda eng, n, repeats: prof.StageProfile(
        chunk_s=0.004, decode_s=0.002, h2d_s=1e-5, d2h_s=1e-5))
    monkeypatch.setattr(prof, "measure_workload", measure)
    log = []
    plan = mod.search_tuned_plan(cfg, None, scfg, desc, budget=mod.SearchBudget(
        max_trials=12, sweeps=2), log=log.append, **device_kw)
    return plan, visited, log


STUB_CASES = {
    "paged, sharing": (dict(max_seq=128, prefill_chunk=16, max_new_tokens=8, paged=True,
                            prefix_sharing=True, num_blocks=40),
                       dict(shared_prefix_fraction=0.5)),
    "paged, spec, open": (dict(max_seq=128, prefill_chunk=16, max_new_tokens=8, paged=True,
                               spec_decode=True), dict(arrival="open")),
    "contiguous, decode-dominated": (dict(max_seq=256, prefill_chunk=16, max_new_tokens=100),
                                     dict(prompt_len_mean=24, prompt_len_max=24,
                                          max_new_tokens=100)),
}


@pytest.mark.parametrize("case", sorted(STUB_CASES))
def test_search_trajectory_matches_reference(case, monkeypatch):
    """A candidate whose outputs break parity (decode_interleave 2) and an
    int8 candidate at 0.25 agreement are scored -inf in both; an fp8
    candidate is rejected at construction in both.  The same trials in the
    same order, the same log, the same plan."""
    skw, dkw = STUB_CASES[case]
    rules = dict(parity_break=lambda sc: sc.decode_interleave == 2,
                 low_agree=lambda sc: sc.kv_dtype == "int8",
                 rejected=lambda sc: sc.kv_dtype == "fp8")
    want, rvis, rlog = _stub_search(R, Rprof, Rsearch, monkeypatch, RC.get_smoke_config(
        "qwen3-4b"), RS.ServeConfig(
        **skw, paged_kernel=bool(skw.get("paged"))), _desc(Rwl, **dkw), **rules,
        device_kw={})
    got, pvis, plog = _stub_search(P, Pprof, Psearch, monkeypatch, PC.get_smoke_config(
        "qwen3-4b"), PS.ServeConfig(**skw),
                                   _desc(Pwl, **dkw), **rules, device_kw=dict(device="cpu"))
    assert pvis == rvis and len(pvis) > 2
    assert plog == rlog
    assert any("rejected" in line for line in plog) == bool(skw.get("paged"))
    # every field, the fingerprint too: JAX's CPU platform is ("cpu", "cpu")
    assert got.to_json() == want.to_json()
    assert got.tokens_per_s >= got.baseline_tokens_per_s


# -- (g) a real search on the CPU ---------------------------------------------------------

def test_real_search_keeps_tokens_and_caps(qwen):
    """``SearchBudget(max_trials=3, sweeps=1, timed_runs=1)`` on a paged
    engine: the plan is at least its baseline, its engine's greedy tokens
    equal the untuned port engine's and the JAX engine's, and the caps
    reach the graph caches."""
    rcfg, pcfg, tree, params = qwen
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=6, max_batch=2, paged=True,
              block_size=16)
    desc = _desc(Pwl, prompt_len_mean=32, prompt_len_max=48, max_new_tokens=6, n_requests=3)
    scfg = PS.ServeConfig(**kw)
    plan = P.search_tuned_plan(pcfg, params, scfg, desc, device="cpu",
                               budget=P.SearchBudget(max_trials=3, sweeps=1, timed_runs=1))
    assert plan.tokens_per_s >= plan.baseline_tokens_per_s and 1 <= plan.trials <= 3
    assert plan.schema == Pdb.SCHEMA_VERSION and plan.paged_kernel
    assert scfg.arch_kind is None  # the base config was never handed to an engine
    assert plan.fingerprint == P.fingerprint(pcfg, desc, scfg, device="cpu")

    prompts = Pwl.synth_prompts(desc, vocab_size=pcfg.vocab_size)

    def serve(eng):
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        out = eng.run()
        return [out[u] for u in uids]
    untuned = serve(PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu"))
    tuned_eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), plan=plan,
                                       device="cpu")
    tuned = serve(tuned_eng)
    ref = serve(RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree),
                                       RS.ServeConfig(**kw)))
    for a, b, c in zip(tuned, untuned, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    sc = tuned_eng.scfg
    assert (sc.chunk_jit_cap, sc.page_jit_cap) == plan.jit_cache_caps(
        max_seq=96, block_size=sc.block_size)
    assert tuned_eng.servable.single._chunk_jit_cap == sc.chunk_jit_cap
    assert tuned_eng.kv._jit_cap == sc.page_jit_cap


# -- (h) the stage profile ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("paged", "contiguous", "paged, traced"))
def test_profile_engine(mode, qwen):
    _, pcfg, _, params = qwen
    paged = mode.startswith("paged")
    eng = PS.StreamedBatchEngine(
        pcfg, params, PS.ServeConfig(max_seq=64, prefill_chunk=16, max_new_tokens=4,
                                     max_batch=2, paged=paged, block_size=16),
        device="cpu", tracer=Tracer() if "traced" in mode else None)
    if "traced" in mode:  # traffic for the trace
        for p in Pwl.synth_prompts(_desc(Pwl, prompt_len_mean=40, prompt_len_max=40,
                                         n_requests=3), vocab_size=pcfg.vocab_size):
            eng.submit(p)
        eng.run()
    prof = P.profile_engine(eng, 32, repeats=1)
    assert prof.chunk_s > 0 and prof.decode_s > 0
    assert prof.h2d_s > 0 and prof.d2h_s >= 0
    assert (prof.scatter_s > 0 and prof.gather_s > 0) == paged
    st = prof.stage_times()
    assert st.h2d >= prof.chunk_s and st.kex == prof.decode_s and st.d2h == prof.d2h_s
    if "traced" in mode:
        tr = stage_times_from_trace(eng.obs.spans())
        assert (prof.chunk_s, prof.decode_s) == (tr.h2d, tr.kex)
    if paged:
        assert eng.kv.pages_in_use == 0 and all(s.free for s in eng.slots)
        eng.kv.check_invariants()


# -- (i) a failed trial propagates ---------------------------------------------------------

@pytest.mark.parametrize("where", ("tick", "construction"))
def test_runtime_error_in_a_trial_propagates(where, qwen, monkeypatch):
    """A ``RuntimeError`` (a kernel build or launch, a CUDA error) inside a
    candidate's trial ends the search; the reference would drop the
    candidate and search on."""
    _, pcfg, _, params = qwen
    scfg = PS.ServeConfig(max_seq=64, prefill_chunk=16, max_new_tokens=3, max_batch=2,
                          paged=True, block_size=16)
    desc = _desc(Pwl, prompt_len_mean=24, prompt_len_max=24, max_new_tokens=3, n_requests=2)
    msg = "CUDA error: an illegal memory access was encountered"
    built = []

    class Engine(PS.StreamedBatchEngine):
        def __init__(self, cfg, params, scfg, **kw):
            built.append(scfg.prefill_chunk)
            if where == "construction" and len(built) > 2:
                raise RuntimeError(msg)
            super().__init__(cfg, params, scfg, **kw)

        def _plain_tick(self):
            if where == "tick" and len(built) > 2:
                raise RuntimeError(msg)
            super()._plain_tick()
    monkeypatch.setattr(Psearch, "StreamedBatchEngine", Engine)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        P.search_tuned_plan(pcfg, params, scfg, desc, device="cpu",
                            budget=P.SearchBudget(max_trials=4, sweeps=1, timed_runs=1))
    assert len(built) == 3  # the probe, the untuned base, then the failing trial


def test_configuration_rejections_drop_the_candidate(qwen, monkeypatch):
    """What configuration rejects is dropped and the search goes on: a
    candidate pool too small for the longest request alone (fp32 pages in
    the byte budget of an int8 pool: the reference's ``submit`` rejects it)
    and an arch's ``NotImplementedError`` (mamba rejects quantized pages)."""
    _, pcfg, _, params = qwen
    built = []

    def measure(make_engine, desc, *, vocab_size, seed, timed_runs):
        eng = make_engine()
        built.append(eng.scfg.kv_dtype)
        return Pprof.WorkloadMeasurement(
            tokens_per_s=100.0, admit_ms=1.0, wall_s=1.0, decode_steps=1, preemptions=0,
            outputs={i: np.zeros(4, np.int32) for i in range(desc.n_requests)})
    monkeypatch.setattr(Pprof, "measure_workload", measure)
    monkeypatch.setattr(Pprof, "profile_engine", lambda eng, n, repeats: Pprof.StageProfile(
        chunk_s=0.004, decode_s=0.002))
    desc = _desc(Pwl, prompt_len_mean=40, prompt_len_max=48, max_new_tokens=8, n_requests=2)
    log = []
    scfg = PS.ServeConfig(max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=2,
                          paged=True, block_size=16, num_blocks=8, kv_dtype="int8")
    plan = P.search_tuned_plan(pcfg, params, scfg, desc, device="cpu", log=log.append,
                               budget=P.SearchBudget(max_trials=12, sweeps=1))
    assert any("request needs 4 pages but the pool has 1" in ln for ln in log), log
    assert "fp32" not in built and plan.kv_dtype != "fp32"
    mcfg = PC.get_smoke_config("mamba2-2.7b")
    built.clear()
    log.clear()
    P.search_tuned_plan(mcfg, PT.init_params(mcfg, 0, device="cpu"), dataclasses.replace(
        scfg, kv_dtype="fp32", num_blocks=None), desc, device="cpu", log=log.append,
        budget=P.SearchBudget(max_trials=12, sweeps=1))
    assert sum("rejected" in ln and "quantized KV pages" in ln for ln in log) == 2, log
    assert set(built) == {"fp32"}


# -- (j) the launcher ----------------------------------------------------------------------

def test_launcher_autotune_searched_then_cached(tmp_path, capsys):
    from repro_torch.launch import serve
    db_path = tmp_path / "tuning.json"
    argv = ["--arch", "qwen3-4b", "--requests", "2", "--prompt-len", "24", "--new-tokens",
            "4", "--prefill-chunk", "8", "--max-batch", "2", "--paged", "--autotune",
            "--tune-budget", "3", "--tuning-db", str(db_path), "--device", "cpu"]
    serve.main(argv)
    first = capsys.readouterr().out
    assert "[serve] autotune (searched, " in first and "[tune] best" in first
    serve.main(argv)
    second = capsys.readouterr().out
    assert "[serve] autotune (cached, " in second and "[tune]" not in second
    assert len(Pdb.TuningDB(db_path)) == 1 and len(Rdb.TuningDB(db_path)) == 1
    rows = [[ln for ln in out.splitlines() if ln.startswith("[serve] req")]
            for out in (first, second)]
    assert rows[0] == rows[1] and len(rows[0]) == 2
    serve.main(argv + ["--retune"])
    assert "autotune (searched, " in capsys.readouterr().out
    assert len(Pdb.TuningDB(db_path)) == 1


# -- the warmup on a capturing engine ----------------------------------------------------

def _copy_tree(dst, src):
    if dst is None:
        return
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:
        dst.copy_(src)


class _RerunCapture:
    """A capture backend for the CPU whose replay runs the step again into
    the captured outputs: a graphed engine's schedule (first use eager,
    second captures, later replays) with the eager engine's values."""

    def __call__(self, fn):
        out = fn()

        class Graph:
            @staticmethod
            def replay():
                with torch.inference_mode():
                    _copy_tree(out, fn())
        return Graph(), out


@pytest.mark.parametrize("sharing", (False, True), ids=("plain", "sharing"))
def test_measure_workload_times_replays_only(sharing, qwen):
    """On a capturing engine the warmup repeats until a run meets no step
    for the first time: the timed runs capture nothing and run no step
    eagerly, and their tokens are the eager engine's."""
    _, pcfg, _, params = qwen
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=4, max_batch=2, paged=True,
              block_size=8, prefix_sharing=sharing)
    desc = _desc(Pwl, prompt_len_mean=24, prompt_len_max=40, max_new_tokens=4, n_requests=3,
                 shared_prefix_fraction=0.7 if sharing else 0.0)
    engines, counts = [], []

    def make_engine():
        eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
        eng.graphs.capture = _RerunCapture()
        run = eng.run

        def counted_run():
            before = (eng.graphs.first_runs, eng.graphs.captured)
            out = run()
            counts.append((eng.graphs.first_runs - before[0], eng.graphs.captured - before[1]))
            return out
        eng.run = counted_run
        engines.append(eng)
        return eng
    m = P.measure_workload(make_engine, desc, vocab_size=pcfg.vocab_size, timed_runs=2)
    warm, timed = counts[:-2], counts[-2:]
    assert len(warm) >= 2 and warm[-1][0] == 0 and warm[0][0] > 0
    assert timed == [(0, 0), (0, 0)]
    assert engines[0].graphs.replays > 0
    eager = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    prompts = Pwl.synth_prompts(desc, vocab_size=pcfg.vocab_size)
    for _ in range(2):  # the measured runs follow a warm one (a shared head registered)
        uids = [eager.submit(p, max_new_tokens=4) for p in prompts]
        out = eager.run()
    for i, u in enumerate(uids):
        np.testing.assert_array_equal(m.outputs[i], out[u])
