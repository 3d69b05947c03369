"""Pass 1: sync / transfer audit of every engine hot path (the reference
``analysis/synccheck.py``), static on the CPU and live on the card.

**Static** (CPU).  For each servable arch x serving mode the audit builds
a real tiny engine and runs each hot path's step over its static inputs:

* **STR001** — the step raises under ``FakeTensorMode`` with a
  data-dependent output (``.item()``, ``.tolist()``, ``nonzero``, boolean
  indexing): the port's analogue of a JAX concretization error, and a step
  that could not be captured in a CUDA graph.  The Python glue between
  steps is linted separately (``astlint``).
* **STR002** — the outputs the host fetches per tick (declared with
  ``@transfer_budget(d2h_outputs=...)`` on the step's builder) exceed the
  declared array count or per-slot byte budget.
* **STR003** — a tick-path step is not a ``StepGraph`` (so it is not
  captured in a CUDA graph; every tick re-dispatches it from Python).
* **STR005** — the dependency category derived from the step's footprint
  (``core.dependency.step_footprint``, then ``unroll_stream``) disagrees
  with ``tuning.workload.classify_workload`` for the same regime.

Hot paths per engine: the batched decode tick, the speculative verify
step, the prefill-chunk step (fused and legacy), and the page scatter /
gather.  The audited modes are the ones ``validate_arch`` accepts.

**Live** (card, :class:`LiveAudit`).  A small engine per (arch, mode)
serves a few requests (in a pool small enough to preempt, when paged)
with every ``@tick_path`` method wrapped: the outermost marked call runs
under ``torch.cuda.set_sync_debug_mode("error")``, so any synchronizing
CUDA call inside it (a blocking copy, ``.item()``, a stream wait) raises
and is reported as STR001 (and re-raised: never swallowed).
``host_fetch`` lowers the mode around its one copy and counts it against
the innermost marked call's ``allowed_fetches`` (STR002 when exceeded);
a CUDA graph capture is sanctioned (``budget.sanctioned_sync``: the
capture's one device synchronization is let through and counted), so
the audit covers cold ticks and warm replays alike.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import traceback
from typing import Any, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

import repro_torch.configs as C
from repro_torch.analysis import Finding, budget
from repro_torch.analysis.budget import TICK_ATTR, TransferBudget, budget_of
from repro_torch.core import dependency as dep
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime.graphs import StepGraph
from repro_torch.tuning import workload as W

#: One smoke config per served arch kind (the zoo's taxonomy).
ARCH_SMOKE = {
    "transformer": "qwen3-4b",
    "mamba": "mamba2-2.7b",
    "whisper": "whisper-medium",
}

#: Serving modes per arch; quant/fused/spec are transformer-only
#: (``ServeConfig.validate_arch`` rejects them elsewhere).
ARCH_MODES = {
    "transformer": ("contiguous", "paged", "paged_legacy", "quant", "spec"),
    "mamba": ("contiguous", "paged"),
    "whisper": ("contiguous", "paged"),
}

# Audit geometry: tiny but multi-chunk / multi-page.
_MAX_SEQ = 64
_CHUNK = 16
_MAX_BATCH = 2
_SPEC_K = 3

# The live audit's serve: prompts of several chunks, in a paged pool of
# LIVE_BLOCKS blocks (trash included), which preempts at these lengths.
LIVE_PROMPTS = (30, 29, 33)
LIVE_NEW = 8
LIVE_BLOCKS = 6


@dataclasses.dataclass
class PathReport:
    """Measured vs declared D2H for one audited path (BENCH_analysis)."""

    path: str
    d2h_arrays: int
    budget_arrays: int
    d2h_bytes_per_slot: float
    budget_bytes_per_slot: int | None
    category: str | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# -- one step ----------------------------------------------------------------


def _fake_run(call, kwargs):
    """The step's outputs under ``FakeTensorMode`` (shapes and types only;
    nothing real is written), or the data-dependent error it raised."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException, FakeTensorMode)

    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            return call(**kwargs), None
    except (DataDependentOutputException, DynamicOutputShapeException) as e:
        return None, e


def audit_step(
    *,
    path: str,
    fn,
    builder,
    inputs: dict[str, str],
    out_regions: Sequence[str],
    scfg,
    findings: list[Finding],
    reports: list[PathReport],
    state: Sequence[tuple[str, Any]] = (),
    args: dict[str, Any] | None = None,
    unpack=None,
) -> tuple[frozenset[str], frozenset[str], Any]:
    """Audit one step; returns (reads, writes, outputs) — empty sets and
    None when it hit a host sync or there is no step.

    ``fn`` is a :class:`StepGraph`, run over its own static input tensors;
    None (a step with nothing to run: a pure mamba pool's page gather),
    reported with no arrays; or any other callable (STR003), called with
    ``args``.  ``inputs`` names each argument's region, ``state`` labels
    the engine state the step closes over (params, pools, caches), and
    ``out_regions`` names the regions the returned values hold.  ``unpack``
    splits the step's output into the values its builder's budget
    declares, where the step returns them as one array (the engine's
    verify graph)."""
    budget_ = budget_of(builder) or TransferBudget()
    limit = budget_.bytes_limit(scfg)
    if fn is None:
        reports.append(PathReport(path=path, d2h_arrays=0, budget_arrays=budget_.d2h_arrays,
                                  d2h_bytes_per_slot=0.0, budget_bytes_per_slot=limit))
        return frozenset(), frozenset(), None
    if isinstance(fn, StepGraph):
        call, kwargs = fn.fn, fn.inputs
    else:
        findings.append(Finding(
            "STR003", path,
            f"tick-path step {getattr(fn, '__name__', fn)!r} is not a StepGraph (not "
            "captured in a CUDA graph: every tick re-dispatches it from Python)", "sync"))
        call, kwargs = fn, dict(args or {})
    out, err = _fake_run(call, kwargs)
    if err is not None:
        findings.append(Finding(
            "STR001", path,
            f"the step hit a host sync: {type(err).__name__}: {str(err).splitlines()[0]}",
            "sync"))
        return frozenset(), frozenset(), None

    outs = unpack(out) if unpack is not None else out if isinstance(out, tuple) else (out,)
    fetched = [leaf for i in budget_.d2h_outputs for leaf in tree_leaves(outs[i])
               if isinstance(leaf, torch.Tensor)]
    n_arrays = len(fetched)
    n_bytes = sum(leaf.numel() * leaf.element_size() for leaf in fetched)
    per_slot = n_bytes / max(1, scfg.max_batch)
    reports.append(PathReport(
        path=path, d2h_arrays=n_arrays, budget_arrays=budget_.d2h_arrays,
        d2h_bytes_per_slot=per_slot, budget_bytes_per_slot=limit))
    if n_arrays > budget_.d2h_arrays:
        findings.append(Finding(
            "STR002", path,
            f"{n_arrays} fetched output arrays > declared d2h_arrays={budget_.d2h_arrays}",
            "sync"))
    if limit is not None and per_slot > limit:
        findings.append(Finding(
            "STR002", path,
            f"{per_slot:.0f} fetched bytes/slot > declared d2h_bytes_per_slot={limit}",
            "sync"))

    labels = [(inputs[name], value) for name, value in kwargs.items()] + list(state)
    reads, writes = dep.step_footprint(call, labels, out_regions, kwargs)
    return reads, writes, outs


# -- engine construction -----------------------------------------------------


def build_engine(arch: str, mode: str, *, device=None, params: dict | None = None, **over):
    """A tiny real engine for (arch, mode) at the reference's audit
    geometry, with seeded random weights (or ``params``), on ``device``
    (the card unless the caller asks for the CPU); ``over`` adds
    ServeConfig fields."""
    from repro_torch.runtime.serving import ServeConfig, StreamedBatchEngine

    device = resolve_device(device)
    cfg = C.get_smoke_config(ARCH_SMOKE[arch])
    if params is None:
        params = T.init_params(cfg, 0, device=device)
    kw: dict[str, Any] = dict(
        max_seq=_MAX_SEQ, prefill_chunk=_CHUNK, max_new_tokens=8,
        max_batch=_MAX_BATCH, paged=mode != "contiguous", block_size=16)
    if mode == "paged_legacy":
        kw["fused_prefill"] = False
    elif mode == "quant":
        kw["kv_dtype"] = "int8"
    elif mode == "spec":
        kw.update(spec_decode=True, spec_k=_SPEC_K)
    kw.update(over)
    return StreamedBatchEngine(cfg, params, ServeConfig(**kw), device=device)


def _carrier(arch: str) -> str:
    return "state" if arch == "mamba" else "kv"


#: Region of each static input of the engine's step graphs.
_TICK_INPUTS = {"toks": "tokens", "cur": "pos", "page_table": "page_table",
                "uids": "uids", "steps": "steps"}


def audit_engine(eng, arch: str, mode: str) -> tuple[list[Finding], list[PathReport]]:
    """Audit every hot path of one built engine."""
    findings: list[Finding] = []
    reports: list[PathReport] = []
    scfg = eng.scfg
    car = _carrier(arch)
    tag = f"{arch}/{mode}"
    servable = eng.servable
    single = servable.single
    weights = [("params", eng.params), ("params", servable.unembed)]
    slot_state = eng.kv.pools if eng.paged else eng.caches

    # decode tick --------------------------------------------------------
    d_reads, d_writes, _ = audit_step(
        path=f"{tag}:decode", fn=eng._decode, builder=type(servable).decode_fn,
        inputs=_TICK_INPUTS, state=weights + [(car, slot_state)], out_regions=("emit",),
        scfg=scfg, findings=findings, reports=reports)
    decode_carried = car in d_reads and car in d_writes
    decode_width = 1

    # speculative verify: the engine's graph fetches (B, t + 1) ``emit``
    # and its ``n_accept`` column as one array; split back into the two
    # outputs ``verify_fn``'s budget declares --------------------------------
    if scfg.spec_decode:
        s_reads, s_writes, s_out = audit_step(
            path=f"{tag}:spec_verify", fn=eng._verify, builder=type(servable).verify_fn,
            inputs={**_TICK_INPUTS, "toks": "draft", "d_len": "draft_len"},
            state=weights + [(car, slot_state)], out_regions=("emit", "n_accept"),
            scfg=scfg, findings=findings, reports=reports,
            unpack=lambda out: (out[:, :-1], out[:, -1]))
        if s_out is not None:
            decode_width = int(s_out[0].shape[1])
            decode_carried = car in s_reads and car in s_writes

    # prefill chunk ------------------------------------------------------
    chunk = scfg.prefill_chunk
    if eng.paged and bool(scfg.fused_prefill):
        pf_fn = single._fused_chunk_fn(chunk, 0, eng.kv.pools)
        pf_builder = type(single)._fused_chunk_fn
        pf_state = eng.kv.pools
    else:
        pf_fn = single._prefill_chunk_fn(chunk, True, 0)
        pf_builder = type(single)._prefill_chunk_fn
        pf_state = single.request_cache()
    p_reads, p_writes, _ = audit_step(
        path=f"{tag}:prefill_chunk", fn=pf_fn, builder=pf_builder,
        inputs={"tokens": "prompt", "page_table": "page_table", "enc_out": "enc"},
        state=weights + [(car, pf_state)], out_regions=("logits",),
        scfg=scfg, findings=findings, reports=reports)
    prefill_carried = car in p_reads and car in p_writes

    # page scatter / gather ----------------------------------------------
    if eng.paged:
        kv = eng.kv
        audit_step(
            path=f"{tag}:page_scatter", fn=kv._make_scatter(1), builder=type(kv)._make_scatter,
            inputs={"pages": "page_table", "rows": "row0", "slot": "slot"},
            state=[(car, kv.pools), ("src", kv.staging())], out_regions=(),
            scfg=scfg, findings=findings, reports=reports)
        audit_step(
            path=f"{tag}:page_gather", fn=kv._make_gather(1), builder=type(kv)._make_gather,
            inputs={"pages": "page_table"}, state=[(car, kv.pools)],
            out_regions=("evicted",), scfg=scfg, findings=findings, reports=reports)

    _derive_categories(
        arch, scfg, tag=tag, decode_width=decode_width,
        decode_carried=decode_carried, prefill_carried=prefill_carried,
        prefill_reads=p_reads, findings=findings, reports=reports)
    return findings, reports


# -- category derivation (STR005) --------------------------------------------


def _check_category(tag: str, derived, desc, findings: list[Finding],
                    reports: list[PathReport], *, which: str, **classify_kw) -> None:
    expected, ok = W.crosscheck_category(derived, desc, **classify_kw)
    for r in reports:
        if r.path == f"{tag}:{which}":
            r.category = derived.value
    if not ok:
        findings.append(Finding(
            "STR005", f"{tag}:{which}",
            f"category derived from the step's footprint is {derived.value}, "
            f"classify_workload predicts {expected.value}", "sync"))


def _derive_categories(
    arch: str, scfg, *, tag: str, decode_width: int, decode_carried: bool,
    prefill_carried: bool, prefill_reads: frozenset[str],
    findings: list[Finding], reports: list[PathReport],
) -> None:
    """Re-derive each path's paper category from its footprint and
    cross-check the hand-modeled classifier (rule STR005)."""
    car = _carrier(arch)
    chunk = scfg.prefill_chunk
    whisper = arch == "whisper"
    head = ("encode", ("audio",), ("enc",)) if whisper else None
    shared = ("enc",) if (whisper and "enc" in prefill_reads) else ()

    # Chunked prefill: one request, 4 chunks -> the RAW carrier chain.
    derived = dep.classify(dep.unroll_stream(
        f"{tag}-prefill", per_task_reads=("prompt",),
        carrier=car if prefill_carried else None,
        shared_reads=shared, n_tasks=4, head=head))
    desc = W.WorkloadDescriptor(prompt_len_mean=4 * chunk, prompt_len_max=4 * chunk,
                                max_new_tokens=4, n_requests=1)
    _check_category(tag, derived, desc, findings, reports,
                    which="prefill_chunk", prefill_chunk=chunk, arch=arch)

    # One-shot prefill: a single chunk is one sequential stage (SYNC).
    derived = dep.classify(dep.unroll_stream(
        f"{tag}-oneshot", per_task_reads=("prompt",),
        carrier=car if prefill_carried else None,
        shared_reads=shared, n_tasks=1, head=head, sequential_kernel=whisper))
    desc = W.WorkloadDescriptor(prompt_len_mean=chunk, prompt_len_max=chunk,
                                max_new_tokens=4, n_requests=1)
    _check_category(tag, derived, desc, findings, reports,
                    which="prefill_oneshot", prefill_chunk=chunk, arch=arch)

    # Decode-dominated batch: the step's emit width says whether decode is
    # the per-token kernel re-running on resident state (ITERATIVE) or the
    # verify-chunk RAW chain speculation restructures it into.
    max_new = 64
    desc = W.WorkloadDescriptor(prompt_len_mean=chunk, prompt_len_max=chunk,
                                max_new_tokens=max_new, n_requests=scfg.max_batch)
    spec = decode_width > 1
    if spec and decode_carried:
        n_steps = min(8, -(-max_new // decode_width))
        derived = dep.classify(dep.unroll_stream(
            f"{tag}-spec", per_task_reads=("draft",), carrier=car, n_tasks=n_steps))
    elif decode_carried:
        derived = dep.classify(dep.unroll_stream(
            f"{tag}-decode", per_task_reads=("prompt",),
            n_tasks=scfg.max_batch, kernel_iterations=max_new))
    else:
        # A decode step that does not read its own carrier is broken in a
        # way the classifier cannot predict: surface as INDEPENDENT and
        # let the mismatch fire.
        derived = dep.Category.INDEPENDENT
    which = "spec_verify" if spec else "decode"
    _check_category(tag, derived, desc, findings, reports, which=which,
                    prefill_chunk=chunk, spec_decode=spec,
                    spec_k=max(0, decode_width - 1), arch=arch)


# -- top-level matrix --------------------------------------------------------


def _pairs(archs, modes) -> list[tuple[str, str]]:
    return [(a, m) for a, ms in ARCH_MODES.items() if not archs or a in archs
            for m in ms if not modes or m in modes]


def audit_matrix(
    archs: Sequence[str] | None = None,
    modes: Sequence[str] | None = None,
) -> tuple[list[Finding], list[PathReport]]:
    """Audit every requested arch x mode on the CPU; also AST-lints the
    tick-path modules once.  Returns (findings, per-path reports)."""
    from repro_torch.analysis import astlint
    from repro_torch.runtime import kv_cache, model_iface, serving

    findings: list[Finding] = []
    reports: list[PathReport] = []
    for mod in (serving, kv_cache, model_iface):
        findings.extend(astlint.lint_module(mod))
    for arch, mode in _pairs(archs, modes):
        f, r = audit_engine(build_engine(arch, mode, device="cpu"), arch, mode)
        findings.extend(f)
        reports.extend(r)
    return findings, reports


# -- the live audit ------------------------------------------------------------


_SYNC_ERROR = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class _Frame:
    name: str
    allowed: int
    fetches: int = 0


class LiveAudit:
    """Drive ``@tick_path`` methods under ``set_sync_debug_mode("error")``.

    ``watch(obj)`` wraps every marked method of ``obj`` (its class's
    marker, the instance's method, so an override is audited with its
    base's allowance); inside ``with audit:`` the outermost marked call
    raises on any synchronizing CUDA call, which is recorded as STR001 and
    re-raised.  Fetches (:func:`budget.host_fetch`) count against the
    innermost marked call (STR002 past ``allowed_fetches``); a sanctioned
    sync (a graph capture) is let through and counted.  On a CPU device
    nothing synchronizes, and only the fetch accounting runs.  Leaving the
    block unwraps every method."""

    def __init__(self, device, path: str = "live"):
        self.cuda = torch.device(device).type == "cuda"
        self.path = path
        self.findings: list[Finding] = []
        self.calls: collections.Counter = collections.Counter()
        self.max_fetches: dict[str, int] = {}
        self.allowed: dict[str, int] = {}
        self.fetches = 0
        self.sanctioned: collections.Counter = collections.Counter()
        self._stack: list[_Frame] = []
        self._wrapped: list[tuple[Any, str, Any]] = []
        self._flagged: set[str] = set()

    # -- wiring -------------------------------------------------------------

    def watch(self, obj) -> LiveAudit:
        seen = set()
        for cls in type(obj).__mro__:
            for name, attr in vars(cls).items():
                if name in seen or not hasattr(attr, TICK_ATTR):
                    continue
                seen.add(name)
                qual = f"{cls.__name__}.{name}"
                allowed = getattr(attr, TICK_ATTR)["allowed_fetches"]
                self.allowed[qual] = allowed
                self._wrapped.append((obj, name, obj.__dict__.get(name)))
                setattr(obj, name, self._guard(getattr(obj, name), qual, allowed))
        return self

    def __enter__(self) -> LiveAudit:
        if budget._live is not None:
            raise RuntimeError("a live audit is already running")
        budget._live = self
        return self

    def __exit__(self, *exc) -> None:
        budget._live = None
        self._set_mode(0)
        for obj, name, prev in reversed(self._wrapped):
            if prev is None:
                obj.__dict__.pop(name, None)
            else:
                setattr(obj, name, prev)
        self._wrapped.clear()

    def _set_mode(self, mode) -> None:
        if self.cuda:
            torch.cuda.set_sync_debug_mode(mode)

    @contextlib.contextmanager
    def _lowered(self):
        if not self._stack:
            yield
            return
        self._set_mode(0)
        try:
            yield
        finally:
            self._set_mode("error")

    def _guard(self, method, qual: str, allowed: int):
        def guard(*args, **kwargs):
            frame = _Frame(qual, allowed)
            outer = not self._stack
            self._stack.append(frame)
            if outer:
                self._set_mode("error")
            try:
                return method(*args, **kwargs)
            except RuntimeError as e:
                if _SYNC_ERROR in str(e) and not getattr(e, "_audited", False):
                    e._audited = True
                    self.findings.append(Finding(
                        "STR001", f"{self.path}:{qual}",
                        f"synchronizing CUDA call under the live audit at {_where(e)}: "
                        f"{str(e).splitlines()[0]}", "sync"))
                raise
            finally:
                self._stack.pop()
                if outer:
                    self._set_mode(0)
                self.calls[qual] += 1
                self.max_fetches[qual] = max(self.max_fetches.get(qual, 0), frame.fetches)
                if frame.fetches > allowed and qual not in self._flagged:
                    self._flagged.add(qual)
                    self.findings.append(Finding(
                        "STR002", f"{self.path}:{qual}",
                        f"{frame.fetches} fetches in one call of a tick path declaring "
                        f"allowed_fetches={allowed}", "sync"))
        guard.__wrapped__ = method
        return guard

    # -- the hooks budget calls ----------------------------------------------

    def fetch(self, x: torch.Tensor) -> np.ndarray:
        if self._stack:
            self._stack[-1].fetches += 1
            self.fetches += 1
        with self._lowered():
            return x.cpu().numpy()

    @contextlib.contextmanager
    def sanction(self, what: str):
        if self._stack:
            self.sanctioned[what] += 1
        with self._lowered():
            yield

    def report(self) -> dict:
        return {"path": self.path, "calls": dict(self.calls),
                "max_fetches": dict(self.max_fetches),
                "allowed_fetches": {k: self.allowed[k] for k in self.calls},
                "fetches": self.fetches, "sanctioned": dict(self.sanctioned),
                "findings": len(self.findings)}


def _where(e: BaseException) -> str:
    """The innermost frame of the port (outside the analyzer) that raised."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename and "/analysis/" not in f.filename]
    f = frames[-1] if frames else traceback.extract_tb(e.__traceback__)[-1]
    return f"{f.filename.rsplit('repro_torch/', 1)[-1]}:{f.lineno}"


def live_prompts(arch: str, mode: str, vocab: int, seed: int = 0) -> list[np.ndarray]:
    """The live serve's prompts: random, or tiled for the spec mode (so
    the n-gram drafter proposes and the verify step runs)."""
    rng = np.random.default_rng(seed)
    if mode == "spec":
        base = rng.integers(0, vocab, size=6)
        return [np.tile(base, -(-n // 6))[:n].astype(np.int32) for n in LIVE_PROMPTS]
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in LIVE_PROMPTS]


def live_engine(arch: str, mode: str, *, device=None) -> tuple[list[Finding], dict]:
    """Serve the live prompts on one (arch, mode) engine under the live
    audit (a paged engine in LIVE_BLOCKS blocks, which preempts), and
    drive the one marked method the serve does not reach
    (``device_page_table``), on ``device`` (the card unless the caller
    asks for the CPU).  Returns (findings, report)."""
    device = resolve_device(device)
    over = {"num_blocks": LIVE_BLOCKS} if mode != "contiguous" else {}
    eng = build_engine(arch, mode, device=device, max_new_tokens=LIVE_NEW, **over)
    cfg = eng.cfg
    rng = np.random.default_rng(1)
    audit = LiveAudit(device, path=f"live:{arch}/{mode}").watch(eng)
    if eng.paged:
        audit.watch(eng.kv)
    t0 = time.perf_counter()
    n_tokens = 0
    with audit:
        try:
            for p in live_prompts(arch, mode, cfg.vocab_size):
                enc = (rng.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(np.float32)
                       if cfg.is_encoder_decoder else None)
                eng.submit(p, enc_inputs=enc)
            n_tokens = sum(len(t) for t in eng.run().values())
            if eng.paged:
                eng.kv.device_page_table()
        except RuntimeError as e:
            if not getattr(e, "_audited", False):
                raise
    rep = audit.report()
    rep.update(tokens=n_tokens, seconds=time.perf_counter() - t0,
               preemptions=eng.preemptions, decode_steps=eng.decode_steps,
               spec_ticks=eng.spec_ticks)
    return audit.findings, rep


def live_matrix(archs: Sequence[str] | None = None, modes: Sequence[str] | None = None,
                *, device=None) -> tuple[list[Finding], list[dict]]:
    """The live audit of every requested arch x mode on ``device`` (the
    card unless the caller asks for the CPU)."""
    findings: list[Finding] = []
    reports: list[dict] = []
    for arch, mode in _pairs(archs, modes):
        f, r = live_engine(arch, mode, device=device)
        findings.extend(f)
        reports.append(r)
    return findings, reports
