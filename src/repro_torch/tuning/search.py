"""Bounded measured search over the streaming knobs.

The paper's generic flow (§6) prices streaming analytically; its follow-on
work (Zhang et al., 1802.02760 / 2003.04294) shows the knobs are workload-
and machine-dependent enough to need measurement.  This search keeps the
analytic flow as the *prior* and measurement as the *judge*:

  * the warm start is ``plan_decode_policy`` fed with *calibrated* stage
    times from ``tuning.profiler`` — the R gate and ``optimal_streams``
    pick the neighborhood the search explores, so the budget is spent
    refining a good guess, not scanning a grid;
  * the workload classifier (``tuning.workload``) short-circuits
    non-streamable shapes to the single-stream path (one-shot prefill, no
    interleave) before any chunk candidate is paid for;
  * every candidate is a real engine run (``measure_workload``) scored by
    measured tokens/s (admission latency joins the score for open-arrival
    workloads), and its greedy outputs must be bitwise identical to the
    untuned path — a candidate that changes tokens is rejected outright,
    so a ``TunedPlan`` can never trade correctness for speed;
  * coordinate descent over one knob at a time, bounded by
    ``SearchBudget.max_trials`` engine measurements, with a memo so a
    revisited assignment costs nothing.

The untuned base config and the analytic warm start are themselves scored
candidates, so the returned plan's measured tokens/s is >= both by
construction.

The port's copy of the reference ``tuning/search.py``.  Two differences:
the port's paged path always decodes through its CUDA kernel, so the
``paged_kernel`` knob has one value (``paged``) and reaches no
``ServeConfig``; and a trial drops only a candidate that configuration
rejects (its ``ServeConfig`` or engine construction raising ``ValueError``
or ``NotImplementedError``, or a pool too small for the longest request
alone).  Every other error of a trial, a ``RuntimeError`` from a kernel
build or launch, a CUDA error or out-of-memory among them, propagates: the
search never ranks a candidate by its failure.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.runtime.model_iface import arch_kind_of
from repro_torch.runtime.serving import StreamedBatchEngine, plan_decode_policy
from repro_torch.tuning import profiler as prof
from repro_torch.tuning.db import TunedPlan, fingerprint
from repro_torch.tuning.workload import WorkloadDescriptor, classify_workload

#: Knob sweep order: granularity knobs first (they dominate per Zhang et
#: al.; ``spec_k`` is the decode stream's granularity the way
#: ``prefill_chunk`` is the prefill stream's), resource knobs after,
#: binary kernel/registry knobs last.
_DIMS = ("prefill_chunk", "spec_k", "block_size", "num_blocks", "kv_dtype",
         "max_batch", "decode_interleave", "paged_kernel",
         "prefix_min_pages")

_MAX_SPEC_K = 16

_MIN_CHUNK = 16

#: Minimum mean greedy-token agreement a quantized candidate must keep
#: against the fp32 reference outputs.  Bitwise parity is impossible by
#: construction (the pool stores codes), and greedy divergence cascades
#: once a single argmax flips, so the guard bounds the *mean per-token*
#: agreement across the workload instead — a candidate below it is
#: trading too much output fidelity for capacity and is rejected outright.
_QUANT_PARITY_MIN = 0.5


@dataclasses.dataclass(frozen=True)
class SearchBudget:
    """Caps on what the search may spend (one trial = one measured engine
    run, warmup included)."""

    max_trials: int = 12
    sweeps: int = 2  # coordinate-descent passes over the knob list
    profile_repeats: int = 2  # per-stage probe repeats (median)
    timed_runs: int = 3  # timed workload repeats per candidate (median)
    margin: float = 0.03  # relative score gap a challenger must clear —
    # hysteresis so measurement jitter can't flip the incumbent

    def __post_init__(self) -> None:
        if (self.max_trials < 1 or self.sweeps < 1
                or self.profile_repeats < 1 or self.timed_runs < 1):
            raise ValueError(f"budget fields must be >= 1, got {self}")
        if self.margin < 0.0:
            raise ValueError(f"margin must be >= 0, got {self.margin}")


def _pow2_neighbors(value: int, lo: int, hi: int) -> list[int]:
    cands = {value, max(lo, value // 2), min(hi, value * 2)}
    return sorted(v for v in cands if lo <= v <= hi)


def _candidates(
    dim: str, asg: dict, scfg, desc: WorkloadDescriptor, *,
    streamable: bool,
) -> list[Any]:
    """Neighborhood of the current assignment along one knob."""
    cur = asg[dim]
    if dim == "prefill_chunk":
        if not streamable:
            return [cur]  # pinned to one-shot by the classifier
        hi = min(scfg.max_seq, max(_MIN_CHUNK, desc.prompt_len_max))
        return sorted(set(_pow2_neighbors(cur, _MIN_CHUNK, hi)) | {hi})
    if dim == "decode_interleave":
        if not streamable:
            return [cur]
        return sorted({max(1, cur - 1), cur, cur + 1})
    if dim == "spec_k":
        if not scfg.spec_decode:
            return [cur]  # speculation off: the verify step never runs
        # Draft length is the decode-chunk granularity knob: longer drafts
        # amortize more dispatches but waste more verify compute per
        # rejection.  Cap at the per-tick token budget — drafting past
        # max_new_tokens can never be accepted.
        hi = min(_MAX_SPEC_K, max(1, desc.max_new_tokens - 1))
        return _pow2_neighbors(cur, 1, hi)
    if dim == "block_size":
        if not scfg.paged:
            return [cur]
        cands = _pow2_neighbors(cur, 4, scfg.max_seq)
        return [b for b in cands if scfg.max_seq % b == 0] or [cur]
    if dim == "num_blocks":
        if not scfg.paged or cur is None:
            return [cur]  # None = contiguous-parity pool; nothing to shrink
        worst = -(-(desc.prompt_len_max + desc.max_new_tokens)
                  // asg["block_size"]) + 1
        cands = {cur, max(worst + 1, 3 * cur // 4), max(worst + 1, cur // 2)}
        return sorted(c for c in cands if c >= 2)
    if dim == "kv_dtype":
        if not scfg.paged:
            return [cur]  # the contiguous cache stays full precision
        # Quantized pools are scored at a byte-budget-equalized num_blocks
        # (see _serve_config), so what the measurement judges is the
        # capacity each dtype buys per HBM byte; non-transformer archs
        # reject the candidate at engine construction (validate_arch) and
        # the measure() guard skips it.
        return [c for c in ("fp32", "int8", "fp8")]
    if dim == "max_batch":
        hi = max(1, min(desc.n_requests, 2 * cur))
        return sorted({max(1, cur // 2), cur, hi})
    if dim == "paged_kernel":
        return [cur]  # the paged path always runs the CUDA kernel
    if dim == "prefix_min_pages":
        if scfg.paged and scfg.prefix_sharing:
            return sorted({1, 2, cur})
        return [cur]
    raise KeyError(dim)


def _resolved_num_blocks(cfg, scfg, asg: dict) -> int | None:
    """The pool size a candidate is actually measured with.

    A ``kv_dtype`` candidate keeps the *byte* budget of the assignment's
    (block_size, num_blocks) at the base dtype and converts it into pages
    at the candidate dtype — so the measurement judges capacity bought per
    HBM byte, never a secretly bigger pool.  None (contiguous-parity pool)
    passes through: its size is derived from max_seq, not a budget.
    """
    num_blocks = asg["num_blocks"]
    if (not scfg.paged or num_blocks is None
            or asg["kv_dtype"] == scfg.kv_dtype):
        return num_blocks
    base_pb = quant.page_bytes_est(
        asg["block_size"], cfg.n_kv_heads, cfg.head_dim, scfg.kv_dtype)
    cand_pb = quant.page_bytes_est(
        asg["block_size"], cfg.n_kv_heads, cfg.head_dim, asg["kv_dtype"])
    return max(2, num_blocks * base_pb // cand_pb)


def _serve_config(cfg, scfg, asg: dict):
    return dataclasses.replace(
        scfg,
        prefill_chunk=asg["prefill_chunk"],
        decode_interleave=asg["decode_interleave"],
        block_size=asg["block_size"],
        num_blocks=_resolved_num_blocks(cfg, scfg, asg),
        max_batch=asg["max_batch"],
        prefix_min_pages=asg["prefix_min_pages"],
        spec_k=asg["spec_k"],
        kv_dtype=asg["kv_dtype"])


class _Rejected(Exception):
    """A candidate the configuration rejects (never a failed run)."""


def search_tuned_plan(
    cfg, params, scfg, desc: WorkloadDescriptor, *, device=None,
    budget: SearchBudget = SearchBudget(), seed: int = 0,
    admit_weight: float | None = None, log=None,
) -> TunedPlan:
    """Measure-and-descend to a ``TunedPlan`` for (``cfg``, ``desc``).

    ``scfg`` is the untuned base configuration: it fixes the workload
    policy (``max_seq``, temperature, sharing on/off) and is both the
    parity reference and the first scored candidate.  ``admit_weight``
    (tokens/s forfeited per ms of admission latency) defaults by arrival
    pattern: 0 for a closed batch, a small weight for open arrivals.
    Every engine runs on ``device`` (CUDA unless "cpu" is passed), one at
    a time: the probe and each candidate's engine are dropped before the
    next is built.
    """
    say = log or (lambda msg: None)
    device = resolve_device(device)
    if admit_weight is None:
        admit_weight = 0.05 if desc.arrival == "open" else 0.0

    # -- calibrate + warm start (the analytic flow as prior) ------------------
    probe = StreamedBatchEngine(cfg, params, dataclasses.replace(scfg),
                                device=device)
    profile = prof.profile_engine(
        probe, desc.prompt_len_mean, repeats=budget.profile_repeats)
    del probe
    gc.collect()
    stage_times = profile.stage_times()
    analytic = plan_decode_policy(
        stage_times, prompt_len=desc.prompt_len_mean, max_seq=scfg.max_seq)
    category = classify_workload(
        desc, prefill_chunk=analytic.prefill_chunk,
        # staged = the prefix leaves per-task read sets: page sharing for
        # attention archs, state snapshots for SSMs
        prefix_staged=scfg.prefix_sharing or scfg.state_snapshots,
        spec_decode=scfg.spec_decode, spec_k=scfg.spec_k,
        arch=arch_kind_of(cfg))
    streamable = category.streamable
    say(f"[tune] calibrated chunk={profile.chunk_s * 1e3:.2f}ms "
        f"decode={profile.decode_s * 1e3:.2f}ms -> {analytic.decision}, "
        f"workload {category.value}"
        f"{'' if streamable else ' (single-stream short-circuit)'}")

    def assignment(chunk, interleave, block):
        return {
            "prefill_chunk": chunk,
            "decode_interleave": interleave,
            "block_size": block,
            "num_blocks": scfg.num_blocks,
            "max_batch": scfg.max_batch,
            "paged_kernel": bool(scfg.paged),
            "prefix_min_pages": scfg.prefix_min_pages,
            "spec_k": scfg.spec_k,
            "kv_dtype": scfg.kv_dtype,
        }

    untuned = assignment(
        scfg.prefill_chunk, scfg.decode_interleave, scfg.block_size)
    if streamable:
        start = assignment(
            analytic.prefill_chunk, analytic.decode_interleave,
            analytic.block_size if scfg.paged else scfg.block_size)
    else:
        # Non-streamable shape: one-shot prefill, no interleave (§4.1).
        start = assignment(
            min(scfg.max_seq, max(_MIN_CHUNK, desc.prompt_len_max)), 1,
            analytic.block_size if scfg.paged else scfg.block_size)
    if scfg.paged and scfg.max_seq % start["block_size"] != 0:
        start["block_size"] = untuned["block_size"]

    # -- measured scoring with a bitwise-parity guard -------------------------
    memo: dict[tuple, prof.WorkloadMeasurement | None] = {}
    trials = 0

    def key(asg: dict) -> tuple:
        return tuple(asg[d] for d in _DIMS)

    def reject(k: tuple, why) -> None:
        say(f"[tune] rejected {k}: {why}")
        memo[k] = None

    def measure(asg: dict) -> prof.WorkloadMeasurement | None:
        nonlocal trials
        k = key(asg)
        if k in memo:
            return memo[k]
        if trials >= budget.max_trials:
            return None
        try:
            sc = _serve_config(cfg, scfg, asg)
        except (ValueError, NotImplementedError) as e:
            return reject(k, e)

        def make_engine():
            try:
                eng = StreamedBatchEngine(cfg, params, sc, device=device)
            except (ValueError, NotImplementedError) as e:
                raise _Rejected(e) from None
            if eng.paged:
                # submit's progress rule: the longest request must be able
                # to finish alone in the pool
                worst = eng.kv.pages_for(desc.prompt_len_max + desc.max_new_tokens)
                capacity = eng.kv.allocator.capacity
                if worst > capacity:
                    del eng
                    raise _Rejected(f"request needs {worst} pages but the pool "
                                    f"has {capacity}")
            return eng
        try:
            m = prof.measure_workload(
                make_engine, desc, vocab_size=cfg.vocab_size, seed=seed,
                timed_runs=budget.timed_runs)
        except _Rejected as e:
            return reject(k, e)
        trials += 1
        memo[k] = m
        return m

    ref = measure(untuned)
    assert ref is not None, "the untuned base config must be measurable"

    def parity_ok(m: prof.WorkloadMeasurement, asg: dict) -> bool:
        """Bitwise token parity for same-dtype candidates; a mean
        greedy-agreement bound for quantized ones (bitwise is impossible
        by construction once the pool stores codes — the tolerance-based
        guard replaces it *only* on quantized paths)."""
        if asg["kv_dtype"] == untuned["kv_dtype"]:
            return all(np.array_equal(m.outputs[i], ref.outputs[i])
                       for i in ref.outputs)
        agree = [np.mean(np.asarray(m.outputs[i]) ==
                         np.asarray(ref.outputs[i]))
                 for i in ref.outputs
                 if np.asarray(m.outputs[i]).shape ==
                 np.asarray(ref.outputs[i]).shape]
        if len(agree) != len(ref.outputs):
            return False  # a missing/odd-shaped output is never tolerable
        return float(np.mean(agree)) >= _QUANT_PARITY_MIN

    def score(m: prof.WorkloadMeasurement | None, asg: dict) -> float:
        if m is None or not parity_ok(m, asg):
            return -np.inf  # never trade tokens for speed
        return m.score(admit_weight=admit_weight)

    def beats(m, asg, inc_m, inc_asg) -> bool:
        """Challenger must clear the incumbent by the hysteresis margin."""
        s, si = score(m, asg), score(inc_m, inc_asg)
        return s > si + budget.margin * abs(si)

    best_asg, best_m = dict(untuned), ref
    base_m = measure(start)  # the analytic warm start, scored
    if beats(base_m, start, best_m, best_asg):
        best_asg, best_m = dict(start), base_m
    # The recorded baseline is the analytic start when it measured validly,
    # else the untuned reference; its assignment travels with it so a later
    # promotion can never pair start's knobs with ref's measurements.
    if base_m is not None and parity_ok(base_m, start):
        baseline, baseline_asg = base_m, dict(start)
    else:
        baseline, baseline_asg = ref, dict(untuned)

    # -- coordinate descent ---------------------------------------------------
    for _ in range(budget.sweeps):
        improved = False
        for dim in _DIMS:
            for cand in _candidates(
                    dim, best_asg, scfg, desc, streamable=streamable):
                if cand == best_asg[dim]:
                    continue
                trial = dict(best_asg)
                trial[dim] = cand
                m = measure(trial)
                if beats(m, trial, best_m, best_asg):
                    say(f"[tune] {dim}={cand}: "
                        f"{m.tokens_per_s:.1f} tok/s > "
                        f"{best_m.tokens_per_s:.1f}")
                    best_asg, best_m = trial, m
                    improved = True
            if trials >= budget.max_trials:
                break
        if not improved or trials >= budget.max_trials:
            break

    if baseline.tokens_per_s > best_m.tokens_per_s:
        # The hysteresis margin kept an incumbent the baseline nominally
        # outmeasured; promote the baseline's own assignment so the
        # returned plan is never worse than its recorded baseline.
        best_asg, best_m = dict(baseline_asg), baseline
    say(f"[tune] best {best_m.tokens_per_s:.1f} tok/s "
        f"(analytic baseline {baseline.tokens_per_s:.1f}) "
        f"after {trials} trials")
    return TunedPlan(
        fingerprint=fingerprint(cfg, desc, scfg, device=device),
        prefill_chunk=best_asg["prefill_chunk"],
        decode_interleave=best_asg["decode_interleave"],
        block_size=best_asg["block_size"],
        # the byte-budget-equalized pool the winner was *measured* with,
        # so applying the plan reproduces the measured configuration
        num_blocks=_resolved_num_blocks(cfg, scfg, best_asg),
        kv_dtype=best_asg["kv_dtype"],
        max_batch=best_asg["max_batch"],
        paged=scfg.paged,
        paged_kernel=best_asg["paged_kernel"],
        prefix_min_pages=best_asg["prefix_min_pages"],
        spec_decode=scfg.spec_decode,
        spec_k=best_asg["spec_k"],
        tokens_per_s=best_m.tokens_per_s,
        admit_ms=best_m.admit_ms,
        baseline_tokens_per_s=baseline.tokens_per_s,
        baseline_admit_ms=baseline.admit_ms,
        stage_times=(stage_times.h2d, stage_times.kex, stage_times.d2h),
        decision=analytic.decision,
        category=category.value,
        max_seq=scfg.max_seq,
        trials=trials,
        source="measured")
