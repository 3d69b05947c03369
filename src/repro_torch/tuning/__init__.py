"""Measurement-driven stream autotuning (follow-on work to the paper).

The paper's generic flow (§6) decides *whether* and *how* to stream from
measured stage times; its follow-ons (Zhang et al., arXiv:1802.02760 /
2003.04294) show that streaming knobs are workload- and machine-dependent
enough to warrant a measured/learned tuner.  This package is that tuner for
the port's serving stack (the reference ``tuning/`` package, copied):

  * ``workload``  — a workload descriptor (prompt-length distribution,
    shared-prefix fraction, arrival pattern) and a classifier mapping it
    onto the paper's five dependency categories (``core.dependency``) so
    non-streamable shapes short-circuit to the single-stream path.
  * ``profiler``  — a micro-benchmark harness that times real prefill
    chunks, decode ticks, page scatter/gather and H2D/D2H staging on the
    engine's device, producing calibrated ``StageTimes`` instead of
    synthetic estimates, plus whole-workload throughput measurement.
  * ``search``    — a bounded coordinate-descent search over the streaming
    knobs (prefill chunk, page size, pool size, slot count, pool dtype),
    warm-started from the analytic ``ServingPlan`` (the R gate and
    ``rmetric.optimal_streams`` are the priors), scoring candidates by
    measured tokens/s and admission latency.
  * ``db``        — a persistent on-disk tuning database keyed by a
    fingerprint of (device type and name, model config, workload bucket),
    with a versioned schema and LRU bounds; its ``TunedPlan`` records
    round-trip into ``ServeConfig`` and read in either package.
"""

from repro_torch.tuning.db import (SCHEMA_VERSION, TunedPlan, TuningDB,
                                   default_db_path, fingerprint)
from repro_torch.tuning.profiler import (StageProfile, WorkloadMeasurement,
                                         measure_workload, profile_engine)
from repro_torch.tuning.search import SearchBudget, search_tuned_plan
from repro_torch.tuning.workload import (WorkloadDescriptor, classify_workload,
                                         synth_prompts)

__all__ = [
    "SCHEMA_VERSION",
    "SearchBudget",
    "StageProfile",
    "TunedPlan",
    "TuningDB",
    "WorkloadDescriptor",
    "WorkloadMeasurement",
    "classify_workload",
    "default_db_path",
    "fingerprint",
    "measure_workload",
    "profile_engine",
    "search_tuned_plan",
    "synth_prompts",
]
