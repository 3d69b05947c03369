"""Observability of the port's serving engine: trace spans, metrics, SLO
scoring, request timelines, overlap reconstruction, the doctor and the
perf-regression comparator (the reference ``obs/`` package, copied).

``Tracer`` records per-tick spans on the prefill/decode/transfer tracks
(Chrome/Perfetto export); ``MetricsRegistry`` holds the engine's
counters and latency/transfer histograms behind one snapshot; ``overlap``
turns the recorded timeline into a measured overlap efficiency and
compares it with the R-gate's analytic prediction.  On top of those:
``requests`` rebuilds per-request lifecycles (queue wait, TTFT,
per-token ITLs, stalls) from a trace, ``slo`` scores them against
TTFT/ITL targets (attainment + goodput), and ``doctor`` turns a trace into
a ranked bottleneck diagnosis (``python -m repro_torch.obs.doctor``);
``baseline`` gates fresh bench results against baseline files
(``python -m repro_torch.obs.baseline``).

The span names, arguments, snapshot schema and trace format are the
reference's, so either package's readers take the other's files.  Stdlib
only: nothing here imports torch.
"""

from .metrics import Histogram, MetricsRegistry, SCHEMA_VERSION
from .overlap import (
    measured_overlap,
    overlap_report,
    predicted_overlap,
    stage_times_from_trace,
)
from .requests import (
    RequestTimeline,
    reconstruct_timelines,
    timeline_aggregates,
    timelines_from_trace,
)
from .slo import SLOPolicy, score_timelines
from .trace import TRACKS, Span, Tracer, read_trace, span_tree

__all__ = [
    "Histogram",
    "MetricsRegistry",
    "SCHEMA_VERSION",
    "Span",
    "Tracer",
    "TRACKS",
    "read_trace",
    "span_tree",
    "measured_overlap",
    "predicted_overlap",
    "overlap_report",
    "stage_times_from_trace",
    "RequestTimeline",
    "reconstruct_timelines",
    "timelines_from_trace",
    "timeline_aggregates",
    "SLOPolicy",
    "score_timelines",
]
