"""Metrics registry: counters and streaming histograms for the engine.

One registry per engine replaces the scattered counter attributes that
grew on ``StreamedBatchEngine`` PR by PR (``prefix_hits``,
``spec_ticks``, ``admit_seconds``, ...).  The engine exposes the whole
registry through ``engine.metrics_snapshot()``; the old attribute names
survive as property shims (``serving._MetricAttr``) so existing callers
and tests keep working, but the snapshot is the supported surface.

Design constraints (this sits on the tick path):

* **Scalars are plain Python numbers** in a dict — ``inc``/``set_value``
  are one dict operation, and ints stay ints (counters print as ``7``,
  not ``7.0``; ``admit_seconds`` accumulates floats).
* **Histograms are streaming**: fixed geometric buckets held in a sparse
  dict, so recording is O(1), memory is O(distinct buckets), and
  p50/p99 come out with ~4% relative error without retaining samples.
  Latency seconds and transfer bytes share one bucket layout (the range
  covers nanoseconds to kilobytes-of-seconds and bytes to gigabytes).
* **stdlib only** — the port's copy of the reference ``obs/metrics.py``,
  with the same ``SCHEMA_VERSION``.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

__all__ = ["Histogram", "MetricsRegistry", "SCHEMA_VERSION"]

#: Bump when the snapshot layout changes shape (consumers: bench_serving,
#: the CI schema smoke, dashboards).
SCHEMA_VERSION = 1

# Geometric bucket layout shared by every histogram: bucket i covers
# [_LO * _GROWTH**i, _LO * _GROWTH**(i+1)).  _GROWTH = 1.08 bounds the
# quantile estimate's relative error by ~4% (sqrt(1.08) - 1).
_LO = 1e-9
_LN_GROWTH = math.log(1.08)


def _bucket(v: float) -> int:
    if v <= _LO:
        return 0
    return int(math.log(v / _LO) / _LN_GROWTH)


def _bucket_mid(i: int) -> float:
    """Representative value of bucket ``i`` (geometric midpoint)."""
    return _LO * math.exp((i + 0.5) * _LN_GROWTH)


class Histogram:
    """Streaming histogram: O(1) observe, quantiles from sparse buckets.

    Exact ``count``/``sum``/``min``/``max`` ride along, so means are
    exact and only the mid-quantiles are approximate.
    """

    __slots__ = ("_counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self._counts: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        b = _bucket(v)
        self._counts[b] = self._counts.get(b, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Approximate ``q``-quantile (0..1); 0.0 when empty.

        The tail buckets return the exact observed min/max so p0/p100
        never exceed the data's actual range.
        """
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i in sorted(self._counts):
            seen += self._counts[i]
            if seen >= target:
                mid = _bucket_mid(i)
                return min(max(mid, self.min), self.max)
        return self.max

    def snapshot(self) -> dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p99": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named scalars + histograms behind one snapshot.

    Scalar metrics are created on first touch at 0, so property shims can
    read a counter that was never incremented.  Names are dotted
    (``serving.decode_steps``, ``latency.ttft_s``); the catalog lives in
    the README's Observability section.
    """

    def __init__(self) -> None:
        self._values: dict[str, Any] = {}
        self._hists: dict[str, Histogram] = {}

    # -- scalars ---------------------------------------------------------

    def inc(self, name: str, n: int | float = 1) -> None:
        self._values[name] = self._values.get(name, 0) + n

    def set_value(self, name: str, v: Any) -> None:
        self._values[name] = v

    def value(self, name: str, default: Any = 0) -> Any:
        return self._values.get(name, default)

    def max_value(self, name: str, v: Any) -> None:
        """Peak-tracking scalar: keep the running maximum."""
        if v > self._values.get(name, 0):
            self._values[name] = v

    # -- histograms ------------------------------------------------------

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # -- snapshot --------------------------------------------------------

    def names(self) -> Iterable[str]:
        return list(self._values) + list(self._hists)

    def snapshot(self) -> dict[str, Any]:
        """The machine-readable registry state (JSON-serializable)."""
        return {
            "schema": SCHEMA_VERSION,
            "counters": dict(sorted(self._values.items())),
            "histograms": {k: self._hists[k].snapshot()
                           for k in sorted(self._hists)},
        }
