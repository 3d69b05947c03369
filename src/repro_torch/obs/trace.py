"""Ring-buffer span tracer with Chrome/Perfetto trace export.

The paper's stream timelines (Fig. 5 style) are plots of which logical
stream — prefill, decode, transfer — is busy at each instant.  This
module records exactly that: fixed-capacity ring buffer of spans stamped
with ``time.perf_counter_ns()``, one logical *track* per stream, dumped
as Chrome ``trace.json`` (``chrome://tracing`` / https://ui.perfetto.dev)
so the overlap the engine achieves is literally viewable.

Cost model: when ``enabled`` is False every hook is a single attribute
check and the clock is never read (``t()`` returns 0, ``add()`` returns
immediately); no buffer is allocated.  When enabled, a span is one tuple
append — no I/O, no allocation beyond the record — so tracing is safe on
the decode tick path.  The engine only ever calls plain methods on the
tracer, never coerces device values, so instrumentation stays invisible
to the ``@tick_path`` AST lint.

Track names are the span taxonomy's first level:

* ``prefill``  — admission windows and in-flight prefill chunks
* ``decode``   — decode/spec ticks (host_fetch-bounded, so true latency)
* ``transfer`` — page scatter/gather, evict/readmit staging, H2D prep

The port's copy of the reference ``obs/trace.py`` (same clock, same
Chrome JSON, so either package reads the other's files); stdlib only.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Iterable

__all__ = ["Span", "Tracer", "read_trace", "span_tree", "TRACKS"]

#: Logical streams, in display order (tid in the Chrome export).
TRACKS = ("prefill", "decode", "transfer")


@dataclass(frozen=True)
class Span:
    """One closed interval on a track. Times are perf_counter nanoseconds."""

    track: str
    name: str
    t0_ns: int
    t1_ns: int
    args: dict[str, Any] = field(default_factory=dict)

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    @property
    def dur_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


class Tracer:
    """Fixed-capacity span recorder; oldest spans are overwritten.

    Usage on an instrumented path::

        t0 = tr.t()                 # 0 when disabled, never reads clock
        ... work ...
        tr.add("decode", "decode_tick", t0, tick=n, d2h_bytes=b)

    ``add`` closes the span at the current clock.  ``instant`` records a
    zero-duration marker (used for live STR002 flags).
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.enabled = enabled
        self._buf: list[Span] = []
        self._n = 0  # total spans ever recorded (>= len(_buf) once wrapped)

    # -- recording -------------------------------------------------------

    def t(self) -> int:
        """Span-start timestamp; 0 when disabled (callers pass it back)."""
        if not self.enabled:
            return 0
        return time.perf_counter_ns()

    def add(self, track: str, name: str, t0_ns: int, **args: Any) -> None:
        if not self.enabled:
            return
        span = Span(track, name, t0_ns, time.perf_counter_ns(), args)
        if len(self._buf) < self.capacity:
            self._buf.append(span)
        else:
            self._buf[self._n % self.capacity] = span
        self._n += 1

    def instant(self, track: str, name: str, **args: Any) -> None:
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        span = Span(track, name, now, now, args)
        if len(self._buf) < self.capacity:
            self._buf.append(span)
        else:
            self._buf[self._n % self.capacity] = span
        self._n += 1

    # -- inspection ------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wrap-around."""
        return max(0, self._n - self.capacity)

    def spans(self) -> list[Span]:
        """All retained spans, sorted by start time."""
        return sorted(self._buf, key=lambda s: (s.t0_ns, s.t1_ns))

    def clear(self) -> None:
        self._buf.clear()
        self._n = 0

    # -- export ----------------------------------------------------------

    def to_chrome(self, path: str) -> dict[str, Any]:
        """Write Chrome trace-event JSON; returns the written document.

        One process (pid 0, named "repro-serving"), one thread per track.
        Timestamps are microseconds relative to the earliest span so the
        viewer opens at t=0.
        """
        spans = self.spans()
        base = spans[0].t0_ns if spans else 0
        events: list[dict[str, Any]] = [{
            "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
            "args": {"name": "repro-serving"},
        }]
        tids = {tr: i for i, tr in enumerate(TRACKS)}
        for tr in spans:
            tids.setdefault(tr.track, len(tids))
        for tr, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "pid": 0, "tid": tid,
                           "name": "thread_name", "args": {"name": tr}})
        for s in spans:
            ev = {
                "ph": "X",
                "pid": 0,
                "tid": tids[s.track],
                "name": s.name,
                "ts": (s.t0_ns - base) / 1e3,
                "dur": s.dur_ns / 1e3,
                "args": dict(s.args),
            }
            events.append(ev)
        doc = {"traceEvents": events,
               "displayTimeUnit": "ms",
               "otherData": {"dropped_spans": self.dropped}}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return doc


def read_trace(path: str) -> list[Span]:
    """Parse a Chrome trace written by :meth:`Tracer.to_chrome` back to spans."""
    with open(path) as f:
        doc = json.load(f)
    names: dict[int, str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    spans = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        t0 = int(round(ev["ts"] * 1e3))
        spans.append(Span(
            track=names.get(ev["tid"], str(ev["tid"])),
            name=ev["name"],
            t0_ns=t0,
            t1_ns=t0 + int(round(ev["dur"] * 1e3)),
            args=dict(ev.get("args", {})),
        ))
    return sorted(spans, key=lambda s: (s.t0_ns, s.t1_ns))


def span_tree(spans: Iterable[Span]) -> dict[str, list[dict[str, Any]]]:
    """Nest spans by containment, per track.

    Returns ``{track: [node, ...]}`` where each node is
    ``{"span": Span, "children": [node, ...]}``.  A span B is a child of
    A when A's interval contains B's and A started first (ties broken by
    longer-first ordering, matching how the Chrome viewer nests them).
    """
    tree: dict[str, list[dict[str, Any]]] = {}
    by_track: dict[str, list[Span]] = {}
    for s in spans:
        by_track.setdefault(s.track, []).append(s)
    for track, ss in by_track.items():
        ss = sorted(ss, key=lambda s: (s.t0_ns, -s.t1_ns))
        roots: list[dict[str, Any]] = []
        stack: list[dict[str, Any]] = []
        for s in ss:
            node = {"span": s, "children": []}
            while stack and stack[-1]["span"].t1_ns < s.t1_ns:
                stack.pop()
            while stack and not (stack[-1]["span"].t0_ns <= s.t0_ns
                                 and s.t1_ns <= stack[-1]["span"].t1_ns):
                stack.pop()
            if stack:
                stack[-1]["children"].append(node)
            else:
                roots.append(node)
            stack.append(node)
        tree[track] = roots
    return tree
