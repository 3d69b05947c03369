"""The traced run's device timeline: ``torch.profiler`` (device activity
only) over a sub-span of the window, so that the trace stays small.

The span opens before the first ``step()`` at or past ``start`` seconds
into the window and closes when the window does, so that reading the
trace costs the window nothing.  Its kernels are put on the host's clock
by a marker kernel launched on an idle device at a known host time at
each end of the span.  From the timeline:

* ``busy_s``: the union of the device's activity inside the span;
* per step of the span (an admission or ticks alone, from the load
  loop's own stamps): the time with no kernel running, and the gaps;
* device time by kernel name.

The grouping of kernels by name and the idle arithmetic are those of the
program's ``launch/serve_profile.py``, copied here so that the yardstick
stays put.
"""

from __future__ import annotations

import dataclasses

import torch

MARKER_CYCLES = 20000


def _marker() -> None:
    torch.cuda._sleep(MARKER_CYCLES)


@dataclasses.dataclass
class Trace:
    start: float  # host seconds after the window opened
    end: float
    kernels: list  # (name, start, end), host seconds after the window opened
    steps: list  # (start, end, admitted uids) of the steps inside the span

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy(self, lo: float, hi: float) -> tuple[float, list[tuple[float, float]]]:
        """Seconds of [lo, hi] with device activity, and the idle gaps."""
        merged: list[list[float]] = []
        for _, a, b in sorted((k for k in self.kernels if k[2] > lo and k[1] < hi),
                              key=lambda k: k[1]):
            a, b = max(a, lo), min(b, hi)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        gaps, at = [], lo
        for a, b in merged:
            if a > at:
                gaps.append((at, a))
            at = b
        if hi > at:
            gaps.append((at, hi))
        return sum(b - a for a, b in merged), gaps

    def kernel_seconds(self, match) -> float:
        return sum(b - a for n, a, b in self.kernels if match(n))

    def step_idle(self) -> tuple[float, float, list[tuple[str, float]]]:
        """(time inside the span's steps, of it with no kernel running,
        [(what the step was doing, gap seconds)])."""
        inside = idle = 0.0
        gaps = []
        for s0, s1, admitted in self.steps:
            busy, g = self.busy(s0, s1)
            inside += s1 - s0
            idle += s1 - s0 - busy
            label = "admission" if admitted else "tick"
            gaps.extend((label, b - a) for a, b in g)
        return inside, idle, gaps

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for n, a, b in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.step_idle()[2], key=lambda g: -g[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[label, s] for label, s in gaps]}


def _device_events(prof) -> list[tuple[str, float, float]]:
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9))
    return out


class Tracer:
    """The load loop's hooks: opens and closes the profiler around whole
    ``step()`` calls.  ``bind`` gives it the loop's clock (seconds after
    the window opened)."""

    def __init__(self, *, start: float):
        self.start_at = start
        self.now = None
        self.prof = None
        self.t_open = self.t_close = None
        self.trace: Trace | None = None

    def bind(self, now) -> None:
        self.now = now

    def prepare(self) -> None:
        """Profile two markers once before the window: the profiler's first
        session loads and sets up its tracing, which took 1-5 s on an H100
        and would otherwise eat into the span."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            _marker()
            _marker()
            torch.cuda.synchronize()

    def _mark(self) -> float:
        """Launch a marker on an idle device; returns the host time of its
        launch."""
        torch.cuda.synchronize()
        t = self.now()
        _marker()
        torch.cuda.synchronize()
        return t

    def before_step(self, now: float) -> None:
        if self.prof is None and self.trace is None and now >= self.start_at:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t_open = self._mark()

    def close(self) -> None:
        if self.prof is None:
            return
        self.t_close = self._mark()
        self.prof.__exit__(None, None, None)
        events = _device_events(self.prof)
        self.prof = None
        spins = sorted(a for n, a, _ in events if "spin" in n)
        if len(spins) < 2:  # the markers are the first and last launches of the span
            spins = sorted(a for _, a, _ in events)
        off = spins[0] - self.t_open
        kernels = [(n, a - off, b - off) for n, a, b in events if "spin" not in n]
        self.trace = Trace(self.t_open, self.t_close, kernels, [])

    def finish(self, steps: list) -> Trace | None:
        """The trace, with the window's steps that lie inside its span."""
        if self.trace is not None:
            self.trace.steps = [s for s in steps
                                if s[0] >= self.trace.start and s[1] <= self.trace.end]
        return self.trace
