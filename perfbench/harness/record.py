"""What a per-layer metric's reader is handed: one run's window, its trace
(``--trace 1``) and the configuration, with the helpers the readers share.
"""

from __future__ import annotations

import dataclasses
from types import ModuleType

from perfbench.counts import kernels, peaks
from perfbench.harness.loop import Window
from perfbench.harness.trace import Trace


@dataclasses.dataclass
class Record:
    win: Window
    trace: Trace | None
    model: dict  # the configuration's ``model`` block
    engine: dict  # the cell's engine settings
    counts: ModuleType  # perfbench/counts/<family>.py

    def delta(self, name: str) -> float:
        """A counter's change over the window."""
        return self.win.counters1.get(name, 0.0) - self.win.counters0.get(name, 0.0)

    def chunks(self, prompt_len: int) -> list[tuple[int, int]]:
        """The (length, first position) of each prefill chunk of a prompt:
        the engine's grid, anchored at 0."""
        c = min(self.engine["prefill_chunk"], prompt_len)
        return [(min(c, prompt_len - p), p) for p in range(0, prompt_len, c)]

    def admits(self, lo: float, hi: float) -> list[tuple[int, int, float, float]]:
        """The admissions that began and ended inside [lo, hi]."""
        return [a for a in self.win.admits if a[2] >= lo and a[3] <= hi]

    def ticks(self, lo: float, hi: float) -> list[list[int]]:
        """The contexts of the live rows of each decode tick stamped inside
        [lo, hi], one list a tick."""
        by_stamp: dict[float, list[int]] = {}
        for t, c in self.win.tick_rows:
            if lo <= t <= hi:
                by_stamp.setdefault(t, []).append(c)
        return list(by_stamp.values())

    def model_flops(self, lo: float, hi: float) -> float:
        """The model flops of the prompt tokens admitted and the tokens
        decoded inside [lo, hi]."""
        f = self.counts.flops
        total = 0.0
        for _, n_prompt, _, _ in self.admits(lo, hi):
            for n, p in self.chunks(n_prompt):
                total += f(self.model, tokens=n, keys=n * p + n * (n + 1) // 2, logit_rows=1)
        for ctxs in self.ticks(lo, hi):
            total += f(self.model, tokens=len(ctxs), keys=sum(ctxs), logit_rows=len(ctxs))
        return total

    def closed_steps(self) -> list[tuple[float, float, list]]:
        """The window's steps that ended before it closed."""
        return [s for s in self.win.steps if s[1] <= self.win.seconds]

    # Quantities that two per-layer metrics report, each for cells that
    # report another end-to-end metric (``metrics/<name>.chat.py`` and
    # ``.batch.py``).  Each returns None where it finds nothing to read.

    def admit_ms(self) -> float | None:
        """The engine's mean admission over the window: queue pop to first
        token, the chunked prefill with the decode ticks interleaved behind
        its chunks (the engine's own counters)."""
        n = self.delta("serving.admissions")
        return 1e3 * self.delta("serving.admit_seconds") / n if n else None

    def eager_step_share(self) -> float | None:
        """The share (%) of the window's step-graph runs that ran eagerly (a
        key's first use) rather than as a replay of a captured graph."""
        first, replays = self.delta("graphs.first_runs"), self.delta("graphs.replays")
        return 100.0 * first / (first + replays) if first + replays else None

    def mfu(self) -> float | None:
        """The model step's share (%) of the chip's bf16 peak: the model flops
        of every token the engine processed in the window's steps
        (``perfbench/counts``: attention at each token's real context, the
        vocabulary product only where logits are made) over the time inside
        those ``step()`` calls, over 989 TFLOP/s."""
        steps = self.closed_steps()
        busy = sum(b - a for a, b, _ in steps)
        if not busy:
            return None
        flops = self.model_flops(0.0, max(b for _, b, _ in steps))
        return 100.0 * flops / busy / peaks.BF16_FLOPS

    def gc_ms_per_s(self) -> float:
        """The milliseconds a second of the window in which Python's
        collector ran (its passes that began inside the window)."""
        w = self.win
        return 1e3 * sum(b - a for a, b in w.gc_passes if 0.0 <= a <= w.seconds) / w.seconds

    def step_idle_share(self) -> float | None:
        """The share (%) of the time inside the traced span's ``step()``
        calls in which no kernel ran on the device (the profiler's timeline
        against the load loop's step stamps)."""
        if self.trace is None:
            return None
        inside, idle, _ = self.trace.step_idle()
        return 100.0 * idle / inside if inside else None

    def flash_attention_roofline(self) -> float | None:
        """The prefill attention kernel's share (%) of its roofline in the
        traced span: the least time the chip could take for the chunks of
        the admissions inside the span (``counts/kernels.flash_chunk``, each
        layer once) over the device time of the kernel's bodies and their
        combine."""
        tr = self.trace
        if tr is None:
            return None
        dev = tr.kernel_seconds(lambda n: "flash_attention" in n or "combine_wg_splits" in n)
        layers = self.model["num_hidden_layers"]
        bound = sum(layers * peaks.bound_s(*kernels.flash_chunk(self.model, n, p))
                    for _, length, _, _ in self.admits(tr.start, tr.end)
                    for n, p in self.chunks(length))
        return 100.0 * bound / dev if dev and bound else None
