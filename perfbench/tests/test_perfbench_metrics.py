"""The metric arithmetic on synthetic run records: the end-to-end metrics
from host stamps, the per-layer readers from counters and a timeline."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from perfbench.counts import kernels, peaks, transformer
from perfbench.harness import endtoend
from perfbench.harness.loop import DRAIN_LIMIT_S, Window
from perfbench.harness.manifest import load_module
from perfbench.harness.record import Record
from perfbench.harness.trace import Trace

REPO = Path(__file__).resolve().parents[2]
MODEL = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 512}


def reader(name):
    return load_module(REPO / "perfbench/metrics" / f"{name}.py").read


def window() -> Window:
    """Three requests in a 10 s window: uid 0 due 0 admitted over [0.5, 1.5]
    (100 prompt tokens) then tokens at 2, 3, 4; uid 1 due 8 admitted over
    [9, 11] (200 tokens, half inside) then a token at 12; uid 2 due 9.5
    never started."""
    w = Window(seconds=10.0, reqs=[])
    w.uid = {0: 0, 1: 1, 2: 2}
    w.due = {0: 0.0, 1: 8.0, 2: 9.5}
    w.submitted = {0: 0.0, 1: 8.25, 2: 9.75}
    w.admits = [(0, 100, 0.5, 1.5), (1, 200, 9.0, 11.0)]
    w.token_times = {0: [1.5, 2.0, 3.0, 4.0], 1: [11.0, 12.0]}
    w.tick_rows = [(2.0, 101), (3.0, 102), (4.0, 103)]
    w.steps = [(0.4, 1.6, [0]), (1.9, 2.0, []), (2.9, 3.0, []), (3.9, 4.0, []),
               (8.9, 11.1, [1])]
    w.counters0 = {"serving.decode_steps": 10.0, "time.tick_seconds": 1.0,
                   "serving.admissions": 2.0, "serving.admit_seconds": 0.5,
                   "graphs.first_runs": 5.0, "graphs.replays": 100.0}
    w.counters1 = {"serving.decode_steps": 13.0, "time.tick_seconds": 1.3,
                   "serving.admissions": 4.0, "serving.admit_seconds": 3.7,
                   "graphs.first_runs": 8.0, "graphs.replays": 109.0}
    return w


def test_tokens_per_s_counts_the_prompt_share_inside():
    w = window()
    assert endtoend.prompt_tokens_in(w) == pytest.approx(100 + 100)
    assert endtoend.served_in(w) == 4  # 1.5, 2, 3, 4
    assert endtoend.tokens_per_s(w) == pytest.approx(20.4)


def test_ttft_from_due_time_with_the_unstarted_waiting_until_the_drain_gives_up():
    w = window()
    assert endtoend.ttfts(w) == pytest.approx([1.5, 3.0, 10.0 + DRAIN_LIMIT_S - 9.5])
    assert endtoend.READERS["ttft_p90_ms"](w) == pytest.approx(
        1e3 * np.percentile([1.5, 3.0, 0.5 + DRAIN_LIMIT_S], 90))


def test_itl_gaps_inside_the_window_only():
    w = window()
    assert sorted(endtoend.itls(w)) == pytest.approx([0.5, 1.0, 1.0])
    assert endtoend.READERS["itl_mean_ms"](w) == pytest.approx(1e3 * 2.5 / 3)
    rec = Record(w, None, MODEL, {"prefill_chunk": 16}, transformer)
    assert reader("itl_p95_ms.chat")(rec) == pytest.approx(1e3 * np.percentile(
        [0.5, 1.0, 1.0], 95))


def test_counter_readers():
    rec = Record(window(), None, MODEL, {"prefill_chunk": 16}, transformer)
    assert reader("decode_tick_ms")(rec) == pytest.approx(100.0)
    assert reader("admit_ms.chat")(rec) == pytest.approx(1600.0)
    assert reader("eager_step_share.batch")(rec) == pytest.approx(25.0)
    assert reader("gen_lateness_ms")(rec) == pytest.approx(
        1e3 * np.percentile([0.0, 0.25, 0.25], 95))
    for name in ("paged_attention_roofline", "flash_attention_roofline.chat",
                 "step_idle_share.chat"):
        assert reader(name)(rec) is None  # nothing traced: nothing reported


def test_gc_reader_counts_the_passes_begun_inside_the_window():
    w = window()
    w.gc_passes = [(-0.5, -0.4), (1.0, 1.05), (9.99, 10.1), (10.5, 10.6)]
    rec = Record(w, None, MODEL, {"prefill_chunk": 16}, transformer)
    for kind in ("chat", "batch"):
        assert reader(f"gc_ms_per_s.{kind}")(rec) == pytest.approx(1e3 * (0.05 + 0.11) / 10)


def test_the_loop_stamps_the_collectors_passes_and_leaves_it_on():
    """A window whose steps make garbage and collect: each pass is stamped
    on the loop's clock, and the collector is as it was before and after."""
    import gc

    from perfbench.harness import loop

    class Engine:
        queue, outputs, pending = [], {}, True
        admits, token_times, tick_rows = [], {}, []
        metrics = type("Reg", (), {"names": lambda self: [], "value": lambda self, k: 0})()
        graphs = type("G", (), {"first_runs": 0, "captured": 0, "replays": 0})()

        def step(self):
            gc.collect()

    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]
    was = (gc.isenabled(), gc.get_freeze_count(), len(gc.callbacks))
    win = loop.run(Engine(), [], {"loop": "closed", "clients": 0}, 2.0, clock=clock)
    assert (gc.isenabled(), gc.get_freeze_count(), len(gc.callbacks)) == was
    assert len(win.gc_passes) >= 2
    assert all(0.0 < a < b for a, b in win.gc_passes)


def test_mfu_counts_the_closed_steps_work_over_their_time():
    rec = Record(window(), None, MODEL, {"prefill_chunk": 16}, transformer)
    f = transformer.flops
    prompt = sum(f(MODEL, tokens=n, keys=n * p + n * (n + 1) // 2, logit_rows=1)
                 for n, p in [(16, p) for p in range(0, 96, 16)] + [(4, 96)])
    ticks = sum(f(MODEL, tokens=1, keys=c, logit_rows=1) for c in (101, 102, 103))
    busy = 1.2 + 0.1 * 3  # the admission at [9, 11] does not close inside the window
    assert rec.chunks(100)[-1] == (4, 96)
    assert reader("mfu.chat")(rec) == pytest.approx(
        100 * (prompt + ticks) / busy / peaks.BF16_FLOPS)


def test_trace_readers_on_a_timeline():
    w = window()
    kern = [("paged_attention_split_kernel", 1.92, 1.95), ("combine_splits_kernel", 1.95, 1.96),
            ("flash_attention_wg_kernel", 0.6, 0.8), ("nvjet_gemm", 0.8, 1.4),
            ("paged_attention_split_kernel", 2.92, 2.97)]
    steps = [s for s in w.steps if s[0] >= 0.0 and s[1] <= 5.0]
    rec = Record(w, Trace(0.0, 5.0, kern, steps), MODEL, {"prefill_chunk": 16}, transformer)
    busy = 0.2 + 0.6 + 0.04 + 0.05
    inside = 1.2 + 0.3
    assert reader("step_idle_share.chat")(rec) == pytest.approx(100 * (inside - busy) / inside)
    bound = sum(2 * peaks.bound_s(*kernels.paged_decode(MODEL, [c])) for c in (101, 102, 103))
    assert reader("paged_attention_roofline")(rec) == pytest.approx(100 * bound / 0.09)
    fb = sum(2 * peaks.bound_s(*kernels.flash_chunk(MODEL, n, p)) for n, p in rec.chunks(100))
    assert reader("flash_attention_roofline.chat")(rec) == pytest.approx(100 * fb / 0.2)
    bd = rec.trace.breakdown()
    assert bd["device_ops"][0] == ["nvjet_gemm", pytest.approx(0.6)]
    assert bd["idle_gaps"][0][0] == "tick" or bd["idle_gaps"][0][1] <= 0.2 + 1e-9
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_busy_merges_overlaps_and_clips_to_the_span():
    t = Trace(0.0, 1.0, [("a", -0.5, 0.2), ("b", 0.1, 0.3), ("c", 0.5, 0.6), ("d", 0.9, 1.5)],
              [])
    busy, gaps = t.busy(0.0, 1.0)
    assert busy == pytest.approx(0.3 + 0.1 + 0.1)
    assert gaps == pytest.approx([(0.3, 0.5), (0.6, 0.9)])
