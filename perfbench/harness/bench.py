"""One run of one cell: set-up, the measured window, the metrics, the
check.  ``perfbench/run.py`` is its command line.

Set-up (``setup_s``, from the process's start to the window's): imports;
the kernel libraries (built by ``nvcc`` into the checkout's ``build/`` on
its first run there, loaded after); the weights drawn on the device from
``--seed``; the engine and its pool; a warm-up burst of the cell's
longest prompts under the seed's own stream, which captures the decode
tick's graph and every full prefill chunk's.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from perfbench.harness import check, endtoend, loop, traffic, weights
from perfbench.harness.engine import make_probe, port_config
from perfbench.harness.manifest import Manifest
from perfbench.harness.record import Record
from perfbench.harness.trace import Tracer


def _log(t_start: float, what: str) -> None:
    print(f"[perfbench] {time.perf_counter() - t_start:8.2f}s {what}", file=sys.stderr,
          flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Cell:
    """A cell set up: its files, the seeded weights and the warmed engine."""

    man: Manifest
    settings: dict
    config: dict
    mix: dict
    params: dict
    engine: object


def set_up(root, name: str, *, seed: int, t_start: float, device="cuda") -> Cell:
    man = Manifest(root)
    cell = man.cell(name)
    st = man.cell_settings(name)
    config = man.config(cell["config"])
    vocab = config["model"]["vocab_size"]
    cfg = port_config(config)
    _log(t_start, "imported")
    params = weights.make_params(cfg, seed, device)
    _sync(device)
    _log(t_start, "weights drawn")
    engine = make_probe(cfg, params, st["engine"], device)
    _sync(device)
    _log(t_start, "engine built")
    for r in traffic.warmup(st["warmup"], seed=seed, vocab=vocab):
        engine.submit(r.prompt, r.max_new)
    engine.run()
    _sync(device)
    _log(t_start, f"warmed up: {engine.graphs.captured} graphs captured")
    return Cell(man, st, config, man.traffic(cell["traffic"]), params, engine)


def run_cell(root, name: str, *, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", control: bool = False, clock=time.perf_counter,
             sleep=time.sleep) -> tuple[dict, dict]:
    """(the result line's object, the numbers compared with their limits).
    ``control`` also judges the control on the same sample, under the
    result's ``"control"`` key: ``correct`` and its numbers beside their
    limits.  ``clock`` and ``sleep`` are the window's time."""
    c = set_up(root, name, seed=seed, t_start=t_start, device=device)
    setup_s = time.perf_counter() - t_start
    man, st, model = c.man, c.settings, c.config["model"]
    reqs = traffic.build(c.mix, seed=seed, seconds=seconds, vocab=model["vocab_size"])
    tracer = None
    if trace:
        tracer = Tracer(start=max(0.0, seconds - st["trace_span_s"]))
        tracer.prepare()
    win = loop.run(c.engine, reqs, c.mix, seconds, tracer=tracer, clock=clock, sleep=sleep)
    _sync(device)
    d = {k: win.counters1.get(k, 0.0) - win.counters0.get(k, 0.0)
         for k in ("graphs.first_runs", "graphs.captured", "graphs.replays")}
    _log(t_start, f"window closed: {len(win.steps)} steps, {len(win.admits)} admissions, "
                  f"{len(win.outputs)} finished; graphs in the window: "
                  f"{d['graphs.first_runs']:.0f} first runs, {d['graphs.captured']:.0f} "
                  f"captured, {d['graphs.replays']:.0f} replays")
    ttft, itl = endtoend.ttfts(win), endtoend.itls(win)
    _log(t_start, "tails: " + " ".join(
        f"{k} {1e3 * endtoend.percentile(v, p):.3f}" for k, v, p in (
            ("ttft_p50_ms", ttft, 50), ("ttft_p90_ms", ttft, 90), ("itl_p50_ms", itl, 50),
            ("itl_p95_ms", itl, 95))) + f" gc_passes {len(win.gc_passes)} "
        f"gc_longest_ms {1e3 * max((b - a for a, b in win.gc_passes), default=0.0):.3f}")
    if tracer is not None and tracer.trace is not None:
        _log(t_start, f"traced span: {tracer.trace.start:.3f}-{tracer.trace.end:.3f} s "
                      f"of the window")
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    tr = tracer.finish(win.steps) if tracer else None
    rec = Record(win=win, trace=tr, model=model, engine=st["engine"],
                 counts=man.counts_module(c.config))

    metrics: dict[str, dict] = {}
    if trace:
        for m in man.per_layer(name):
            value = man.metric_module(m["name"]).read(rec)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            dev["busy_s"] = tr.busy(tr.start, tr.end)[0]
            dev["window_s"] = tr.window_s
    else:
        for m in man.end_to_end(name):
            value = setup_s if m["name"] == "setup_s" else endtoend.READERS[m["name"]](win)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The check runs on the weights alone: the engine's state goes first.
    params = c.params
    del c, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = man.reference_module(man.config(man.cell(name)["config"]))
    picked = check.sample(win, seed=seed, tokens=st["check"]["sample_tokens"],
                          max_requests=st["check"]["max_requests"])
    limits = st["check"]["limits"]
    # No finished request: nothing to compare, and not correct.
    numbers = check.compare(ref, model, params, picked, device) if picked else None
    compared, correct = check.judge(numbers, limits)
    _log(t_start, f"checked {len(picked)} requests, "
                  f"{numbers['tokens'] if numbers else 0} served tokens")
    due = [i for i, d in win.due.items() if d < seconds]
    result = {"correct": correct, "attempted": len(due),
              "failed": sum(1 for i in due if i in win.failed),
              "metrics": metrics, "device": dev}
    if control:
        c_numbers = (check.compare(ref, model, params, picked, device, control=True)
                     if picked else None)
        c_compared, c_correct = check.judge(c_numbers, limits)
        result["control"] = {"correct": c_correct, "check": c_compared}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    return result, compared
