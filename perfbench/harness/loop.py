"""The load loop: drives the engine through ``submit()`` and ``step()`` for
one measured window and keeps what it saw.

Open loop: each request is submitted once its due time has passed (the
engine is single-threaded, so a request that comes due during a long
``step()`` is submitted when it returns; how late is recorded), and the
loop sleeps when the engine has nothing to do.  Once the window has
closed no request is submitted, and the requests already due are run on
until each has its first token.  Closed loop: each client submits its
first request when the window opens and its next one when the last has
finished.

All times are ``time.perf_counter()`` seconds after the window opened.
"""

from __future__ import annotations

import dataclasses
import gc
import time

from perfbench.harness.engine import counters

DRAIN_LIMIT_S = 60.0  # how long past the close a due request may wait for its first token


@dataclasses.dataclass
class Window:
    seconds: float
    reqs: list  # traffic.Req, by index
    uid: dict = dataclasses.field(default_factory=dict)  # index -> engine uid
    due: dict = dataclasses.field(default_factory=dict)  # index -> due time
    submitted: dict = dataclasses.field(default_factory=dict)  # index -> submit time
    failed: set = dataclasses.field(default_factory=set)  # indexes refused or never started
    steps: list = dataclasses.field(default_factory=list)  # (start, end, admitted uids)
    outputs: dict = dataclasses.field(default_factory=dict)  # uid -> served tokens
    counters0: dict = dataclasses.field(default_factory=dict)
    counters1: dict = dataclasses.field(default_factory=dict)  # at the close
    admits: list = dataclasses.field(default_factory=list)  # (uid, L, start, end)
    token_times: dict = dataclasses.field(default_factory=dict)  # uid -> stamps
    tick_rows: list = dataclasses.field(default_factory=list)  # (stamp, context)
    gc_passes: list = dataclasses.field(default_factory=list)  # the collector's (start, end)


def _harvest(engine, win: Window) -> list[int]:
    done = list(engine.outputs)
    for uid in done:
        win.outputs[uid] = engine.outputs.pop(uid)
    return done


def _submit(engine, win: Window, r, now: float, due: float) -> None:
    win.due[r.index] = due
    win.submitted[r.index] = now
    try:
        win.uid[r.index] = engine.submit(r.prompt, r.max_new)
    except ValueError:
        win.failed.add(r.index)


def _step(engine, win: Window, clock, t0: float, tracer) -> float:
    queued = [q.uid for q in engine.queue]
    if tracer is not None:
        tracer.before_step(clock() - t0)
    s0 = clock() - t0
    engine.step()
    s1 = clock() - t0
    win.steps.append((s0, s1, queued[: len(queued) - len(engine.queue)]))
    return s1


def run(engine, reqs: list, mix: dict, seconds: float, *, tracer=None,
        clock=time.perf_counter, sleep=time.sleep) -> Window:
    """One measured window of ``seconds`` over ``reqs`` (``traffic.build``).
    ``clock`` and ``sleep`` are the loop's time (a test may step its own)."""
    win = Window(seconds=seconds, reqs=reqs)
    engine.admits.clear()
    engine.token_times.clear()
    engine.tick_rows.clear()
    win.counters0 = counters(engine)
    t0 = clock()
    if tracer is not None:
        tracer.bind(lambda: clock() - t0)
    began: list[float] = []

    def collector(phase: str, info: dict) -> None:
        # Observation only: the collector runs as the program leaves it.
        if phase == "start":
            began.append(clock() - t0)
        elif began:
            win.gc_passes.append((began.pop(), clock() - t0))
    gc.callbacks.append(collector)
    try:
        if mix["loop"] == "open":
            _open(engine, win, clock, sleep, t0, tracer)
        else:
            _closed(engine, win, mix["clients"], clock, t0, tracer)
    finally:
        gc.callbacks.remove(collector)
    # Stamps relative to the window's opening.
    win.admits = [(u, n, a - t0, b - t0) for u, n, a, b in engine.admits]
    win.token_times = {u: [t - t0 for t in ts] for u, ts in engine.token_times.items()}
    win.tick_rows = [(t - t0, c) for t, c in engine.tick_rows]
    return win


def _open(engine, win: Window, clock, sleep, t0: float, tracer) -> None:
    reqs = sorted(win.reqs, key=lambda r: r.due)
    i, n = 0, len(reqs)
    while True:
        now = clock() - t0
        while i < n and reqs[i].due <= now:
            _submit(engine, win, reqs[i], now, reqs[i].due)
            i += 1
        if now >= win.seconds:
            break
        if engine.pending:
            _step(engine, win, clock, t0, tracer)
            _harvest(engine, win)
        else:
            nxt = reqs[i].due if i < n else win.seconds
            sleep(max(0.0, min(nxt, win.seconds) - now))
    win.counters1 = counters(engine)
    if tracer is not None:
        tracer.close()
    # Run on until every due request has its first token.
    while any(not engine.token_times.get(u) for u in win.uid.values()):
        now = clock() - t0
        if now > win.seconds + DRAIN_LIMIT_S or not engine.pending:
            break
        _step(engine, win, clock, t0, None)
        _harvest(engine, win)
    for idx, u in win.uid.items():
        if not engine.token_times.get(u):
            win.failed.add(idx)


def _closed(engine, win: Window, clients: int, clock, t0: float, tracer) -> None:
    queues = [[r for r in win.reqs if r.client == c] for c in range(clients)]
    client_of: dict[int, int] = {}

    def send(c: int, now: float) -> None:
        if queues[c]:
            r = queues[c].pop(0)
            _submit(engine, win, r, now, now)
            if r.index in win.uid:
                client_of[win.uid[r.index]] = c
            else:
                send(c, now)
    for c in range(clients):
        send(c, 0.0)
    while True:
        now = clock() - t0
        if now >= win.seconds:
            break
        if not engine.pending:
            raise RuntimeError("closed loop: the request pool ran dry inside the window")
        now = _step(engine, win, clock, t0, tracer)
        for uid in _harvest(engine, win):
            send(client_of[uid], now)
    win.counters1 = counters(engine)
    if tracer is not None:
        tracer.close()

