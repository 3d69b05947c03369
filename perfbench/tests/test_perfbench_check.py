"""The check that decides ``correct``, driven through whole runs of the
smoke cells on the CPU (the harness's look for a card skipped): a sound
run passes; the control (the reference in float8 e4m3 in the program's
place) is judged not correct by the same limits; and each fault a serving
cell can have, planted under the timed path, turns ``correct`` false.
The window runs on a stepped clock, so a run does the same work however
fast or loaded the CPU is.  Without a card the command exits non-zero and
prints no result."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench.harness import bench, check
from perfbench.tests import smoke

SEED = 2**33 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.build(tmp_path_factory.mktemp("bench"))


class StepClock:
    """The window's time: each reading advances it by ``dt`` seconds and a
    sleep by its length, whatever the wall clock does."""

    def __init__(self, dt: float = 0.005):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def run(root, cell, **kw):
    clock = StepClock()
    return bench.run_cell(root, cell, seed=SEED, seconds=1.5, trace=False,
                          t_start=time.perf_counter(), device="cpu", clock=clock,
                          sleep=clock.sleep, **kw)


@pytest.mark.parametrize("cell", ["i2-open", "m2-open"])
def test_sound_run_is_correct(root, cell):
    result, compared = run(root, cell)
    assert result["correct"] and result["attempted"] >= 10 and result["failed"] == 0
    assert compared["max_gap"]["value"] <= smoke.LIMITS["max_gap"]


@pytest.mark.parametrize("cell", ["i2-open", "m2-open"])
def test_the_control_reads_above_the_limit(root, cell):
    """The control judged on the run's own sample by the cell's limits:
    ``correct`` comes out false, from the same comparison as the run's."""
    result, compared = run(root, cell, control=True)
    assert result["correct"]
    ctl = result["control"]
    assert not ctl["correct"], ctl
    assert ctl["check"]["max_gap"]["value"] > 10 * smoke.LIMITS["max_gap"], ctl
    assert ctl["check"]["short"]["value"] == compared["short"]["value"] == 0


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: every pick is the next id."""
    from repro_torch.models import transformer as T

    orig = T.sample_tokens
    monkeypatch.setattr(T, "sample_tokens", lambda logits, **kw: (
        orig(logits, **kw) + 1) % logits.shape[-1])


def _unchanged_state(monkeypatch, cell):
    """A decode step that leaves its state as it found it: no K/V written
    to the pages, or the SSM state and conv tail handed back unchanged."""
    from repro_torch.models import attention, mamba

    if cell.startswith("i2"):
        monkeypatch.setattr(attention, "_paged_write", lambda *a, **k: None)
        return
    orig = mamba.mamba_apply

    def frozen(p, u, *, state=None, conv_state=None, decode=False, **kw):
        out, upd = orig(p, u, state=state, conv_state=conv_state, decode=decode, **kw)
        return out, ({"ssm": state.clone(), "conv": conv_state.clone()} if decode else upd)
    monkeypatch.setattr(mamba, "mamba_apply", frozen)


@pytest.mark.parametrize("fault", ["token", "state"])
@pytest.mark.parametrize("cell", ["i2-open", "m2-open"])
def test_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    if fault == "token":
        _alter_tokens(monkeypatch)
    else:
        _unchanged_state(monkeypatch, cell)
    result, compared = run(root, cell)
    assert not result["correct"], compared
    assert compared["max_gap"]["value"] > smoke.LIMITS["max_gap"]


def test_sample_keeps_the_longest_and_draws_the_rest_from_the_seed():
    from perfbench.harness.loop import Window
    from perfbench.harness.traffic import Req

    w = Window(seconds=1.0, reqs=[Req(i, torch.zeros(5 + i, dtype=torch.int32).numpy(), 9)
                                  for i in range(6)])
    w.uid = {i: 10 + i for i in range(6)}
    w.outputs = {10 + i: list(range(3 + (i == 2) * 6)) for i in range(6)}
    a = check.sample(w, seed=1, tokens=10, max_requests=4)
    assert len(a[0][1]) == 9 and len(a) == 2  # the longest, then one more reaches 10
    b = check.sample(w, seed=1, tokens=100, max_requests=4)
    assert len(b) == 4 and [len(p) for p, _, _ in b] == [len(p) for p, _, _ in
                                                          check.sample(w, seed=1, tokens=100,
                                                                       max_requests=4)]


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is for a machine without one")
    shutil.copytree(smoke.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(smoke.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for where in (smoke.REPO, tmp_path):  # the checkout, and the benchmark's files alone
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "internlm2-chat",
                            "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                           cwd=where, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == ""
