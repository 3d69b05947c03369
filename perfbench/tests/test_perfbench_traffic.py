"""The traffic generator: reproducible from the seed, the same work for
every seed in another order, arrivals inside the window."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.harness import traffic

REPO = Path(__file__).resolve().parents[2]
MIXES = sorted(p.stem for p in (REPO / "perfbench/traffic").glob("*.json"))
SEED = 2**31 + 12345  # above 32 signed bits: seeds may be that large


def _mix(name):
    return json.loads((REPO / "perfbench/traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = traffic.build(_mix(name), seed=SEED, seconds=40, vocab=50280)
    b = traffic.build(_mix(name), seed=SEED, seconds=40, vocab=50280)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.due, x.client) == (y.max_new, y.due, y.client)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_work_in_another_order(name):
    """The same lengths and gaps for every seed; the gaps and prompt lengths
    in one order for every seed (a replayed trace), the answer lengths in
    the seed's; the seed draws the ids."""
    mix = _mix(name)
    a = traffic.build(mix, seed=SEED, seconds=40, vocab=92544)
    b = traffic.build(mix, seed=SEED + 1, seconds=40, vocab=92544)
    for fixed, get in ((True, lambda r: len(r.prompt)), (False, lambda r: r.max_new)):
        va, vb = [get(r) for r in a], [get(r) for r in b]
        assert sorted(va) == sorted(vb)
        assert (va == vb) == fixed
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])
    for r in a:
        assert mix["prompt_len"]["min"] <= len(r.prompt) <= mix["prompt_len"]["max"]
        assert mix["output_len"]["min"] <= r.max_new <= mix["output_len"]["max"]
        assert r.prompt.dtype == np.int32 and 0 <= r.prompt.min() and r.prompt.max() < 92544
    if mix["loop"] == "open":
        dues = [r.due for r in a]
        assert dues[0] == 0.0 and max(dues) < 40 and len(a) == round(mix["rate_per_s"] * 40)
        assert dues == [r.due for r in b]
        g = traffic.gaps(mix["rate_per_s"], len(a), 40)
        assert np.abs(np.diff(dues)[:, None] - g[None]).min(axis=1).max() < 1e-9
    else:
        assert {r.client for r in a} == set(range(mix["clients"]))


def test_the_trace_order_is_not_sorted_and_holds_for_any_window():
    """The replayed order is a shuffle, not the quantiles in order, and a
    window of another length replays its own trace from the same stream."""
    mix = _mix(MIXES[0])
    a = traffic.build(mix, seed=SEED, seconds=40, vocab=100)
    assert [len(r.prompt) for r in a] != sorted(len(r.prompt) for r in a)
    gaps = np.diff([r.due for r in a])
    assert list(gaps) != sorted(gaps)
    b = traffic.build(mix, seed=SEED + 7, seconds=20, vocab=100)
    assert [len(r.prompt) for r in b] == [len(r.prompt) for r in
                                          traffic.build(mix, seed=1, seconds=20, vocab=100)]


def test_open_loop_gaps_are_the_poisson_quantiles_summing_to_the_window():
    g = traffic.gaps(2.0, 80, 40.0)
    assert g.sum() == pytest.approx(40.0)
    assert np.all(np.diff(g) > 0)  # quantiles in order, before the seed's permutation
    assert g[len(g) // 2] / g.mean() == pytest.approx(np.log(2), rel=0.05)  # median / mean


def test_quantiles_of_a_clipped_lognormal():
    spec = {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 128, "max": 2048}
    q = traffic.quantiles(spec, 101)
    assert q[50] == 512 and q.min() >= 128 and q.max() == 2048
    assert list(q) == sorted(q)
    u = traffic.quantiles({"dist": "uniform", "min": 32, "max": 128}, 4)
    assert list(u) == [44, 68, 92, 116]


def test_warmup_is_the_longest_prompts_of_the_seed():
    w = traffic.warmup({"requests": 2, "prompt_len": 2048, "max_new_tokens": 4}, seed=SEED,
                       vocab=1000)
    assert [len(r.prompt) for r in w] == [2048, 2048] and [r.max_new for r in w] == [4, 4]
    assert not np.array_equal(w[0].prompt, w[1].prompt)
