"""The one traffic generator: a mix file's parameters to a list of requests.

A mix (``perfbench/traffic/<mix>.json``) names its loop and its length
distributions:

* ``"loop": "open"``: independent users; ``rate_per_s`` requests a second
  for the whole window, each due at a fixed time whether or not earlier
  ones have finished (Poisson gaps);
* ``"loop": "closed"``: ``clients`` callers, each sending its next request
  when its last one has finished; ``requests_per_client`` is a pool deep
  enough for any window;
* ``prompt_len`` / ``output_len``: ``{"dist": "lognormal", "median",
  "sigma", "min", "max"}`` (clipped) or ``{"dist": "uniform", "min",
  "max"}``; ``output_len`` is enforced by ``max_new_tokens``;
* token ids uniform over the configuration's vocabulary, no shared
  prefixes.

Every seed gets the same multiset of lengths and of gaps between
arrivals: the ``(i + 0.5) / n`` quantiles of each distribution.  The
arrival gaps and the prompt lengths come in one order for every seed (a
replayed trace, drawn once from a constant stream), so every seed offers
the same arrivals of the same prompts; the seed draws the token ids, the
order of the answer lengths and the weights.
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np

# Streams of one seed's generator, so that adding one leaves the others.
(STREAM_PROMPTS, STREAM_OUTPUTS, STREAM_GAPS, STREAM_TOKENS, STREAM_WARMUP,
 STREAM_SAMPLE) = range(1, 7)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` of ``seed`` (any non-negative integer)."""
    return np.random.default_rng([int(seed), stream])


@dataclasses.dataclass
class Req:
    index: int
    prompt: np.ndarray  # (L,) int32
    max_new: int
    due: float | None = None  # open loop: seconds after the window opens
    client: int | None = None  # closed loop: the caller that sends it


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The ``(i + 0.5) / n`` quantiles of a length distribution, as ints."""
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        vals = spec["min"] + q * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def gaps(rate: float, n: int, seconds: float) -> np.ndarray:
    """``n`` exponential gaps between arrivals (the quantiles of a Poisson
    process at ``rate``), scaled so that they sum to ``seconds``."""
    q = (np.arange(n) + 0.5) / n
    g = -np.log1p(-q) / rate
    return g * (seconds / g.sum())


TRACE_SEED = 0  # the seed of the replayed order of arrival gaps and prompt lengths


def order(seed: int, values: np.ndarray, stream: int) -> np.ndarray:
    """``values`` in the order that ``stream`` of ``seed`` draws."""
    return rng(seed, stream).permutation(values)


def n_requests(mix: dict, seconds: float) -> int:
    if mix["loop"] == "open":
        return max(1, int(round(mix["rate_per_s"] * seconds)))
    return mix["clients"] * mix["requests_per_client"]


def build(mix: dict, *, seed: int, seconds: float, vocab: int) -> list[Req]:
    """The requests of one run of ``mix`` under ``seed``."""
    n = n_requests(mix, seconds)
    plen = order(TRACE_SEED, quantiles(mix["prompt_len"], n), STREAM_PROMPTS)
    olen = order(seed, quantiles(mix["output_len"], n), STREAM_OUTPUTS)
    toks = rng(seed, STREAM_TOKENS)
    reqs = [Req(i, toks.integers(0, vocab, size=int(plen[i]), dtype=np.int32),
                int(olen[i])) for i in range(n)]
    if mix["loop"] == "open":
        g = order(TRACE_SEED, gaps(mix["rate_per_s"], n, seconds), STREAM_GAPS)
        due = np.concatenate([[0.0], np.cumsum(g)[:-1]])
        for r, d in zip(reqs, due):
            r.due = float(d)
    elif mix["loop"] == "closed":
        for r in reqs:
            r.client = r.index % mix["clients"]
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    return reqs


def warmup(spec: dict, *, seed: int, vocab: int) -> list[Req]:
    """The warm-up burst: ``requests`` prompts of ``prompt_len`` tokens
    (the mix's longest, so every full chunk's graph is captured) with
    ``max_new_tokens`` each, drawn from the seed's own stream."""
    g = rng(seed, STREAM_WARMUP)
    return [Req(i, g.integers(0, vocab, size=spec["prompt_len"], dtype=np.int32),
                spec["max_new_tokens"]) for i in range(spec["requests"])]

