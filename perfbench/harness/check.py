"""The comparison that decides ``correct``.

Once the window has closed, ``memory_peak_bytes`` has been read and the
engine is freed, a sample of the requests the engine finished, drawn from
the seed with the one that served the most tokens always in it, is run
through the configuration's plain reference (prompt and served tokens,
one pass, layer by layer) on the same seeded weights.  Compared:

* ``max_gap``: the widest gap, over every served token of the sample, by
  which the reference's logit of the served token lies below the
  reference's best logit at that position (greedy serving: 0 up to
  rounding);
* ``short``: sampled requests that served another number of tokens than
  their ``max_new_tokens`` (exact: limit 0).

The control is the reference computed in float8 e4m3, put in the
program's place: at each served position of the same sample (the same
prompts and served tokens before it) the token that the float8 pass puts
first is judged in place of the served one, by the same numbers and the
same limits (``compare(..., control=True)``, ``judge``).  The benchmark's
runs do not compute it; ``perfbench/calibrate.py`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import traffic


def sample(win, *, seed: int, tokens: int, max_requests: int) -> list[tuple[np.ndarray, np.ndarray, int]]:
    """(prompt, served tokens, max_new) of the sampled finished requests:
    the one that served the most tokens (the longest prompt among ties),
    then others drawn from the seed until ``tokens`` served tokens or
    ``max_requests`` requests."""
    by_uid = {win.uid[i]: win.reqs[i] for i in win.uid}
    done = sorted(u for u in win.outputs if u in by_uid)
    if not done:
        return []
    first = max(done, key=lambda u: (len(win.outputs[u]), len(by_uid[u].prompt)))
    rest = [u for u in done if u != first]
    rest = [rest[i] for i in traffic.rng(seed, traffic.STREAM_SAMPLE).permutation(len(rest))]
    picked, served = [first], len(win.outputs[first])
    for u in rest:
        if served >= tokens or len(picked) >= max_requests:
            break
        picked.append(u)
        served += len(win.outputs[u])
    return [(by_uid[u].prompt, np.asarray(win.outputs[u]), by_uid[u].max_new) for u in picked]


def _reference_logits(ref, model: dict, params: dict, picked, device, fp8: bool):
    seqs = [np.concatenate([p, s[:-1]]).astype(np.int64) for p, s, _ in picked]
    return ref.logits(model, params, seqs, [len(p) - 1 for p, _, _ in picked],
                      device=device, fp8=fp8)


def compare(ref, model: dict, params: dict, picked, device, *, control: bool = False) -> dict:
    """The numbers compared: {"max_gap", "short", "tokens"}.  ``control``
    judges the float8 reference's first token at each served position in
    place of the served token."""
    exact = _reference_logits(ref, model, params, picked, device, fp8=False)
    judged = ([rows.argmax(dim=-1) for rows in
               _reference_logits(ref, model, params, picked, device, fp8=True)] if control
              else [torch.as_tensor(s, dtype=torch.long, device=rows.device)
                    for (_, s, _), rows in zip(picked, exact)])
    gaps = [(rows.max(dim=-1).values - rows.gather(1, idx[:, None].to(rows.device))[:, 0])
            .max().item() for rows, idx in zip(exact, judged)]
    return {"max_gap": max(gaps) if gaps else float("nan"),
            "short": sum(int(len(s) != m) for _, s, m in picked),
            "tokens": int(sum(len(s) for _, s, _ in picked))}


def judge(numbers: dict | None, limits: dict) -> tuple[dict, bool]:
    """(each number compared beside its limit, ``correct``).  ``None``
    numbers (no finished request to compare) are not correct."""
    compared = {k: {"value": None if numbers is None else numbers[k], "limit": limits[k]}
                for k in limits}
    return compared, numbers is not None and all(
        v["value"] <= v["limit"] for v in compared.values())
