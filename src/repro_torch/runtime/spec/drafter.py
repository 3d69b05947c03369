"""Draft-token proposers for speculative decode (the port's own copy of the
reference ``runtime/spec/drafter.py``).

A drafter is the cheap stage of the speculate/verify pipeline: given a
slot's context (prompt + generated tokens) it proposes up to ``k``
continuation tokens for the target model to score in one batched step.
The contract is ``propose(context, k) -> tokens``, so a learned draft model
can replace the model-free default without the engine noticing.

``NGramDrafter`` is prompt-lookup decoding: find the most recent earlier
occurrence of the context's trailing n-gram and propose the tokens that
followed it.  It costs no device work; a miss costs only the verify step,
never correctness, because rejected drafts roll back.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Drafter(Protocol):
    """Cheap proposal stage of speculative decode (host-side)."""

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` draft tokens continuing ``context`` (may be empty).
        ``context`` is the slot's prompt followed by everything it has
        generated; returning fewer than ``k`` tokens, or none, is safe."""
        ...


class NGramDrafter:
    """Model-free prompt-lookup drafter.

    Matches the longest trailing n-gram (``max_n`` down to 1) of the
    context against its earlier occurrences and proposes the continuation
    of the best match: among matches of one n-gram length the one with the
    longest available continuation wins, ties broken toward the most
    recent occurrence.
    """

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        self.max_n = max_n

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        context = np.asarray(context, np.int32).reshape(-1)
        n_ctx = len(context)
        if k < 1 or n_ctx < 2:
            return np.zeros(0, np.int32)
        for n in range(min(self.max_n, n_ctx - 1), 0, -1):
            pattern = context[-n:]
            # Windows over context[:-1]: a window starting at i covers
            # context[i : i + n] with i + n <= n_ctx - 1, so every match
            # has at least one continuation token.
            windows = np.lib.stride_tricks.sliding_window_view(context[:-1], n)
            hits = np.flatnonzero((windows == pattern[None]).all(axis=1))
            if hits.size == 0:
                continue
            best, best_len = -1, 0
            for i in hits[::-1]:  # most recent first (wins ties)
                cont = min(k, n_ctx - (int(i) + n))
                if cont > best_len:
                    best, best_len = int(i), cont
                if best_len == k:
                    break
            return context[best + n: best + n + k].astype(np.int32)
        return np.zeros(0, np.int32)
