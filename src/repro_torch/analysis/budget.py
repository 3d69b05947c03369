"""Transfer-budget and tick-path annotations: the analyzer's contract (the
port's copy of the reference ``analysis/budget.py``).

* :func:`transfer_budget` decorates a **step builder** (a method that
  returns an engine step, e.g. ``ServableModel.decode_fn``) with the
  device-to-host traffic the step is allowed per tick.  The engine checks
  each traced tick's fetched bytes against it (the live STR002 signal);
  the reference's analyzer also audits it statically.
* :func:`tick_path` decorates a **Python-level method** on the tick path
  (e.g. ``StreamedBatchEngine._plain_tick``) with how many sanctioned
  fetches it may perform.  The AST lint (``analysis.astlint``) counts
  :func:`host_fetch` calls against it and flags any implicit sync as
  STR001; on a card the live audit (``analysis.synccheck.LiveAudit``) runs
  each marked method under ``torch.cuda.set_sync_debug_mode("error")`` and
  counts the fetches each call makes.
* :func:`host_fetch` is the one sanctioned way to move a device tensor to
  the host on a tick path: one ``.cpu()`` that returns numpy.  Under a live
  audit it lowers the sync mode around that copy and counts it.
* :func:`sanctioned_sync` marks a deliberate synchronization that is not a
  fetch (a CUDA graph capture); a live audit lets it through and counts it.

numpy and torch only; nothing of the analyzer is imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch

BUDGET_ATTR = "__transfer_budget__"
TICK_ATTR = "__tick_path__"

#: The live audit in progress (``analysis.synccheck.LiveAudit``), or None.
_live: Any = None


@dataclasses.dataclass(frozen=True)
class TransferBudget:
    """Per-tick D2H allowance for one engine step.

    ``d2h_arrays``
        How many of the step's output arrays the host fetches per tick.
    ``d2h_outputs``
        Indices into the step's output tuple that the host actually
        fetches.
    ``d2h_bytes_per_slot``
        Byte budget per batch slot for the fetched outputs; an int, a
        callable ``scfg -> int`` (for budgets that scale with a config
        knob like ``spec_k``), or None for "arrays-only" budgets.
    """

    d2h_arrays: int = 0
    d2h_outputs: Tuple[int, ...] = ()
    d2h_bytes_per_slot: Any = None

    def bytes_limit(self, scfg: Any = None) -> int | None:
        b = self.d2h_bytes_per_slot
        return b(scfg) if callable(b) else b


def transfer_budget(*, d2h_arrays: int = 0, d2h_outputs=(),
                    d2h_bytes_per_slot=None) -> Callable:
    """Declare the per-tick D2H budget of the step a builder returns."""
    budget = TransferBudget(int(d2h_arrays), tuple(d2h_outputs),
                            d2h_bytes_per_slot)

    def deco(fn):
        setattr(fn, BUDGET_ATTR, budget)
        return fn

    return deco


def tick_path(fn=None, *, allowed_fetches: int = 0):
    """Mark a Python-level method as on the engine tick path, allowed
    ``allowed_fetches`` sanctioned fetches.  Usable bare (``@tick_path``)
    or parameterized."""

    def deco(f):
        setattr(f, TICK_ATTR, {"allowed_fetches": int(allowed_fetches)})
        return f

    return deco(fn) if fn is not None else deco


def budget_of(fn) -> TransferBudget | None:
    """The declared budget of a builder, seen through functools wrappers."""
    return getattr(fn, BUDGET_ATTR, None)


def host_fetch(x: torch.Tensor) -> np.ndarray:
    """The sanctioned D2H transfer on a tick path: one ``.cpu()`` of the
    device tensor ``x`` (it waits for the work that produces ``x``)."""
    if _live is not None:
        return _live.fetch(x)
    return x.cpu().numpy()


@contextlib.contextmanager
def sanctioned_sync(what: str) -> Iterator[None]:
    """A deliberate synchronization on a tick path (``what``: e.g.
    "capture"): a no-op unless a live audit runs, which lets it through and
    counts it under ``what``."""
    if _live is None:
        yield
        return
    with _live.sanction(what):
        yield
