"""Stream-safety analyzer of the port (the reference ``repro/analysis``):
static auditing of the serving stack, and a live audit on the card.

Three static passes and one live one, one CLI (``python -m
repro_torch.analysis`` / ``make lint-streams-torch``):

* **synccheck** — run every engine hot path (decode tick, spec verify,
  prefill chunk, page scatter / gather, for each servable arch x serving
  mode) on the CPU: under ``FakeTensorMode`` for data-dependent host reads,
  and once for real to take its footprint; audit the device-to-host traffic
  against the ``@transfer_budget`` declarations, lint the Python tick path
  for hidden syncs (``astlint``), and re-derive each path's paper
  dependency category from the footprint (cross-checked against
  ``tuning.workload``).  On a card it also drives every ``@tick_path``
  method under ``torch.cuda.set_sync_debug_mode("error")`` (the live audit).
* **kernelcheck** — hold every CUDA kernel's launch plan to the operands
  it must cover, the ctypes arity to the ``extern "C"`` entry, the paged
  entries' index operands to the launch, the quant dtype contract, and
  ``ops.* <-> ref.*`` oracle signature parity.
* **poolcheck** — the checkable invariant spec for ``BlockAllocator`` /
  ``PagedKVCache`` / ``PrefixRegistry``: a static audit of the mutation
  sites plus the runtime sanitizer behind ``REPRO_SANITIZE=1``.

Findings carry the reference's stable rule IDs (the catalog below, worded
for CUDA where the reference's is JAX-specific); known exceptions live in
the port's own waiver file (``analysis/waivers.json``), matched by rule +
target substring.  This module stays import-light: the passes are imported
lazily, so the runtime can use ``analysis.budget`` without cost.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from repro_torch.analysis.budget import (  # noqa: F401  (re-exported contract)
    TransferBudget, budget_of, host_fetch, sanctioned_sync, tick_path, transfer_budget)

#: The port's waiver file (never the reference's ``stream_waivers.json``).
WAIVERS = Path(__file__).resolve().parent / "waivers.json"

#: Stable rule catalog.  IDs never change meaning; new rules get new IDs.
RULES = {
    "STR001": "hidden host sync on a tick path (implicit D2H: int()/"
              "bool()/float()/.item()/.tolist()/.cpu(), branching on a "
              "device value, a data-dependent output shape, or a "
              "synchronizing CUDA call under the live audit)",
    "STR002": "transfer budget exceeded (more D2H arrays/bytes per tick "
              "than the @transfer_budget declaration, or more fetches than "
              "@tick_path(allowed_fetches=...))",
    "STR003": "tick-path step that is not a StepGraph (not captured in a "
              "CUDA graph)",
    "STR004": "SYNC-classified data re-staged H2D per tick (torch.as_tensor"
              " / torch.tensor / .to(device) / .cuda() of admission-time "
              "data; should be staged once per admission)",
    "STR005": "dependency category derived from the step's footprint "
              "disagrees with tuning.workload.classify_workload",
    "KRN001": "launch plan / grid not covering the operands (every row, "
              "key, page, tile or strip exactly once), or a ctypes arity "
              "that differs from the extern \"C\" entry",
    "KRN002": "index-bearing operand (page table, cur_len) missing from "
              "the arguments the wrapper hands to its launch",
    "KRN003": "quant kernel dtype contract broken against quant.py "
              "scale/code layouts",
    "KRN004": "ops.* wrapper signature diverges from its ref.* oracle",
    "POOL001": "refcount conservation violated (allocator refs != mapped "
               "pages + registry retentions)",
    "POOL002": "page aliasing / page-table row inconsistent with slot "
               "ownership (trash rows excepted)",
    "POOL003": "free-list corruption (duplicates, overlap with live "
               "refs, or leaked pages)",
    "POOL004": "unaudited pool mutation site (mutates protected state "
               "outside the sanitizer manifest)",
    "POOL005": "quant scales do not travel with their page (missing or "
               "mislaid scale leaves)",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding, addressable by (rule, target) for waivers."""

    rule: str
    target: str  # dotted path of the audited object, e.g. "transformer/paged:decode"
    message: str
    pass_name: str = ""  # "sync" | "kernel" | "pool"

    def to_dict(self) -> dict[str, str]:
        return {"rule": self.rule, "target": self.target,
                "message": self.message, "pass": self.pass_name}

    def __str__(self) -> str:  # the CLI's one-line rendering
        return f"{self.rule} [{self.target}] {self.message}"


def load_waivers(path: str | Path | None) -> list[dict[str, str]]:
    """Waiver file: ``{"waivers": [{"rule", "target", "reason"}]}``."""
    if path is None:
        return []
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return []
    waivers = data.get("waivers", [])
    for w in waivers:
        if "rule" not in w or "target" not in w:
            raise ValueError(f"waiver missing rule/target: {w!r}")
    return waivers


def apply_waivers(findings: list[Finding],
                  waivers: list[dict[str, str]]) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (unwaived, waived) by rule + target substring."""
    unwaived, waived = [], []
    for f in findings:
        if any(w["rule"] == f.rule and w["target"] in f.target for w in waivers):
            waived.append(f)
        else:
            unwaived.append(f)
    return unwaived, waived
