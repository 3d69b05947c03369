"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics.  Everything that belongs to one cell, configuration, traffic mix
or per-layer metric sits in a file of its own under ``perfbench/``:

* ``workloads/<cell>.json``: the engine settings, the warm-up, the check's
  sample and its limits;
* ``configs/<config>.json``: the model as it is run (``model``: published
  key names, read by the reference and the counts; ``port``: the port's
  ``ModelConfig`` fields, read to build the engine);
* ``traffic/<mix>.json``: the generator's kind and parameters;
* ``metrics/<metric>.py``: one per-layer metric's reader;
* ``reference/<module>.py``: a configuration's plain reference, named by
  the configuration's ``reference`` key;
* ``counts/<family>.py``: a model family's flops per token, named by the
  configuration's ``family`` key.

So a later change adds a cell by adding files and an entry, and edits
none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = "perfbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json`` and the per-name files of one checkout."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR
        self.bench = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in self.bench['workloads']]}")

    def cell_settings(self, name: str) -> dict:
        return load_json(self.dir / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics ``cell`` reports (all, or those whose
        ``workloads`` name it)."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics ``cell`` reports: those whose ``workloads``
        name it, and those without the key whose ``moves`` the cell
        reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def metric_module(self, name: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{name}.py")

    def reference_module(self, config: dict) -> ModuleType:
        return load_module(self.dir / "reference" / f"{config['reference']}.py")

    def counts_module(self, config: dict) -> ModuleType:
        return load_module(self.dir / "counts" / f"{config['family']}.py")


def load_module(path: Path) -> ModuleType:
    """Import the file at ``path`` under a name made from its path (metric
    names hold dots, so they are not importable by name)."""
    path = Path(path).resolve()
    key = "perfbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
