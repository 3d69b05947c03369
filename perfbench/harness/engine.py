"""The system under test: ``repro_torch``'s ``StreamedBatchEngine``, built
from a configuration file and a cell's engine settings, with host-clock
stamps taken from the benchmark's side.

:class:`Probe` adds observation only.  Each override calls the engine's
own method and records what it did:

* ``_admit``: the admission's start and end (the end is right after the
  first token's device-to-host read), so a request's TTFT and the prompt
  tokens prefilled in a window;
* ``_emitted``: each decoded token's stamp (the engine's own host clock
  after its tick's one device-to-host read) and the slot's context length,
  so the gaps between tokens and the shapes of each tick's attention.
"""

from __future__ import annotations

import dataclasses
import time

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def port_config(config: dict):
    """The port's ``ModelConfig`` as the configuration file states it:
    the registry's entry for ``port.arch`` with every field of
    ``port.fields`` set (dtypes by name)."""
    from repro_torch.configs import get_config

    fields = {k: DTYPES[v] if k.endswith("_dtype") else v
              for k, v in config["port"]["fields"].items()}
    return dataclasses.replace(get_config(config["port"]["arch"]), **fields)


def serve_config(engine: dict):
    """The engine's ``ServeConfig`` from a cell's ``engine`` settings."""
    from repro_torch.runtime.serving import ServeConfig

    return ServeConfig(**engine)


def make_probe(cfg, params, engine: dict, device):
    from repro_torch.runtime.serving import StreamedBatchEngine

    class Probe(StreamedBatchEngine):
        def __init__(self, *a, **kw):
            self.admits: list[tuple[int, int, float, float]] = []  # uid, L, start, end
            self.token_times: dict[int, list[float]] = {}  # uid -> stamp a token
            self.tick_rows: list[tuple[float, int]] = []  # (stamp, context) a decoded row
            super().__init__(*a, **kw)

        def _admit(self, req, slot):
            t0 = time.perf_counter()
            self.token_times[req.uid] = []
            super()._admit(req, slot)
            t1 = time.perf_counter()
            self.admits.append((req.uid, len(req.tokens), t0, t1))
            self.token_times[req.uid].insert(0, t1)

        def _emitted(self, s, n, t1):
            uid, cur = s.uid, s.cur
            super()._emitted(s, n, t1)
            self.token_times[uid].extend([t1] * n)
            self.tick_rows.append((t1, cur))

    return Probe(cfg, params, serve_config(engine), device=device)


def counters(engine) -> dict[str, float]:
    """The counters the per-layer metrics read: the engine's registry and
    its graphs' counts."""
    reg = engine.metrics
    out = {k: float(reg.value(k)) for k in reg.names()
           if isinstance(reg.value(k), (int, float))}
    g = engine.graphs
    out.update({"graphs.first_runs": float(g.first_runs), "graphs.captured": float(g.captured),
                "graphs.replays": float(g.replays)})
    return out
