"""Persistent on-disk tuning database: fingerprint -> ``TunedPlan``.

A tuned plan is only as good as its scope, so entries are keyed by a
fingerprint of everything the measurements depended on:

  * the platform: the tuned engine's device type ("cuda" / "cpu") and
    device name (``torch.cuda.get_device_name``) — the whole point of
    measured tuning is that knobs are machine-dependent;
  * the model configuration (every ``ModelConfig`` field, dtypes included);
  * the workload descriptor's *bucket* (``WorkloadDescriptor.bucket``) —
    coarse enough that near-identical workloads reuse a plan, fine enough
    that a decode-dominated and a prefill-dominated workload never share.

The store is a single JSON file (atomic tmp+rename writes) with a
versioned schema: a file or entry written by a different schema version is
ignored wholesale, so readers fall back to re-tuning instead of applying a
stale knob layout.  Entries are LRU-bounded (list order is the LRU order;
hits bump to the back).

The port's copy of the reference ``tuning/db.py``: the same schema, record
layout and fingerprint recipe (the model digest is the runtime's
``kv_cache._config_digest``, which hashes a config as the reference does),
so a file written by either package reads in the other.  Its default path
lies under ``<cache-dir>/repro_torch/``, so the two packages never write
one file unless told to.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Any

import torch

from repro_torch.core import rmetric
from repro_torch.device import resolve_device
from repro_torch.runtime.kv_cache import _config_digest
from repro_torch.tuning.workload import WorkloadDescriptor

#: Bump when TunedPlan's knob layout or the fingerprint recipe changes; a
#: mismatch makes readers re-tune instead of misapplying old records.
#: v2: speculative decode joined the knob layout (spec_decode mode flag +
#: tuned spec_k) — v1 records predate the verify step entirely.
#: v3: the serving mode grew the servable arch kind + state_snapshots
#: (model-agnostic engine) — v2 records were all implicitly transformer.
#: v4: kv_dtype joined the knob layout (quantized KV pages) and the
#: serving mode — v3 records were all implicitly fp32 pools, and applying
#: one would silently discard a tuned quantization choice.
SCHEMA_VERSION = 4

_DEFAULT_MAX_ENTRIES = 256


def default_db_path() -> pathlib.Path:
    """``$REPRO_TUNING_DB`` or ``<cache-dir>/repro_torch/tuning.json``."""
    env = os.environ.get("REPRO_TUNING_DB")
    if env:
        return pathlib.Path(env)
    cache = os.environ.get("XDG_CACHE_HOME")
    base = pathlib.Path(cache) if cache else pathlib.Path.home() / ".cache"
    return base / "repro_torch" / "tuning.json"


def serving_mode(scfg: Any) -> dict:
    """The base-config facts a plan's knobs silently assume: a plan tuned
    for an unpaged engine must never be applied to a paged one (and vice
    versa), so these join the fingerprint alongside the workload bucket."""
    return {
        "paged": bool(scfg.paged),
        "prefix_sharing": bool(scfg.prefix_sharing),
        "greedy": scfg.temperature == 0.0,
        "spec_decode": bool(getattr(scfg, "spec_decode", False)),
        # The servable arch changes what admission/decode actually execute
        # (SSM state chain, whisper SYNC encode), so knobs never cross it.
        # The model digest already separates archs; the explicit kind keeps
        # the mode readable and covers kind-specific flags.
        "arch": getattr(scfg, "arch_kind", None),
        "state_snapshots": bool(getattr(scfg, "state_snapshots", False)),
        # The base pool dtype changes both the parity contract (bitwise vs
        # tolerance) and every capacity measurement the knobs rest on.
        "kv_dtype": getattr(scfg, "kv_dtype", "fp32"),
    }


def fingerprint(
    cfg: Any, desc: WorkloadDescriptor, scfg: Any = None, *, device=None,
    backend: str | None = None, device_kind: str | None = None,
) -> str:
    """Tuning-db key for (platform, model, serving mode, workload bucket).
    The platform is ``device``'s (CUDA unless "cpu" is passed): ``backend``
    its type, ``device_kind`` its name; either can be given instead."""
    if backend is None or device_kind is None:
        dev = resolve_device(device)
        backend = backend or dev.type
        if device_kind is None:
            device_kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu")
    blob = json.dumps({
        "backend": backend,
        "device": device_kind,
        "model": _config_digest(cfg),
        "mode": serving_mode(scfg) if scfg is not None else None,
        "workload": desc.bucket(),
    }, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """A measured knob assignment, round-trippable into ``ServeConfig``.

    ``tokens_per_s``/``admit_ms`` are the winning candidate's measurements;
    ``baseline_tokens_per_s`` is the analytic warm-start's measurement on
    the identical workload — the tuned-vs-analytic A/B every future perf
    change can be judged against.

    ``paged_kernel`` keeps the reference's record layout: the port's paged
    path always decodes through its CUDA kernel, so the port's search
    records ``paged`` there and ``apply`` sets no such knob.
    """

    fingerprint: str
    # the tuned knobs
    prefill_chunk: int
    decode_interleave: int
    block_size: int
    num_blocks: int | None
    max_batch: int
    paged: bool
    paged_kernel: bool
    prefix_min_pages: int
    # provenance / measurements
    tokens_per_s: float
    admit_ms: float
    baseline_tokens_per_s: float
    baseline_admit_ms: float
    stage_times: tuple[float, float, float]  # calibrated (h2d, kex, d2h)
    decision: str  # the R-gate verdict the warm start was built from
    category: str  # dependency category of the workload (core.dependency)
    max_seq: int  # geometry the knobs were validated against
    spec_decode: bool = False  # mode flag: the knobs assume speculation
    spec_k: int = 4  # tuned draft length (decode-chunk granularity knob)
    kv_dtype: str = "fp32"  # tuned pool storage dtype: quantized pages
    # buy concurrent-slot capacity in the same HBM budget (kernels/quant)
    trials: int = 0  # measured candidates the search paid for
    source: str = "measured"  # "measured" | "analytic" (search short-cut)
    schema: int = SCHEMA_VERSION

    def __post_init__(self) -> None:
        for field in ("prefill_chunk", "decode_interleave", "block_size",
                      "max_batch", "prefix_min_pages", "max_seq", "spec_k"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"invalid plan: {field} must be >= 1, got "
                    f"{getattr(self, field)}")
        if self.paged and self.max_seq % self.block_size != 0:
            raise ValueError(
                f"invalid plan: block_size {self.block_size} does not tile "
                f"max_seq {self.max_seq}")
        if self.kv_dtype not in ("fp32", "int8", "fp8"):
            raise ValueError(
                f"invalid plan: unknown kv_dtype {self.kv_dtype!r}")
        if self.kv_dtype != "fp32" and not self.paged:
            raise ValueError(
                "invalid plan: quantized kv_dtype requires a paged pool")

    @property
    def measured_stage_times(self) -> rmetric.StageTimes:
        return rmetric.StageTimes(*self.stage_times)

    def jit_cache_caps(
        self, *, max_seq: int | None = None, block_size: int | None = None,
    ) -> tuple[int, int]:
        """(chunk-graph cap, page scatter/gather cap) sized to the tuned
        geometry: the chunk cache sees one entry per (len, first, pos0)
        along the tuned chunk grid, the page caches one per distinct
        admission/evict page count.  ``apply`` passes the *target* config's
        geometry when it differs from the one the plan was tuned for."""
        max_seq = self.max_seq if max_seq is None else max_seq
        block_size = self.block_size if block_size is None else block_size
        chunk_cap = max(8, 2 * (-(-max_seq // self.prefill_chunk)) + 2)
        page_cap = max(4, min(64, max_seq // block_size))
        return chunk_cap, page_cap

    def apply(self, scfg: Any) -> Any:
        """A new ``ServeConfig`` with this plan's knobs applied to ``scfg``.

        The base config keeps what is workload policy rather than a tuned
        knob (``max_seq``, ``max_new_tokens``, ``temperature``,
        ``prefix_sharing``).  Geometry knobs validated against a different
        ``max_seq`` than the base's are not trusted across it: a block size
        that does not tile the base cache keeps the base block size, and a
        tuned pool size (``num_blocks``) tuned for a shorter ``max_seq``
        could violate the engine's must-finish-alone progress guarantee for
        longer same-bucket requests, so it also falls back to the base's.
        The caps reach the engine's graph caches (``chunk_jit_cap``: the
        prefill chunk graphs, ``page_jit_cap``: the pool's page moves).
        """
        block = self.block_size
        num_blocks = self.num_blocks
        if self.paged and scfg.max_seq % block != 0:
            block, num_blocks = scfg.block_size, scfg.num_blocks
        if self.paged and self.max_seq != scfg.max_seq:
            num_blocks = scfg.num_blocks
        chunk_cap, page_cap = self.jit_cache_caps(
            max_seq=scfg.max_seq, block_size=block)
        return dataclasses.replace(
            scfg,
            prefill_chunk=self.prefill_chunk,
            decode_interleave=self.decode_interleave,
            max_batch=self.max_batch,
            paged=self.paged,
            block_size=block,
            num_blocks=num_blocks,
            prefix_min_pages=self.prefix_min_pages,
            spec_decode=self.spec_decode,
            spec_k=self.spec_k,
            kv_dtype=self.kv_dtype,
            chunk_jit_cap=chunk_cap,
            page_jit_cap=page_cap)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["stage_times"] = list(self.stage_times)
        return d

    @staticmethod
    def from_json(d: dict) -> "TunedPlan":
        known = {f.name for f in dataclasses.fields(TunedPlan)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["stage_times"] = tuple(kw.get("stage_times", (0.0, 0.0, 0.0)))
        return TunedPlan(**kw)


class TuningDB:
    """LRU-bounded JSON store of ``TunedPlan`` records.

    ``get`` returns None for unknown fingerprints *and* for records written
    by a different schema version — the caller's fallback is always the
    same: re-tune and ``put`` a fresh plan.
    """

    def __init__(
        self, path: str | os.PathLike | None = None, *,
        max_entries: int = _DEFAULT_MAX_ENTRIES,
    ):
        self.path = pathlib.Path(path) if path else default_db_path()
        self.max_entries = max_entries
        # fingerprint -> plan, insertion order == LRU order (oldest first)
        self._entries: "collections.OrderedDict[str, TunedPlan]" = (
            collections.OrderedDict())
        self._load()

    def __len__(self) -> int:
        return len(self._entries)

    def _load(self) -> None:
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return  # missing or corrupt file: start empty, re-tune
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            return  # schema mismatch: ignore wholesale, re-tune
        for rec in raw.get("entries", []):
            if rec.get("schema") != SCHEMA_VERSION:
                continue
            try:
                plan = TunedPlan.from_json(rec)
            except (TypeError, ValueError):
                continue  # malformed record: skip, re-tune on demand
            self._entries[plan.fingerprint] = plan

    def save(self) -> None:
        """Atomic write (tmp + rename) so a crashed writer never leaves a
        half-file for the next reader to trip on."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "schema": SCHEMA_VERSION,
            "entries": [p.to_json() for p in self._entries.values()],
        }
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
        os.replace(tmp, self.path)

    def get(self, fp: str) -> TunedPlan | None:
        plan = self._entries.get(fp)
        if plan is not None:
            self._entries.move_to_end(fp)  # LRU bump
        return plan

    def put(self, plan: TunedPlan, *, save: bool = True) -> None:
        self._entries[plan.fingerprint] = plan
        self._entries.move_to_end(plan.fingerprint)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        if save:
            self.save()
