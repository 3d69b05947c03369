"""Workload descriptors and their dependency-category classification.

A ``WorkloadDescriptor`` is the tuner's unit of generalization: two serving
runs with the same descriptor bucket are assumed to want the same knobs, so
tuned plans are cached per (platform, model, bucket) — see ``tuning.db``.

The classifier maps a descriptor onto the paper's five dependency
categories (§4.1, ``core.dependency``) by building the task graph the
serving engine actually executes:

  * one concurrent request, one prefill chunk  -> SYNC (nothing overlaps);
  * one request, many chunks                   -> TRUE_DEPENDENT (the
    chunked-prefill RAW chain through the KV cache — NW-style wavefront);
  * decode-dominated                           -> ITERATIVE (the decode
    kernel re-runs many times on device-resident KV per prefill task;
    overlapping only the prefill is negligible amortized) — *unless*
    speculative decode is enabled: speculation restructures the per-token
    RAW chain into verify chunks of ``spec_k + 1`` tokens, each reading
    the KV the previous chunk wrote, so the decode stream becomes the
    same TRUE_DEPENDENT chunked pipeline as chunked prefill (the paper's
    "restructure the dependence, then stream" move applied to its own
    non-streamable category);
  * concurrent requests, no shared data        -> INDEPENDENT;
  * a shared prompt prefix read by every task  -> SYNC by the paper's
    letter, but the engine applies the paper's own FALSE_DEPENDENT move
    (redundant per-admission transfer, or staged-once via the prefix
    registry), so the workload *reduces* to FALSE_DEPENDENT — unless the
    prefix dominates the prompt, the lavaMD regime (§5) where the shared
    bytes ~= the payload bytes and streaming the leftover tails loses.

Non-streamable categories short-circuit the tuner's chunk/interleave search
to the single-stream path (one-shot prefill, no interleaving).

The port's copy of the reference ``tuning/workload.py`` (it imports nothing
of it), built on the port's ``core.dependency``: the same descriptors, the
same synthetic prompts bit for bit (numpy's ``default_rng``), the same
categories.  Across the two packages compare categories by ``.value``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import dependency as dep

#: Shared-prefix fraction at or above which the prefix *dominates* the
#: transfer: redundant copy / staged-once tails leave nothing worth
#: streaming (the paper's lavaMD halo~=payload counterexample, §5).
SHARE_DOMINANT = 0.9

#: Model at most this many request tasks; category is invariant beyond it.
_MAX_MODEL_TASKS = 8


@dataclasses.dataclass(frozen=True)
class WorkloadDescriptor:
    """Shape of a serving workload, as the tuner generalizes over it.

    ``arrival`` distinguishes a closed batch ("batch": all requests present
    at t=0, drain to empty) from an open stream ("open": steady trickle);
    admission latency matters more for the latter.
    """

    prompt_len_mean: int
    prompt_len_max: int
    max_new_tokens: int
    n_requests: int
    shared_prefix_fraction: float = 0.0  # of prompt_len_mean, in [0, 1]
    arrival: str = "batch"  # "batch" | "open"

    def __post_init__(self) -> None:
        if self.prompt_len_mean < 1 or self.prompt_len_max < 1:
            raise ValueError(
                f"prompt lengths must be >= 1, got mean="
                f"{self.prompt_len_mean} max={self.prompt_len_max}")
        if self.prompt_len_max < self.prompt_len_mean:
            raise ValueError(
                f"prompt_len_max {self.prompt_len_max} < mean "
                f"{self.prompt_len_mean}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.n_requests < 1:
            raise ValueError(
                f"n_requests must be >= 1, got {self.n_requests}")
        if not 0.0 <= self.shared_prefix_fraction <= 1.0:
            raise ValueError(
                f"shared_prefix_fraction must be in [0, 1], got "
                f"{self.shared_prefix_fraction}")
        if self.arrival not in ("batch", "open"):
            raise ValueError(
                f"arrival must be 'batch' or 'open', got {self.arrival!r}")

    @property
    def shared_prefix_len(self) -> int:
        return int(round(self.shared_prefix_fraction * self.prompt_len_mean))

    @staticmethod
    def from_prompts(
        prompts: list[np.ndarray], *, max_new_tokens: int,
        arrival: str = "batch",
    ) -> "WorkloadDescriptor":
        """Describe a concrete request list (longest common prefix measured
        across all prompts — the registry's sharing opportunity)."""
        if not prompts:
            raise ValueError("need at least one prompt")
        lens = [len(p) for p in prompts]
        mean = max(1, int(round(float(np.mean(lens)))))
        shared = 0
        if len(prompts) > 1:
            limit = min(lens)
            first = np.asarray(prompts[0][:limit])
            agree = np.ones(limit, bool)
            for p in prompts[1:]:
                agree &= np.asarray(p[:limit]) == first
            shared = int(np.argmin(agree)) if not agree.all() else limit
        return WorkloadDescriptor(
            prompt_len_mean=mean, prompt_len_max=max(lens),
            max_new_tokens=max_new_tokens, n_requests=len(prompts),
            shared_prefix_fraction=min(1.0, shared / mean),
            arrival=arrival)

    # -- bucketing (the tuning-db key coarsening) -----------------------------

    def bucket(self) -> dict:
        """Coarsened descriptor: the tuning-db groups workloads whose knobs
        should agree.  Lengths snap to powers of two, the shared fraction to
        quarters, the request count to a small geometric ladder."""

        def pow2(n: int) -> int:
            return 1 << max(0, int(n - 1).bit_length())

        def ladder(n: int) -> int:
            for cap in (1, 2, 4, 8, 16):
                if n <= cap:
                    return cap
            return 32

        return {
            "prompt_mean": pow2(self.prompt_len_mean),
            "prompt_max": pow2(self.prompt_len_max),
            "new_tokens": pow2(self.max_new_tokens),
            "requests": ladder(self.n_requests),
            "shared": round(self.shared_prefix_fraction * 4) / 4,
            "arrival": self.arrival,
        }


def synth_prompts(
    desc: WorkloadDescriptor, *, vocab_size: int, seed: int = 0,
) -> list[np.ndarray]:
    """Deterministic synthetic request list matching ``desc``: lengths
    spread uniformly in [mean, max] (mean first, so a single-request probe
    is the mean), sharing the descriptor's common prefix."""
    rng = np.random.default_rng(seed)
    shared_len = desc.shared_prefix_len
    prefix = rng.integers(0, vocab_size, shared_len, dtype=np.int32)
    prompts = []
    for i in range(desc.n_requests):
        if desc.n_requests > 1:
            frac = i / (desc.n_requests - 1)
            length = int(round(desc.prompt_len_mean
                               + frac * (desc.prompt_len_max
                                         - desc.prompt_len_mean)))
        else:
            length = desc.prompt_len_mean
        # tail may be empty (shared_prefix_fraction = 1.0 covers the whole
        # mean-length prompt); the prompt length must match the descriptor
        # exactly, or a max_seq sized to prompt_len_max rejects the submit
        tail = rng.integers(
            0, vocab_size, max(0, length - shared_len), dtype=np.int32)
        prompts.append(np.concatenate([prefix, tail]).astype(np.int32))
    return prompts


def to_task_graph(
    desc: WorkloadDescriptor, *, prefill_chunk: int,
    prefix_staged: bool = False, spec_decode: bool = False, spec_k: int = 0,
    arch: str = "transformer",
) -> dep.Workload:
    """The dependency graph the serving engine executes for ``desc``.

    Concurrent requests are the tasks (Independent by default); a shared
    prompt prefix is a region every task reads; with ``prefix_staged`` (the
    prefix registry maps it once, or — mamba — a state snapshot stands in)
    it leaves the per-task read sets.  A single request decomposes into its
    prefill-chunk RAW chain instead.  ``kernel_iterations`` is the
    decode-steps-per-prefill-task ratio: when decode re-runs many times on
    resident state per prefill task, the workload is the paper's Iterative
    pattern.

    With ``spec_decode`` a decode-dominated workload stops being modeled as
    kernel re-runs on resident data: the engine executes verify *chunks* of
    ``spec_k + 1`` positions, each reading the KV the previous chunk wrote
    — a RAW chain of multi-token tasks, graphed exactly like the chunked
    prefill chain (and therefore TRUE_DEPENDENT / streamable).

    ``arch`` selects the per-architecture graph (model_iface taxonomy):

      * ``"transformer"`` / ``"prefix_lm"`` — the RAW carrier between
        prefill chunks is the KV cache;
      * ``"mamba"`` — the carrier is the O(1) recurrent state (the same
        TRUE_DEPENDENT chain, different region); speculation never
        applies (the engine rejects it — state is irreversible);
      * ``"whisper"`` — an ``encode`` task precedes the chain: a one-shot
        request is one sequential encode→decode stage (SYNC, the paper's
        staged transfer), a chunked one streams the decoder chain after
        the encode head, and decode-dominated batches are ITERATIVE.
    """
    if prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    if arch not in ("transformer", "mamba", "whisper", "prefix_lm"):
        raise ValueError(
            f"unknown arch {arch!r}; expected transformer | mamba | "
            "whisper | prefix_lm")
    n_chunks = -(-desc.prompt_len_mean // prefill_chunk)
    iters = max(1, round(desc.max_new_tokens / n_chunks))
    if (spec_decode and spec_k >= 1 and arch == "transformer"
            and iters >= dep.Workload.ITERATIVE_THRESHOLD):
        # Speculation turned the per-token chain into a chunked decode
        # stream: verify step t reads the pages step t-1 wrote (the same
        # RAW handoff as chunked prefill, at spec_k + 1 granularity).
        n_steps = -(-desc.max_new_tokens // (spec_k + 1))
        tasks = [dep.Task.make("verify0", reads=["kv[prompt]"],
                               writes=["kv[v0]"])]
        for t in range(1, min(n_steps, _MAX_MODEL_TASKS)):
            tasks.append(dep.Task.make(
                f"verify{t}", reads=[f"kv[v{t - 1}]"],
                writes=[f"kv[v{t}]"]))
        return dep.Workload("serve-spec-decode", tasks)
    if desc.n_requests == 1:
        head = []
        reads0 = ["prompt[0]"]
        if arch == "whisper":
            # The SYNC stage: the full encoder output must exist before
            # the decoder reads anything through cross-attention.
            head = [dep.Task.make("encode", reads=["audio[0]"],
                                  writes=["enc[0]"])]
            reads0.append("enc[0]")
        if n_chunks <= 1:
            tasks = head + [dep.Task.make("req0", reads=reads0,
                                          writes=["out[0]"])]
            return dep.Workload(
                "serve-single", tasks,
                sequential_kernel=arch == "whisper")
        # Chunked prefill: chunk t reads the carrier that chunk t-1 wrote
        # (the RAW handoff of §4.2) — NW-style True dependence,
        # streamable.  The carrier is the KV cache for attention archs and
        # the O(1) recurrent state for SSMs; whisper's chunks additionally
        # read the staged encoder output.
        carrier = "state" if arch == "mamba" else "kv"
        tasks = head + [dep.Task.make("chunk0", reads=reads0,
                                      writes=[f"{carrier}[0]"])]
        for t in range(1, min(n_chunks, _MAX_MODEL_TASKS)):
            reads = [f"prompt[{t}]", f"{carrier}[{t - 1}]"]
            if arch == "whisper":
                reads.append("enc[0]")
            tasks.append(dep.Task.make(
                f"chunk{t}", reads=reads, writes=[f"{carrier}[{t}]"]))
        return dep.Workload("serve-chunked-prefill", tasks)
    shared = desc.shared_prefix_fraction > 0.0 and not prefix_staged
    tasks = []
    for i in range(min(desc.n_requests, _MAX_MODEL_TASKS)):
        reads = {f"prompt[{i}]"}
        if shared:
            reads.add("prefix")
        tasks.append(dep.Task.make(f"req{i}", reads=reads,
                                   writes=[f"out[{i}]"]))
    return dep.Workload("serve-batch", tasks, kernel_iterations=iters)


def classify_workload(
    desc: WorkloadDescriptor, *, prefill_chunk: int,
    prefix_staged: bool = False, spec_decode: bool = False, spec_k: int = 0,
    arch: str = "transformer",
) -> dep.Category:
    """Map ``desc`` onto the paper's five categories (§4.1).

    A SYNC verdict from a *non-dominant* shared prefix is reduced to
    FALSE_DEPENDENT: the engine applies the paper's redundant-transfer move
    (each admission prefills its own prefix copy) or stages it once
    (``prefix_sharing``), so only a dominant prefix — the halo~=payload
    lavaMD regime — stays non-streamable.

    ``spec_decode``/``spec_k`` describe the engine's speculative multi-token
    decode: a decode-dominated workload that used to land in ITERATIVE (and
    short-circuit the tuner to the single-stream path) is re-graphed as the
    verify-chunk RAW chain and classifies TRUE_DEPENDENT — streamable, so
    the chunk/interleave/spec_k search actually runs for the most common
    serving regime (long generations, short prompts).

    ``arch`` maps per-architecture graphs onto the same categories (see
    ``to_task_graph``): SSM prefill is the TRUE_DEPENDENT RAW chain over
    recurrent state, whisper's encode is a SYNC stage and its decode the
    usual ITERATIVE chain — the paper's claim that streaming generalizes
    per *category*, not per application (§4).
    """
    cat = dep.classify(to_task_graph(
        desc, prefill_chunk=prefill_chunk, prefix_staged=prefix_staged,
        spec_decode=spec_decode, spec_k=spec_k, arch=arch))
    if (cat is dep.Category.SYNC and desc.n_requests > 1
            and 0.0 < desc.shared_prefix_fraction < SHARE_DOMINANT):
        return dep.Category.FALSE_DEPENDENT
    return cat


def crosscheck_category(
    derived: dep.Category, desc: WorkloadDescriptor, *,
    prefill_chunk: int, prefix_staged: bool = False,
    spec_decode: bool = False, spec_k: int = 0, arch: str = "transformer",
) -> tuple[dep.Category, bool]:
    """Analyzer hook (rule STR005): compare a category *derived from the
    engine's traced steps* (their footprints unrolled with
    ``core.dependency.unroll_stream``) against this classifier's prediction
    for the same descriptor.  Returns ``(expected, match)``; ``match`` is
    identity of the two members, so both must come from this package's
    ``Category``.

    A mismatch means the hand-modeled graphs in :func:`to_task_graph` no
    longer describe what the engine actually executes (e.g. a decode step
    stopped carrying the KV pages, or a "fused" prefill still stages a
    contiguous slab) — the classifier's category pins are a consequence of
    the traced code, not a hand-maintained assertion.
    """
    expected = classify_workload(
        desc, prefill_chunk=prefill_chunk, prefix_staged=prefix_staged,
        spec_decode=spec_decode, spec_k=spec_k, arch=arch)
    return expected, expected is derived
