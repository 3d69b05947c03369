"""Data pipeline with host-side multi-stream prefetch (reference
``data/pipeline.py``).

``PrefetchIterator`` is the paper's H2D/KEX overlap at the training-loop
level (level L1): a worker thread produces and transfers the next
``depth`` batches (the H2D stage) while the card runs the current step
(KEX).  ``depth=0`` is the single-stream, stage-by-stage execution: fetch
and transfer on the consumer's thread, then compute.

On the card the default transfer copies each array to pinned host memory
and then to the device with ``non_blocking=True`` on a copy stream the
iterator owns, from the worker thread, and records an event after the
copies.  The consumer's stream waits on that event before the batch is
handed out, and every tensor is marked as used on the consumer's stream
(``record_stream``), so that the step never reads a batch before its copy
lands and the allocator does not hand a batch's memory to a later copy
while the step still reads it.  On the CPU the arrays become tensors
(``torch.from_numpy``) and nothing waits.

The synthetic token source is deterministic per (seed, step), so a resumed
run sees the batches the interrupted one would have: its batches are
bit-equal to the reference's.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticLM:
    """Deterministic synthetic LM batches (tokens ~ Zipf-ish mixture)."""

    def __init__(
        self,
        vocab_size: int,
        *,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        extra: dict[str, tuple[tuple[int, ...], Any]] | None = None,
        work_ms: float = 0.0,
    ):
        self.vocab_size = vocab_size
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.extra = extra or {}
        self.work_ms = work_ms  # simulated host preprocessing cost

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        if self.work_ms > 0:  # simulate tokenization / decoding cost
            t_end = time.perf_counter() + self.work_ms / 1e3
            while time.perf_counter() < t_end:
                pass
        # mixture of a low-entropy head and uniform tail, roughly zipfian
        head = rng.integers(0, max(2, self.vocab_size // 64),
                            size=(self.global_batch, self.seq_len))
        tail = rng.integers(0, self.vocab_size,
                            size=(self.global_batch, self.seq_len))
        pick = rng.random((self.global_batch, self.seq_len)) < 0.7
        batch = {"tokens": np.where(pick, head, tail).astype(np.int32)}
        for name, (shape, dtype) in self.extra.items():
            batch[name] = (0.1 * rng.standard_normal(
                (self.global_batch,) + tuple(shape))).astype(dtype)
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class _Staged:
    """A batch whose H2D copies were issued on the iterator's copy stream,
    with the event recorded after them."""

    def __init__(self, batch: dict[str, torch.Tensor], event: torch.cuda.Event):
        self.batch = batch
        self.event = event


class PrefetchIterator:
    """Multi-stream host->device prefetch (the paper's pipeline).

    A worker thread fetches and transfers up to ``depth`` upcoming batches
    while the consumer computes: H2D(t+1..t+depth) overlaps KEX(t).
    ``put`` replaces the default transfer (its result is handed out as
    it is); ``start_step`` skips the batches a run consumed before a
    restart.  Runs on the card unless ``device="cpu"``.
    """

    def __init__(
        self,
        source: Iterator[dict[str, np.ndarray]],
        *,
        depth: int = 2,
        put: Callable[[Any], Any] | None = None,
        start_step: int = 0,
        device=None,
    ):
        self.source = source
        self.depth = max(0, depth)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread sets the consumer's card as its own
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.put = put if put is not None else self._to_device
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, self.depth))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._started = False
        self._error: BaseException | None = None
        # skip batches consumed before a restart (deterministic resume)
        for _ in range(start_step):
            next(self.source)

    def _to_device(self, batch: dict[str, np.ndarray]):
        """The default H2D stage: tensors on the CPU; on the card pinned
        copies issued on the copy stream, handed out as ``_Staged``."""
        if self._copy_stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        with torch.cuda.stream(self._copy_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return _Staged(out, event)

    def _ready(self, item):
        """Order the consumer's stream after the batch's copies."""
        if not isinstance(item, _Staged):
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.event)
        for t in item.batch.values():
            t.record_stream(stream)
        return item.batch

    def _worker(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            for batch in self.source:
                if self._stop.is_set():
                    return
                self._q.put(self.put(batch))  # the H2D stage of this stream
        except StopIteration:
            pass
        except BaseException as e:  # raised to the consumer at its next batch
            self._error = e
        finally:
            if not self._stop.is_set():
                self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self.depth == 0:  # single-stream: fetch + transfer synchronously
            return self._ready(self.put(next(self.source)))
        if not self._started:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
            self._started = True
        item = self._q.get()
        if item is None:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return self._ready(item)

    def close(self) -> None:
        """Stop the worker: drain the queue so a blocked put returns, then
        wait for the thread (it ends after at most one more batch)."""
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                while not self._q.empty():
                    self._q.get_nowait()
                self._thread.join(timeout=0.01)
            self._thread = None
