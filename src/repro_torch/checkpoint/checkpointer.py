"""Fault-tolerant checkpointing: atomic, async (reference
``checkpoint/checkpointer.py``).

* **atomic**: write to ``step_N.tmp`` then rename, with a ``DONE`` marker
  written last -- a crash mid-save never corrupts the latest checkpoint,
  and ``steps`` never lists a ``.tmp`` directory;
* **async**: ``save`` takes a host snapshot on the calling thread (the
  device -> host copy; a copy of a CPU tensor too, so the caller may
  change the tree in place as soon as ``save`` returns), then serializes
  it on a worker thread, so the training loop goes on while the files are
  written; an error of the write surfaces on the next ``wait()`` or
  ``save()``;
* **auto-resume**: ``latest_step`` / ``restore`` pick up the newest
  complete checkpoint;
* retention: keep the last ``keep`` checkpoints.

The format is the port's own: ``arrays.npz`` holds the leaves as
``leaf_<i>`` and ``tree.json`` their key paths and types (the reference
pickles a JAX treedef instead, which the port cannot read).  numpy has no
bfloat16, so a bf16 leaf is stored as its 16-bit pattern (an ``int16``
view) and comes back bit-exact.  ``meta.json`` holds the caller's meta
and the step, as the reference's.  Re-sharding on restore (the
reference's ``shardings=``) comes with the mesh slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.tree import tree_from_paths, tree_paths
from repro_torch.device import resolve_device

Params = dict

#: Stored as their bit pattern in an integer type numpy has.
_BITS = {torch.bfloat16: torch.int16}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                marker = os.path.join(self.directory, name, "DONE")
                if os.path.exists(marker):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------

    @staticmethod
    def _snapshot(tree: Params) -> tuple[list[np.ndarray], list[dict]]:
        """The D2H stage: every leaf copied into a host numpy array (bf16 as
        its bit pattern), and the leaves' key paths and types.  The copy is
        made whatever the leaf's device: the training step updates params
        and moments in place while the worker thread writes."""
        arrays, index = [], []
        for path, t in tree_paths(tree):
            t = torch.as_tensor(t).detach()
            host = t.to("cpu", copy=True)
            if t.dtype in _BITS:
                host = host.view(_BITS[t.dtype])
            arrays.append(host.numpy())
            index.append({"path": list(path), "dtype": _dtype_name(t.dtype)})
        return arrays, index

    def _write(self, step: int, arrays: list, index: list, meta: dict) -> None:
        try:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(arrays)})
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump(index, f)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "DONE"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()
        except Exception as e:  # surfaced on the next wait()/save()
            self._error = e

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, tree: Params, *, meta: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot to host (sync) then serialize on a worker thread (async)."""
        self.wait()  # one in-flight save at a time; raises previous errors
        arrays, index = self._snapshot(tree)  # D2H stage
        meta = dict(meta or {}, step=step)
        self._thread = threading.Thread(
            target=self._write, args=(step, arrays, index, meta), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ---------------------------------------------------------------

    def restore(self, step: int | None = None, *, device=None) -> tuple[Params, dict]:
        """Load a checkpoint (the latest when ``step`` is None) as a tree of
        tensors of the saved types on ``device`` (the card unless
        ``device="cpu"``), and its meta."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "tree.json")) as f:
            index = json.load(f)
        pairs = []
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for i, entry in enumerate(index):
                dt = getattr(torch, entry["dtype"])
                t = torch.from_numpy(z[f"leaf_{i}"])
                if dt in _BITS:
                    t = t.view(dt)
                pairs.append((tuple(entry["path"]), t.to(dev)))
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return tree_from_paths(pairs), meta
