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
and the step, as the reference's.

Over a device mesh (DTensor leaves) every rank runs its own process, where
the reference has one controller.  On the calling thread each leaf is
gathered to rank 0 alone: every rank whose block is no replica of a lower
coordinate's sends it to rank 0, which copies each block into its host
copy of the leaf as it arrives (one block in flight on its card; the other
ranks make no host copy).  Rank 0 writes on its worker thread, as above,
and the other ranks do not return from ``save`` before rank 0's ``DONE``
marker of this save exists (it holds a token rank 0 broadcasts, so an
earlier checkpoint of the same step does not count; a failed write leaves
``step_N.failed`` with the token, which they raise on; after
``DONE_TIMEOUT_S`` they raise).  The ranks must see one file system.
``restore(shardings=(mesh, specs))`` puts each leaf onto a mesh, which may
differ from the one that saved it (elastic re-mesh), as it is read: a rank
holds one full leaf at a time on the host, and moves only its block to
the mesh's device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.tree import tree_from_paths, tree_paths
from repro_torch.device import resolve_device
from repro_torch.launch import sharding

Params = dict

#: Stored as their bit pattern in an integer type numpy has.
_BITS = {torch.bfloat16: torch.int16}

#: Seconds a rank other than 0 waits for rank 0's write of a mesh save.
DONE_TIMEOUT_S = 1800.0


def _read(path: str) -> str:
    """A marker file's text ('' if it went away since it was seen)."""
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return ""


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _gather_to_rank0(t: DTensor) -> torch.Tensor | None:
    """The full leaf of ``t`` (shards and replicas over its mesh) on rank
    0's host; None on every other rank.  A rank sends its block when its
    coordinate is 0 on every mesh dim that replicates the leaf; rank 0
    receives the blocks in coordinate order and copies each into place."""
    mesh, local = t.device_mesh, t.to_local()
    rank = dist.get_rank()
    ranks = mesh.mesh.reshape(-1).tolist()
    replicated = [not p.is_shard() for p in t.placements]
    full = torch.empty(t.shape, dtype=t.dtype) if rank == 0 else None
    for coord, src in zip(np.ndindex(*mesh.mesh.shape), ranks):
        if any(c and rep for c, rep in zip(coord, replicated)):
            continue  # a replica of a lower coordinate's block
        if rank not in (0, src):
            continue
        if rank == src != 0:
            dist.send(local.contiguous(), dst=0)
            continue
        block = local
        if src != 0:
            block = torch.empty_like(local)
            dist.recv(block, src=src)
        view = full
        for d in range(t.dim()):
            dims = [i for i, p in enumerate(t.placements) if p.is_shard(d)]
            if dims:
                ways, idx = 1, 0
                for i in dims:  # major mesh dim first, as DTensor splits
                    ways, idx = ways * mesh.mesh.shape[i], idx * mesh.mesh.shape[i] + coord[i]
                n = t.shape[d] // ways
                view = view.narrow(d, idx * n, n)
        view.copy_(block)
    return full


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._ranks = 1  # processes that wait on the save in flight

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _failed(self, step: int) -> str:
        return self._step_dir(step) + ".failed"

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
        and moments in place while the worker thread writes.  A tree with
        DTensor leaves is gathered to rank 0's host; the other ranks get no
        arrays."""
        arrays, index = [], []
        leaves = [(path, torch.as_tensor(t).detach()) for path, t in tree_paths(tree)]
        writer = (not any(isinstance(t, DTensor) for _, t in leaves)
                  or dist.get_rank() == 0)
        for path, t in leaves:
            if isinstance(t, DTensor):
                host = _gather_to_rank0(t)
            else:
                host = t.to("cpu", copy=True) if writer else None
            index.append({"path": list(path), "dtype": _dtype_name(t.dtype)})
            if host is None:
                continue
            if t.dtype in _BITS:
                host = host.view(_BITS[t.dtype])
            arrays.append(host.numpy())
        return arrays, index

    def _write(self, step: int, arrays: list, index: list, meta: dict,
               token: str = "ok") -> None:
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
                f.write(token)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()
        except Exception as e:  # surfaced on the next wait()/save()
            self._error = e
            if self._ranks > 1:  # the other ranks wait for DONE: tell them
                with open(self._failed(step), "w") as f:
                    f.write(f"{token}\n{type(e).__name__}: {e}")

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, tree: Params, *, meta: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot to host (sync) then serialize on a worker thread (async).
        A tree of DTensors: each leaf is gathered to rank 0, which writes;
        the others return once rank 0's checkpoint is complete."""
        self.wait()  # one in-flight save at a time; raises previous errors
        sharded = any(isinstance(t, DTensor) for _, t in tree_paths(tree))
        self._ranks = dist.get_world_size() if sharded else 1
        token = "ok"
        if sharded:  # this save's token, from rank 0
            box = [f"ok {time.time_ns()} {os.getpid()}"]
            dist.broadcast_object_list(box, src=0)
            token = box[0]
        arrays, index = self._snapshot(tree)  # D2H stage (a gather to rank 0 on a mesh)
        if sharded and dist.get_rank() != 0:
            self._await_done(step, token)
            return
        meta = dict(meta or {}, step=step)
        self._thread = threading.Thread(
            target=self._write, args=(step, arrays, index, meta, token), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _await_done(self, step: int, token: str, poll_s: float = 0.01) -> None:
        """Block until rank 0 has published this save of ``step`` (or raise
        its error, or raise after ``DONE_TIMEOUT_S``)."""
        done = os.path.join(self._step_dir(step), "DONE")
        deadline = time.monotonic() + DONE_TIMEOUT_S
        while not (os.path.exists(done) and _read(done) == token):
            failed = self._failed(step)
            if os.path.exists(failed) and _read(failed).startswith(token + "\n"):
                raise RuntimeError(f"rank 0 failed to write step {step}: "
                                   f"{_read(failed)[len(token) + 1:]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank 0 did not publish step {step} within "
                                   f"{DONE_TIMEOUT_S:.0f} s")
            time.sleep(poll_s)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ---------------------------------------------------------------

    def restore(self, step: int | None = None, *, device=None,
                shardings: tuple | None = None) -> tuple[Params, dict]:
        """Load a checkpoint (the latest when ``step`` is None) as a tree of
        tensors of the saved types on ``device`` (the card unless
        ``device="cpu"``), and its meta.  ``shardings=(mesh, specs)`` (a
        ``launch.sharding`` spec tree matching the saved tree) puts each
        leaf onto ``mesh`` as a DTensor as it is read (read onto ``device``,
        then this rank's block moved to the mesh's device): a checkpoint
        written on one mesh restores onto another."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "tree.json")) as f:
            index = json.load(f)
        spec_of = None
        if shardings is not None:
            mesh, specs = shardings
            spec_of = dict(tree_paths(specs))
        pairs = []
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for i, entry in enumerate(index):
                dt = getattr(torch, entry["dtype"])
                t = torch.from_numpy(z[f"leaf_{i}"])
                if dt in _BITS:
                    t = t.view(dt)
                path = tuple(entry["path"])
                t = t.to(dev)
                if spec_of is not None:
                    t = sharding.place(t, spec_of[path], mesh)
                pairs.append((path, t))
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return tree_from_paths(pairs), meta
