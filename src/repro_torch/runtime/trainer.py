"""Trainer: the end-to-end training loop (reference ``runtime/trainer.py``),
on one device or over a device mesh.

Streams in play per step:
  L1  host batch prefetch (``PrefetchIterator``: the next batches' H2D on
      the iterator's copy stream while the card runs the current step),
  L1' the checkpoint's device -> host snapshot, then its write on a worker
      thread while training goes on,
  L3  grad-accumulation micro-batch streaming inside the train step,
plus fault tolerance: supervised steps with retry (the step leaves the
state as it was when it raises before its commit), auto-resume from the
latest checkpoint, straggler logging.

With ``mesh=`` (a ``DeviceMesh`` over this process's group; every rank
runs its own Trainer) the params and AdamW moments are DTensors placed by
``sharding.param_specs``; every rank draws the same global batch from
``SyntheticLM`` (bit-equal to the reference's per (seed, step)) and keeps
its own rows (``sharding.local_batch``) before the copy to the card; the
losses are logged on rank 0 (every rank holds them); a restore re-meshes
the checkpoint onto the current mesh, whatever mesh wrote it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_from_paths, tree_paths
from repro_torch.data.pipeline import PrefetchIterator, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim import schedule as sched
from repro_torch.runtime.fault_tolerance import StepSupervisor


@dataclasses.dataclass
class TrainConfig:
    global_batch: int = 8
    seq_len: int = 128
    steps: int = 100
    accum: int = 1
    prefetch_depth: int = 2
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    lr: float = 3e-4
    warmup: int = 20


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        *,
        mesh: Any | None = None,
        log: Callable[[str], None] = print,
        device=None,
    ):
        if mesh is not None and not dist.is_initialized():
            raise RuntimeError("Trainer(mesh=...) needs the process group the mesh was built "
                               "over (launch.mesh.init_distributed)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        rank0 = mesh is None or dist.get_rank() == 0
        self.log = log if rank0 else (lambda _msg: None)
        self.device = resolve_device(device)
        self.supervisor = StepSupervisor()
        self.ckpt = (
            Checkpointer(tcfg.checkpoint_dir) if tcfg.checkpoint_dir else None)
        self.opt_cfg = adamw.AdamWConfig(
            lr=tcfg.lr,
            schedule=sched.warmup_cosine(tcfg.warmup, tcfg.steps))
        self._step_fn = steps_lib.make_train_step(cfg, self.opt_cfg, accum=tcfg.accum)
        self._torn = False  # a commit failed part way: the state is half-updated

    # -- state ----------------------------------------------------------------

    def init_state(self, seed: int) -> tuple[Any, Any]:
        """Params drawn from ``seed`` on the trainer's device, and zero
        AdamW state; on a mesh the draws (the same values) are kept on the
        host and each rank moves only its block of them to its card."""
        if self.mesh is None:
            params = T.init_params(self.cfg, seed, device=self.device)
        else:
            params = T.init_params(self.cfg, seed, device=self.device, store="cpu")
            params = sharding.distribute(params, self._param_specs(), self.mesh)
        return params, adamw.init_state(params, self.opt_cfg.moment_dtype)

    def _param_specs(self):
        """The params' spec tree on the trainer's mesh, from their shapes."""
        shapes = tree_paths(T.param_shapes(self.cfg))
        return sharding.param_specs(
            tree_from_paths([(p, torch.empty(s, device="meta")) for p, s in shapes]), self.mesh)

    def _source(self, start_step: int) -> PrefetchIterator:
        extra = {}
        if self.cfg.is_encoder_decoder:
            extra["enc_inputs"] = (
                (self.cfg.encoder_seq, self.cfg.d_model), np.float32)
        if self.cfg.prefix_len:
            extra["prefix_embeds"] = (
                (self.cfg.prefix_len, self.cfg.d_model), np.float32)
        src = iter(SyntheticLM(
            self.cfg.vocab_size, global_batch=self.tcfg.global_batch,
            seq_len=self.tcfg.seq_len, seed=self.tcfg.seed, extra=extra))
        if self.mesh is not None:  # this rank's rows, before the copy
            src = (sharding.local_batch(b, self.mesh, accum=self.tcfg.accum) for b in src)
        return PrefetchIterator(
            src, depth=self.tcfg.prefetch_depth, start_step=start_step, device=self.device)

    # -- loop -------------------------------------------------------------------

    def train(self) -> dict[str, Any]:
        """Run (or resume) the training loop.  Returns final metrics +
        history (``step_s``: each step's seconds, retries excluded)."""
        start_step = 0
        params = opt_state = None
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            (params, opt_state), meta = self._restore()
            start_step = meta["step"] + 1
            self.log(f"[trainer] resumed from step {meta['step']}")
        if params is None:
            params, opt_state = self.init_state(self.tcfg.seed)

        data = self._source(start_step)
        losses: list[float] = []
        t_start = time.perf_counter()
        try:
            for step in range(start_step, self.tcfg.steps):
                batch = next(data)
                if self.mesh is not None:
                    batch = sharding.from_local_batch(
                        batch, self.mesh, global_batch=self.tcfg.global_batch,
                        accum=self.tcfg.accum)

                def run(batch=batch):
                    nonlocal params, opt_state
                    if self._torn:
                        raise RuntimeError(
                            "a step's AdamW commit failed part way; the params are "
                            "half-updated: restore from the last checkpoint")
                    try:
                        params, opt_state, metrics = self._step_fn(params, opt_state, batch)
                    except adamw.CommitError:
                        self._torn = True
                        raise
                    metrics["loss"] = float(metrics["loss"])  # waits for the step
                    return metrics

                metrics = self.supervisor.run_step(step, run)
                losses.append(metrics["loss"])
                if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                    self.log(
                        f"[trainer] step {step:5d} loss {losses[-1]:.4f} "
                        f"gnorm {float(metrics['grad_norm']):.3f} "
                        f"lr {float(metrics['lr']):.2e}")
                if (self.ckpt is not None and self.tcfg.checkpoint_every
                        and (step + 1) % self.tcfg.checkpoint_every == 0):
                    self.ckpt.save(step, {"params": params, "opt": opt_state})
        finally:
            data.close()
        if self.ckpt is not None:
            self.ckpt.save(self.tcfg.steps - 1,
                           {"params": params, "opt": opt_state}, blocking=True)
        wall = time.perf_counter() - t_start
        return {
            "losses": losses,
            "final_loss": losses[-1] if losses else None,
            "params": params,
            "wall_s": wall,
            "step_s": [r.seconds for r in self.supervisor.history if r.ok],
            "supervisor": self.supervisor.straggler_report(),
        }

    def _restore(self):
        """The latest checkpoint; on a mesh, read on the host and each rank's
        block moved to its card (elastic re-mesh: any mesh may have saved it)."""
        if self.mesh is None:
            tree, meta = self.ckpt.restore(device=self.device)
        else:
            specs = self._param_specs()
            tree, meta = self.ckpt.restore(device="cpu", shardings=(
                self.mesh, {"params": specs, "opt": sharding.opt_state_specs(specs)}))
        return (tree["params"], tree["opt"]), meta
