"""Step-function factories of the training path (reference
``launch/steps.py``): the loss, the train step with micro-batch
gradient accumulation, and a random batch.

Grad accumulation is Independent-task streaming (paper S4.2) over
micro-batches: each micro-batch's forward/backward is a task, and the
gradients are the reduction across tasks -- summed in f32 whatever the
param type, then divided by ``accum``, as the reference's scan sums them.
Each micro-batch's grads come from ``torch.autograd.grad`` (``.backward()``
would accumulate into ``.grad`` in the param type).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_from_paths, tree_paths
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

Params = dict


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch):
        return T.train_loss(cfg, params, batch)

    return loss_fn


def _grads(loss: torch.Tensor, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    """d loss / d leaf for every leaf; zeros for a leaf the loss does not
    reach (a padding expert), as ``jax.grad`` gives."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *, accum: int = 1,
                    keep_grads: bool = False) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    The params and the optimizer state are updated in place (they are
    donated, as the reference's jit donates them), and only after the
    step's loss and gradients exist: a step that raises before its commit
    leaves both as they were, so ``StepSupervisor`` can rerun it
    (``adamw.CommitError`` if the commit itself fails).  Metrics: loss, ce,
    aux, grad_norm, lr (0-d tensors on the params' device); with
    ``keep_grads`` also "grads", the gradients the update used.
    """
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        paths = tree_paths(params)
        leaves = [p.requires_grad_(True) for _, p in paths]
        if accum <= 1:
            loss, parts = loss_fn(params, batch)
            grads = _grads(loss, leaves)
        else:
            micro = {k: _split(v, accum) for k, v in batch.items()}
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            lsum = auxsum = None
            for i in range(accum):
                l, parts = loss_fn(params, {k: v[i] for k, v in micro.items()})
                for acc, g in zip(gsum, _grads(l, leaves)):
                    acc += g.float()
                l, a = l.detach(), parts["aux"].detach()
                lsum = l if lsum is None else lsum + l
                auxsum = a if auxsum is None else auxsum + a
            grads = [g / accum for g in gsum]
            loss = lsum / accum
            parts = {"ce": loss, "aux": auxsum / accum}
        grad_tree = tree_from_paths([(path, g) for (path, _), g in zip(paths, grads)])
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grad_tree, opt_state)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), **om}
        if keep_grads:
            metrics["grads"] = grad_tree
        return params, opt_state, metrics

    return train_step


def _split(x: torch.Tensor, accum: int) -> torch.Tensor:
    b = x.shape[0]
    if b % accum:
        raise ValueError(f"global batch {b} is not a multiple of accum {accum}")
    return x.reshape((accum, b // accum) + tuple(x.shape[1:]))


def make_batch(cfg: ModelConfig, generator: torch.Generator | int = 0, *, global_batch: int,
               seq_len: int, device=None) -> dict[str, torch.Tensor]:
    """A random batch (reference ``make_batch``): uniform tokens, and 0.1 x
    normal encoder frames / image embeddings in ``compute_dtype`` where the
    config has them; drawn from ``generator`` (or one seeded with it) on
    ``device``."""
    if isinstance(generator, torch.Generator):
        gen = generator
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(generator))
    dev = gen.device
    batch: dict[str, Any] = {"tokens": torch.randint(
        0, cfg.vocab_size, (global_batch, seq_len), generator=gen, device=dev,
        dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = 0.1 * torch.randn(
            (global_batch, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev
        ).to(cfg.compute_dtype)
    if cfg.prefix_len > 0:
        batch["prefix_embeds"] = 0.1 * torch.randn(
            (global_batch, cfg.prefix_len, cfg.d_model), generator=gen, device=dev
        ).to(cfg.compute_dtype)
    return batch
