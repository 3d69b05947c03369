"""Step-function factories (reference ``launch/steps.py``): the loss, the
train step with micro-batch gradient accumulation, on one device or over
a device mesh, the prefill and decode steps, the input shape builders and
a random batch.

Grad accumulation is Independent-task streaming (paper S4.2) over
micro-batches: each micro-batch's forward/backward is a task, and the
gradients are the reduction across tasks -- summed in f32 whatever the
param type, then divided by ``accum``, as the reference's scan sums them.
Each micro-batch's grads come from ``torch.autograd.grad`` (``.backward()``
would accumulate into ``.grad`` in the param type).

Over a mesh (params and moments DTensors placed by
``sharding.param_specs``, the batch by ``sharding.distribute_batch``) each
rank runs the same step on its own rows under ``meshutil.use_mesh``:
the model gathers each repeat's weights inside its remat region (FSDP),
keeps the tensor-parallel leaves' ``model`` shard, and the gradients come
back reduce-scattered onto the params' placements.  The ranks' losses sum
to the reference's, and so do their gradients.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_from_paths, tree_paths
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.models import meshutil
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
                    regather_specs: tuple[Any, Any] | None = None,
                    keep_grads: bool = False) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    The params and the optimizer state are updated in place (they are
    donated, as the reference's jit donates them), and only after the
    step's loss and gradients exist: a step that raises before its commit
    leaves both as they were, so ``StepSupervisor`` can rerun it
    (``adamw.CommitError`` if the commit itself fails).  Metrics: loss, ce,
    aux, grad_norm, lr (0-d tensors on the params' device); with
    ``keep_grads`` also "grads", the gradients the update used.

    Over a mesh: ``regather_specs=(full_specs, sharded_specs)`` (spec
    trees; with ``accum > 1``) gathers the params off ``data`` once a step
    (gather-once, ZeRO-2) instead of once a micro-batch, and reduce-scatters
    each micro-batch's gradient back onto ``sharded_specs``.  The metrics
    are the whole batch's, on every rank.
    """
    loss_fn = make_loss_fn(cfg)

    def grads_of(p_tree, leaves, batch, placed=None):
        """(loss, parts, grads): one pass, or ``accum`` micro-batches.  Over
        a mesh each pass's grads are reduced onto ``placed`` (the stored
        placements, a list in leaf order): what they still owe as sums
        over the batch axes, or, gathered once, over ``data`` too."""
        def pass_grads(l):
            gs = _grads(l, leaves)
            if placed is not None:
                gs = [g.redistribute(g.device_mesh, pl) for g, pl in zip(gs, placed)]
            return gs

        if accum <= 1:
            loss, parts = loss_fn(p_tree, batch)
            return loss, parts, pass_grads(loss)
        micro = {k: _split(v, accum) for k, v in batch.items()}
        gsum = lsum = auxsum = None
        for i in range(accum):
            l, parts = loss_fn(p_tree, {k: v[i] for k, v in micro.items()})
            gs = [g.float() for g in pass_grads(l)]
            if gsum is None:
                gsum = [torch.zeros_like(g) for g in gs]
            for acc, g in zip(gsum, gs):
                acc += g
            l, a = l.detach(), parts["aux"].detach()
            lsum = l if lsum is None else lsum + l
            auxsum = a if auxsum is None else auxsum + a
        loss = lsum / accum
        return loss, {"ce": loss, "aux": auxsum / accum}, [g / accum for g in gsum]

    def train_step(params, opt_state, batch):
        paths = tree_paths(params)
        if not isinstance(paths[0][1], DTensor):
            leaves = [p.requires_grad_(True) for _, p in paths]
            loss, parts, grads = grads_of(params, leaves, batch)
        else:
            mesh = paths[0][1].device_mesh
            local = {k: v.to_local() for k, v in batch.items()}
            placed = [tuple(p.placements) for _, p in paths]
            if regather_specs is not None and accum > 1:
                full, sharded = (dict(tree_paths(t)) for t in regather_specs)
                placed = [sharding.to_placements(sharded[path], mesh) for path, _ in paths]
                p_tree = tree_from_paths([
                    (path, p.detach().redistribute(
                        mesh, sharding.to_placements(full[path], mesh)).requires_grad_(True))
                    for path, p in paths])
                leaves = [p for _, p in tree_paths(p_tree)]
            else:
                p_tree, leaves = params, [p.requires_grad_(True) for _, p in paths]
            with _step_mesh(params, batch):
                loss, parts, grads = grads_of(p_tree, leaves, local, placed)
                loss = meshutil.batch_sum(loss)
                parts = {"ce": meshutil.batch_sum(parts["ce"]), "aux": parts["aux"]}
            del p_tree, leaves
        grad_tree = tree_from_paths([(path, g) for (path, _), g in zip(paths, grads)])
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grad_tree, opt_state)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), **om}
        if keep_grads:
            metrics["grads"] = grad_tree
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, max_seq: int) -> Callable:
    """prefill_step(params, batch) -> (last-token logits (B, 1, V), caches):
    the prompt in one chunk over fresh contiguous caches of ``max_seq``
    rows (reference ``T.prefill``).  Over a mesh the params are gathered
    (tensor-parallel leaves keep their share of heads, whose caches the
    rank then holds) and the batch is this rank's rows."""

    def prefill_step(params, batch):
        with _step_mesh(params, batch):
            p = T.gathered(params)
            local = {k: v.to_local() if isinstance(v, DTensor) else v for k, v in batch.items()}
            tokens = local["tokens"]
            ctx = meshutil.current()
            caches = local_cache(cfg, ctx.model_size if ctx else 1, tokens.shape[0], max_seq,
                                 device=tokens.device)
            enc_out = (T.encode(cfg, p, local["enc_inputs"]) if cfg.is_encoder_decoder
                       else None)
            return T.prefill_chunk(cfg, p, tokens, caches, 0, unembed=T.unembed_f32(cfg, p),
                                   enc_out=enc_out, prefix=local.get("prefix_embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, caches, tokens (B, 1), cur_len (B,)) -> (logits,
    caches) over contiguous caches (reference ``make_decode_step``); over
    a mesh the tokens and caches are this rank's rows."""

    def serve_step(params, caches, tokens, cur_len):
        with _step_mesh(params, {"tokens": tokens}):
            p = T.gathered(params)
            if isinstance(tokens, DTensor):
                tokens = tokens.to_local()
            return T.decode_step(cfg, p, tokens, caches, cur_len, unembed=T.unembed_f32(cfg, p))

    return serve_step


def _step_mesh(params, batch):
    """``meshutil.use_mesh`` over the params' mesh and the batch's axes, or
    a null context on one device."""
    first = tree_paths(params)[0][1]
    if not isinstance(first, DTensor):
        return contextlib.nullcontext()
    mesh = first.device_mesh
    tok = batch["tokens"]
    axes = (tuple(n for n, pl in zip(mesh.mesh_dim_names, tok.placements)
                  if isinstance(pl, Shard)) if isinstance(tok, DTensor) else ())
    return meshutil.use_mesh(mesh, batch_axes=axes)


def local_cfg(cfg: ModelConfig, model_size: int) -> ModelConfig:
    """``cfg`` with the heads a rank holds over a ``model`` axis of
    ``model_size``: its tensor-parallel share where ``meshutil.compute_dim``
    keeps the attention's shard (its caches then hold those KV heads)."""
    m = model_size
    if m > 1 and any(meshutil.compute_dim(cfg, s, "mixer", "wk", m) is not None
                     for s in cfg.layer_unit):
        return dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // m,
                                   n_heads=cfg.n_heads // m)
    return cfg


def local_cache(cfg: ModelConfig, model_size: int, bsz: int, max_seq: int, *,
                device) -> dict:
    """A rank's contiguous caches: ``bsz`` rows, and the self-attention KV
    heads of :func:`local_cfg`; the cross-attention K/V keep every head
    (that block is gathered whole)."""
    lcfg = local_cfg(cfg, model_size)
    caches = T.init_cache(lcfg, bsz, max_seq, device=device)
    if lcfg is not cfg:
        for c in caches["blocks"].values():
            for key in ("cross_k", "cross_v"):
                if key in c:
                    r, b, es, _, hd = c[key].shape
                    c[key] = c[key].new_zeros((r, b, es, cfg.n_kv_heads, hd))
    return caches


# ----------------------------------------------------------------------------
# Input shape builders (meta tensors for the dry run; arrays for running).
# ----------------------------------------------------------------------------


def batch_shapes(cfg: ModelConfig, *, global_batch: int, seq_len: int) -> dict:
    """Meta tensors for one training / prefill batch (the twin of the
    reference's ShapeDtypeStructs)."""
    meta = dict(device="meta")
    batch = {"tokens": torch.empty((global_batch, seq_len), dtype=torch.int32, **meta)}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = torch.empty((global_batch, cfg.encoder_seq, cfg.d_model),
                                          dtype=cfg.compute_dtype, **meta)
    if cfg.prefix_len > 0:
        batch["prefix_embeds"] = torch.empty((global_batch, cfg.prefix_len, cfg.d_model),
                                             dtype=cfg.compute_dtype, **meta)
    return batch


def decode_shapes(cfg: ModelConfig, *, global_batch: int, seq_len: int) -> tuple:
    """(cache shapes, token shape, cur_len shape) of a serve step, as meta
    tensors; ``cur_len`` is per slot, (B,), where the reference's is a
    scalar (the port's decode takes per-slot positions)."""
    with FakeTensorMode():  # shapes only: nothing is allocated
        fake = T.init_cache(cfg, global_batch, seq_len, device="cpu")
    cache = tree_from_paths([(path, torch.empty(t.shape, dtype=t.dtype, device="meta"))
                             for path, t in tree_paths(fake)])
    return (cache, torch.empty((global_batch, 1), dtype=torch.int32, device="meta"),
            torch.empty((global_batch,), dtype=torch.int32, device="meta"))


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
