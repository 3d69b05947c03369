"""Mixture-of-Experts FFN (reference ``models/moe.py``): top-k token-choice
routing with a per-expert capacity, the experts' swiglu products, and the
combine.

Routing is decided per batch: the sequence is cut into ``moe_chunk``
pieces, and in each piece all ``n_tok = B * chunk`` token rows (a decode
tick's idle slots and a verify block's padding included, as in the
reference) compete for ``capacity = max(1, ceil(n_tok * top_k *
capacity_factor / e))`` places per expert, ``e`` the routable expert count.
Priority is token order, then each token's k choices in descending gate
order; a choice past its expert's capacity is dropped (gate zeroed).

Two implementations, as the reference's: ``"gather"`` builds an (E_pad, C)
slot table of token ids and gathers the experts' inputs and outputs;
``"einsum"`` builds the (N, E, C) one-hot dispatch and combine tensors.
Both compute every stored expert at capacity C every call (dead padded
experts see only zero rows).  The slot table is written through one extra
dump entry that every dropped choice points at, so no shape depends on the
data: no boolean indexing, no ``nonzero``, no host read, and a decode tick
with its MoE layers can be captured in a CUDA graph.

Shared experts (qwen2-moe) add ``sigmoid(x @ shared_gate) * swiglu(x)``.
``expert_shards = s`` (mixtral) stores each expert as ``s`` virtual experts
of width F / s, (E * s, D, F / s), whose partial outputs sum.  The router
is stored in f32 whatever the parameter type.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers

Params = dict

__all__ = ["moe_shapes", "moe_init", "route_topk", "route_topk_indices", "moe_apply",
           "moe_ref_dense"]


def moe_shapes(*, d_model: int, d_ff: int, n_experts: int, n_shared_experts: int = 0,
               shared_d_ff: int | None = None, expert_shards: int = 1,
               n_experts_pad: int | None = None) -> dict:
    """The leaf shapes of :func:`moe_init` (the reference's pytree)."""
    if d_ff % expert_shards:
        raise ValueError(f"d_ff {d_ff} is not a multiple of expert_shards {expert_shards}")
    e_store = (n_experts_pad or n_experts) * expert_shards
    f_shard = d_ff // expert_shards
    out = {"router": (d_model, n_experts), "wi": (e_store, d_model, f_shard),
           "wg": (e_store, d_model, f_shard), "wo": (e_store, f_shard, d_model)}
    if n_shared_experts > 0:
        sd = shared_d_ff if shared_d_ff is not None else n_shared_experts * d_ff
        out["shared"] = {"wi": (d_model, sd), "wg": (d_model, sd), "wo": (sd, d_model)}
        out["shared_gate"] = (d_model, 1)
    return out


def moe_init(gen: torch.Generator, *, d_model: int, d_ff: int, n_experts: int,
             n_shared_experts: int = 0, shared_d_ff: int | None = None,
             dtype=torch.float32, expert_shards: int = 1,
             n_experts_pad: int | None = None) -> Params:
    """The reference's distributions: truncated normals at 1/sqrt(d_model)
    (router, wi, wg, shared gate) and 1/sqrt(d_ff) (wo); the router in f32."""
    shapes = moe_shapes(d_model=d_model, d_ff=d_ff, n_experts=n_experts,
                        n_shared_experts=n_shared_experts, shared_d_ff=shared_d_ff,
                        expert_shards=expert_shards, n_experts_pad=n_experts_pad)
    std = 1.0 / math.sqrt(d_model)
    p: Params = {
        "router": layers.dense_init(gen, shapes["router"], torch.float32, scale=std),
        "wi": layers.dense_init(gen, shapes["wi"], dtype, scale=std),
        "wg": layers.dense_init(gen, shapes["wg"], dtype, scale=std),
        "wo": layers.dense_init(gen, shapes["wo"], dtype, scale=1.0 / math.sqrt(d_ff)),
    }
    if "shared" in shapes:
        p["shared"] = layers.ffn_init(gen, d_model, shapes["shared"]["wi"][1], dtype,
                                      kind="swiglu")
        p["shared_gate"] = layers.dense_init(gen, shapes["shared_gate"], dtype, scale=std)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index >= n gives an
    all-zero row.  A comparison, where ``F.one_hot`` may check its indices
    on the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _select(router_logits: torch.Tensor, top_k: int):
    """Softmax, top-k (slots in descending gate order, as ``lax.top_k``),
    renormalized gates, each choice's position in its expert's queue, and
    the Switch aux loss."""
    n, e = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    expert_mask = _one_hot(gate_idx, e)  # (N, k, E)
    flat = expert_mask.reshape(n * top_k, e)
    pos = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1).reshape(n, top_k).long()
    frac_tokens = expert_mask.sum((0, 1)) / n
    aux = e * torch.sum(frac_tokens * probs.mean(0))
    return gate_idx, gate_vals, expert_mask, pos, aux


def route_topk(router_logits: torch.Tensor, *, top_k: int, capacity: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-hot routing: (dispatch (N, E, C), combine (N, E, C) gate-weighted,
    aux loss); overflowing choices are all-zero rows."""
    _, gate_vals, expert_mask, pos, aux = _select(router_logits, top_k)
    within = pos < capacity
    gate_vals = gate_vals * within.to(gate_vals.dtype)
    cap_onehot = _one_hot(pos, capacity)  # (N, k, C); overflow rows all-zero
    dispatch = torch.einsum("nke,nkc->nec", expert_mask, cap_onehot)
    combine = torch.einsum("nke,nkc,nk->nec", expert_mask, cap_onehot, gate_vals)
    return dispatch, combine, aux


def route_topk_indices(router_logits: torch.Tensor, *, top_k: int, capacity: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Index routing: (expert_idx (N, k) int32, pos_in_expert (N, k) int32,
    gates (N, k) with overflowing choices zeroed, aux loss)."""
    gate_idx, gate_vals, _, pos, aux = _select(router_logits, top_k)
    gate_vals = gate_vals * (pos < capacity).to(gate_vals.dtype)
    return gate_idx.to(torch.int32), pos.to(torch.int32), gate_vals, aux


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """swiglu of every stored expert over its (C, D) rows: (E, C, D)."""
    h = torch.nn.functional.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wi"])
    return torch.bmm(h, p["wo"])


def _chunk_gather(p: Params, tokens, logits, *, top_k, capacity, e_pad, shards):
    n_tok, d = tokens.shape
    eidx, pos, gates, aux = route_topk_indices(logits, top_k=top_k, capacity=capacity)
    ok = pos < capacity
    dump = e_pad * capacity  # the dump entry every dropped choice points at
    flat_idx = torch.where(ok, eidx.long() * capacity + pos.long(),
                           torch.full_like(pos, dump, dtype=torch.long))  # (N, k)
    # slot table (E_pad * C + 1,) -> token id; n_tok is the zero row
    slot_tok = torch.full((dump + 1,), n_tok, dtype=torch.long, device=tokens.device)
    tok_ids = torch.arange(n_tok, device=tokens.device)[:, None].expand(n_tok, top_k)
    slot_tok.scatter_(0, flat_idx.reshape(-1), tok_ids.reshape(-1))
    slot_tok = slot_tok[:dump].reshape(e_pad, capacity)
    tokens_pad = torch.cat([tokens, tokens.new_zeros((1, d))], dim=0)
    xe = tokens_pad[slot_tok]  # (E_pad, C, D)
    if shards > 1:
        xe = xe.repeat_interleave(shards, dim=0)  # each expert's rows for its shards
    ye = _experts(p, xe)
    if shards > 1:
        ye = ye.reshape(e_pad, shards, capacity, d).sum(dim=1)
    ye_pad = torch.cat([ye.reshape(e_pad * capacity, d), ye.new_zeros((1, d))], dim=0)
    picked = ye_pad[flat_idx]  # (N, k, D)
    return (picked * gates[..., None].to(picked.dtype)).sum(dim=1), aux


def _chunk_einsum(p: Params, tokens, logits, *, top_k, capacity):
    dispatch, combine, aux = route_topk(logits, top_k=top_k, capacity=capacity)
    xe = torch.einsum("nec,nd->ecd", dispatch.to(tokens.dtype), tokens)
    ye = _experts(p, xe)
    return torch.einsum("nec,ecd->nd", combine.to(ye.dtype), ye), aux


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              moe_chunk: int = 1024, impl: str = "gather", expert_shards: int = 1
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss: the mean over chunks).  The
    capacity follows from the shapes alone (Python ints), per chunk of
    ``min(moe_chunk, S)`` positions."""
    b, s, d = x.shape
    e = p["router"].shape[1]  # routable experts
    e_pad = p["wi"].shape[0] // expert_shards  # stored (padded) experts
    chunk = min(moe_chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} is not a multiple of the moe chunk {chunk}")
    n_chunks = s // chunk
    n_tok = b * chunk
    capacity = max(1, int(math.ceil(n_tok * top_k * capacity_factor / e)))
    if impl == "einsum" and expert_shards != 1:
        raise ValueError("the einsum impl predates expert shards")
    ys, aux_total = [], x.new_zeros((), dtype=torch.float32)
    for c in range(n_chunks):
        tokens = x[:, c * chunk:(c + 1) * chunk].reshape(n_tok, d)
        logits = tokens.float() @ p["router"].float()
        if impl == "einsum":
            y, aux = _chunk_einsum(p, tokens, logits, top_k=top_k, capacity=capacity)
        elif impl == "gather":
            y, aux = _chunk_gather(p, tokens, logits, top_k=top_k, capacity=capacity,
                                   e_pad=e_pad, shards=expert_shards)
        else:
            raise ValueError(f"unknown moe impl {impl}")
        if "shared" in p:
            gate = torch.sigmoid(tokens @ p["shared_gate"])
            y = y + gate * layers.ffn_apply(p["shared"], tokens, kind="swiglu")
        ys.append(y.reshape(b, chunk, d))
        aux_total = aux_total + aux
    return torch.cat(ys, dim=1), aux_total / n_chunks


def moe_ref_dense(p: Params, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """The dropless oracle: every token through its top-k experts, no
    capacity (tests bound the dispatch error with it)."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    logits = tokens.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    all_out = _experts(p, tokens[None].expand(p["wi"].shape[0], -1, -1))  # (E, N, D)
    sel = torch.take_along_dim(all_out.transpose(0, 1), gate_idx[..., None], dim=1)
    y = (sel * gate_vals[..., None].to(sel.dtype)).sum(1)
    if "shared" in p:
        gate = torch.sigmoid(tokens @ p["shared_gate"])
        y = y + gate * layers.ffn_apply(p["shared"], tokens, kind="swiglu")
    return y.reshape(b, s, d)
