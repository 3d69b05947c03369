"""The batched verify step of speculative decode, on the device.

One target step scores ``k + 1`` positions per slot — the pending token
plus up to ``k`` draft tokens — through
``transformer.decode_step_multi_paged`` or, over a contiguous cache,
``transformer.decode_step_multi`` (causal masking inside the block),
then applies the acceptance rule on the device:

* **greedy**: accept the longest prefix of the draft that matches the
  target argmax chain; the position after it emits the target's own argmax
  (the bonus token).  By induction this emits exactly the tokens plain
  greedy decode would.
* **temperature** (``verify_sampled``): rejection sampling with the
  drafter's point-mass proposal: draft token ``d_i`` is accepted with
  probability ``p(d_i)``; at a rejection the emitted token is drawn from
  the residual (``p`` with ``d_i`` masked), and full acceptance ends in a
  fresh draw at the bonus position.  Every emitted token is marginally a
  sample of the target.  The draws come from the request's own streams
  (``runtime.sampling``), the accept draws and the sample draws from
  separate tags.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.runtime import sampling

NEG_INF = -1e30  # the reference's residual mask value


def greedy_accept(
    target: torch.Tensor,  # (B, T) int32: target argmax per position
    draft: torch.Tensor,  # (B, T-1) int32: proposed draft tokens
    d_len: torch.Tensor,  # (B,) int32: live draft length per slot (0..T-1)
) -> torch.Tensor:
    """Longest accepted prefix per slot: the number of leading positions
    where the draft equals the target argmax, capped at ``d_len`` -> (B,)
    int32."""
    idx = torch.arange(draft.shape[1], device=draft.device)[None, :]
    match = (draft == target[:, :-1]) & (idx < d_len[:, None])
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def verify_greedy(
    logits: torch.Tensor,  # (B, T, V) f32 target logits
    draft: torch.Tensor,  # (B, T-1) int32
    d_len: torch.Tensor,  # (B,) int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (emit (B, T) int32, n_accept (B,) int32):
    ``emit[b, :n_accept[b] + 1]`` are the tokens slot b produces this tick
    — the accepted draft prefix (equal to the target argmax there) and the
    bonus token."""
    target = T.sample_tokens(logits)
    return target, greedy_accept(target, draft, d_len)


def _pos_keys(uids: torch.Tensor, steps: torch.Tensor, t: int, tag: int) -> torch.Tensor:
    """(B, t) stream keys: slot b's position i draws from its request's
    stream at step ``steps[b] + i``, under ``tag``."""
    pos = steps.long()[:, None] + torch.arange(t, device=steps.device)[None, :]
    return sampling.stream_keys(uids[:, None], pos, tag=tag)


def verify_sampled(
    logits: torch.Tensor,  # (B, T, V) f32 target logits
    draft: torch.Tensor,  # (B, T-1) int32
    d_len: torch.Tensor,  # (B,) int32
    uids: torch.Tensor,  # (B,) int32 request uids (stream identity)
    steps: torch.Tensor,  # (B,) int32 tokens emitted so far per slot
    temperature: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Temperature acceptance with a point-mass proposal (reference
    ``spec.verify_sampled``): accept ``d_i`` with probability ``p(d_i)``
    (tag 1's uniform below it); at the stopping position emit a draw from
    the residual, ``p`` with the rejected token masked, or after full
    acceptance a fresh draw from ``p`` at the bonus position (tag 2's
    Gumbel noise, shared by both draws of a position, as the reference
    shares its key).  Returns (emit (B, T) int32, n_accept (B,) int32)."""
    b, t, v = logits.shape
    scaled = logits.float() / temperature
    p = torch.softmax(scaled, dim=-1)
    idx = torch.arange(t - 1, device=logits.device)[None, :]
    p_draft = p[:, :-1].gather(-1, draft.long()[..., None])[..., 0]
    u = sampling.uniforms(_pos_keys(uids, steps, t - 1, tag=1), 1)[..., 0]  # (B, T-1)
    accept = (u < p_draft) & (idx < d_len[:, None])
    n_accept = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)

    g = sampling.gumbel(_pos_keys(uids, steps, t, tag=2), v)
    full = torch.argmax(scaled + g, dim=-1).to(torch.int32)  # (B, T)
    hot = torch.zeros_like(scaled[:, :-1], dtype=torch.bool).scatter_(
        -1, draft.long()[..., None], True)
    resid = torch.argmax(torch.where(hot, NEG_INF, scaled[:, :-1]) + g[:, :-1],
                         dim=-1).to(torch.int32)
    # The stopping position's token: a rejection there (i < d_len) draws
    # from the residual, running out of draft (i == d_len) draws fresh.
    stop = torch.cat([torch.where(idx < d_len[:, None], resid, full[:, :-1]),
                      full[:, -1:]], dim=1)
    draft_pad = torch.cat([draft.to(torch.int32), torch.zeros_like(draft[:, :1],
                                                                   dtype=torch.int32)], dim=1)
    pos = torch.arange(t, device=logits.device)[None, :]
    emit = torch.where(pos < n_accept[:, None], draft_pad,
                       torch.where(pos == n_accept[:, None], stop, full))
    return emit.to(torch.int32), n_accept


def _accept(logits, toks, d_len, temperature, uids, steps):
    if temperature > 0.0:
        return verify_sampled(logits, toks[:, 1:], d_len, uids, steps, temperature)
    return verify_greedy(logits, toks[:, 1:], d_len)


def make_verifier(cfg, params, *, paged: bool, unembed: torch.Tensor,
                  temperature: float = 0.0) -> Callable:
    """The engine's verify step (reference ``spec.make_verifier``):

      paged:      ``fn(toks (B, T), pools, page_table, cur, d_len[, uids, steps])``
      contiguous: ``fn(toks (B, T), caches, cur, d_len[, uids, steps])``

    each returning ``(emit (B, T) int32, n_accept (B,) int32, caches)``.
    ``toks[:, 0]`` is each slot's pending token, ``toks[:, 1:]`` its draft
    (zero past ``d_len``); ``uids`` and ``steps`` (tokens emitted so far)
    key the draws at ``temperature`` > 0, greedy ignores them."""
    temperature = float(temperature)
    if paged:
        @torch.inference_mode()
        def fn(toks, pools, page_table, cur, d_len, uids=None, steps=None):
            logits, pools = T.decode_step_multi_paged(cfg, params, toks, pools, page_table,
                                                      cur, unembed=unembed)
            return (*_accept(logits, toks, d_len, temperature, uids, steps), pools)
    else:
        @torch.inference_mode()
        def fn(toks, caches, cur, d_len, uids=None, steps=None):
            logits, caches = T.decode_step_multi(cfg, params, toks, caches, cur,
                                                 unembed=unembed)
            return (*_accept(logits, toks, d_len, temperature, uids, steps), caches)
    return fn
