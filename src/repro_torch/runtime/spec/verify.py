"""The batched verify step of speculative decode (greedy), on the device.

One target step scores ``k + 1`` positions per slot — the pending token
plus up to ``k`` draft tokens — through
``transformer.decode_step_multi_paged`` or, over a contiguous cache,
``transformer.decode_step_multi`` (causal masking inside the block),
then applies the greedy acceptance rule on the device: accept the longest
prefix of the draft that matches the target argmax chain; the position
after it emits the target's own argmax (the bonus token).  By induction
this emits exactly the tokens plain greedy decode would.

Temperature sampling (rejection sampling, the reference's
``verify_sampled``) is not ported yet: ROADMAP, temperature sampling.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T


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


def make_verifier(cfg, params, *, paged: bool, unembed: torch.Tensor) -> Callable:
    """The engine's verify step, greedy (reference ``spec.make_verifier``):

      paged:      ``fn(toks (B, T), pools, page_table, cur, d_len)``
      contiguous: ``fn(toks (B, T), caches, cur, d_len)``

    each returning ``(emit (B, T) int32, n_accept (B,) int32, caches)``.
    ``toks[:, 0]`` is each slot's pending token, ``toks[:, 1:]`` its draft
    (zero past ``d_len``)."""
    if paged:
        @torch.inference_mode()
        def fn(toks, pools, page_table, cur, d_len):
            logits, pools = T.decode_step_multi_paged(cfg, params, toks, pools, page_table,
                                                      cur, unembed=unembed)
            emit, n_accept = verify_greedy(logits, toks[:, 1:], d_len)
            return emit, n_accept, pools
    else:
        @torch.inference_mode()
        def fn(toks, caches, cur, d_len):
            logits, caches = T.decode_step_multi(cfg, params, toks, caches, cur,
                                                 unembed=unembed)
            emit, n_accept = verify_greedy(logits, toks[:, 1:], d_len)
            return emit, n_accept, caches
    return fn
