"""Temperature sampling keyed by request: the draws of every sampler of the
port (the decode ticks, the admission's first token, ``generate`` and the
speculative verify step).

The reference keys each draw by ``slot_key(uid, step)`` (JAX threefry), so
a request's draws depend only on its own stream: not on batch composition,
slot, cache layout or preemption.  Threefry's bits cannot be reproduced in
torch, so the port keeps the property, not the bits: a counter-based
integer hash of (seed, uid, step, tag, vocabulary index), computed in
batched torch ops on the logits' device, gives one uniform per entry, and
the pick is Gumbel-max, ``argmax(logits / T - log(-log u))``, which draws
from ``softmax(logits / T)``.  No draw needs a host value, so a tick keeps
its one device-to-host copy.

The hash is 32-bit arithmetic held in int64: a product of a 32-bit word
and a 16-bit half of a constant stays below 2^48, and every result is
masked back to 32 bits, so no intermediate reaches 2^63 and the integers
are bit-equal on the CPU and the card.
"""

from __future__ import annotations

import torch

SEED = 0  # the reference folds every stream from PRNGKey(0)
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 32-bit words ``x`` (int64) and a 32-bit
    constant, as two products by the constant's 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer: every input bit moves every output bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _absorb(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _fmix32((h ^ _mul32((x + _GOLDEN) & _M32, _GOLDEN)) & _M32)


def stream_keys(uids: torch.Tensor, steps: torch.Tensor, *, tag: int = 0,
                seed: int = SEED) -> torch.Tensor:
    """The 32-bit key of stream (seed, uid, step, tag), as int64, for
    broadcastable integer tensors ``uids`` and ``steps``.  ``tag`` separates
    draws made at one (uid, step): the plain samplers use 0, the verify
    step's accept draws 1 and its sample draws 2."""
    uids, steps = torch.broadcast_tensors(uids.long() & _M32, steps.long() & _M32)
    h = _fmix32(torch.full_like(uids, (seed & _M32) ^ 0x5BD1E995))
    h = _absorb(h, uids)
    h = _absorb(h, steps)
    return _absorb(h, torch.full_like(h, tag & _M32))


def uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``keys.shape + (n,)`` f32 uniforms in (0, 1): entry i of stream k is
    the hash of (k, i), its top 23 bits plus a half, over 2^23.  23 bits
    keep ``bits + 0.5`` exact in f32, so no draw rounds to 1 (where the
    Gumbel noise would be infinite)."""
    idx = torch.arange(n, device=keys.device, dtype=torch.int64)
    h = _fmix32(keys[..., None] ^ _mul32(idx, _GOLDEN))
    return ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``keys.shape + (n,)`` standard Gumbel noise, ``-log(-log u)``."""
    return -torch.log(-torch.log(uniforms(keys, n)))


def gumbel_pick(logits: torch.Tensor, temperature: float, keys: torch.Tensor) -> torch.Tensor:
    """One draw from ``softmax(logits / temperature)`` per row of
    ``logits`` ``(..., V)``, row r drawn from stream ``keys[r]`` -> int32
    ``(...)``."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(logits.float() / temperature + g, dim=-1).to(torch.int32)
