"""The arithmetic of the SSD chunk scan's tensor-core body
(``csrc/ssd_chunk.cu``, ``ssd_tc_kernel``) on the CPU, through its plain
emulation ``ref.ssd_chunked_tc_plain`` (bf16 products in f32, the scores'
decayed operand and the carried state rounded to bf16, the state update's
operand split into bf16 hi + lo), against the JAX package: its model
function ``models/mamba.ssd_chunked`` (y and the final state, any initial
state) and its Pallas kernel ``ssd_chunk_kernel`` through ``ops.ssd`` in
interpret mode (y from a zero state, as ``tests/test_kernels.py`` runs it),
and the port's f32 plain version ``ref.ssd_chunked_ref``.  The kernel itself
runs only on a card: ``tests/test_torch_cuda.py``.

Tolerances, the card tests' (``SSD_RTOL``), relative to the reference's
largest magnitude (at least 1): y 2e-2 (bf16 outputs; one bf16 ulp is
~4e-3 of the top binade), the final state 1e-4 (f32; the reference's own
tolerance for its SSD kernel).  One bf16 rounding of the state update's
operand (~2^-9 relative) misses 1e-4 by an order of magnitude; hi + lo
(~16 bits) meets it with room to spare."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.models import mamba as rmamba
from repro_torch.kernels import ref

Y_RTOL, STATE_RTOL = 2e-2, 1e-4


def _case(seed, *, b, s, h=4, p=32, n=64, init=False):
    """bf16 x, B, C (as torch bf16 and the same values as f32 numpy), f32
    dt = softplus(normal), a = -exp(linspace(-1, 1, H)), and a normal
    initial state or none."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32)).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32)))
    a = -torch.exp(torch.linspace(-1.0, 1.0, h))
    bm = torch.from_numpy(0.3 * rng.standard_normal((b, s, n)).astype(np.float32)).bfloat16()
    cm = torch.from_numpy(0.3 * rng.standard_normal((b, s, n)).astype(np.float32)).bfloat16()
    st = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(np.float32)) if init else None
    return x, dt, a, bm, cm, st


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / max(1.0, np.abs(want).max()))


def _np(t):
    return t.float().numpy()


# The serve's 64-token chunk, one short chunk (13, 36 under a chunk of 256),
# 64 + a 36-token tail, one full Q = 256 chunk, and 256 + a 44-token tail.
CASES = [dict(b=1, s=64, chunk=64, init=True), dict(b=1, s=64, chunk=256),
         dict(b=2, s=13, chunk=256), dict(b=1, s=36, chunk=256, init=True),
         dict(b=2, s=100, chunk=64, init=True), dict(b=1, s=256, chunk=256),
         dict(b=1, s=300, chunk=256, init=True)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ssd_tc_emulation_matches_reference(case):
    kw = {k: v for k, v in case.items() if k != "chunk"}
    x, dt, a, bm, cm, st = _case(case["s"], **kw)
    y, f = ref.ssd_chunked_tc_plain(x, dt, a, bm, cm, chunk=case["chunk"], init_state=st)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    y_j, f_j = rmamba.ssd_chunked(*(jnp.asarray(_np(t)) for t in (x, dt, a, bm, cm)),
                                  chunk=case["chunk"],
                                  init_state=None if st is None else jnp.asarray(_np(st)))
    assert _rel(_np(y), y_j) <= Y_RTOL
    assert _rel(f.numpy(), f_j) <= STATE_RTOL
    y_p, f_p = ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk=case["chunk"], init_state=st)
    assert _rel(_np(y), _np(y_p)) <= Y_RTOL
    assert _rel(f.numpy(), f_p.numpy()) <= STATE_RTOL


@pytest.mark.parametrize("case", [c for c in CASES if not c.get("init")
                                  and (c["s"] <= c["chunk"] or c["s"] % c["chunk"] == 0)],
                         ids=str)
def test_ssd_tc_emulation_matches_pallas_kernel(case):
    """y from a zero state against the reference's Pallas chunk kernel
    (``ops.ssd``: chunks that tile S, no carried state in or out)."""
    x, dt, a, bm, cm, _ = _case(case["s"], b=case["b"], s=case["s"])
    y, _ = ref.ssd_chunked_tc_plain(x, dt, a, bm, cm, chunk=case["chunk"])
    want = rops.ssd(*(jnp.asarray(_np(t)) for t in (x, dt, a, bm, cm)),
                    chunk=case["chunk"], interpret=True)
    assert _rel(_np(y), want) <= Y_RTOL


@pytest.mark.parametrize("init", [False, True])
def test_state_update_needs_the_split(init):
    """At the serve's widths (64 tokens, P 64, N 128): the state update with
    its operand w o x rounded once to bf16 misses the 1e-4 state tolerance;
    split into hi + lo it meets it (the kernel's), as does y either way."""
    x, dt, a, bm, cm, st = _case(5, b=1, s=64, h=8, p=64, n=128, init=init)
    y_p, f_p = ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk=64, init_state=st)
    y1, f1 = ref.ssd_chunked_tc_plain(x, dt, a, bm, cm, chunk=64, init_state=st, split=False)
    y2, f2 = ref.ssd_chunked_tc_plain(x, dt, a, bm, cm, chunk=64, init_state=st)
    assert _rel(f1.numpy(), f_p.numpy()) > 10 * STATE_RTOL
    assert _rel(f2.numpy(), f_p.numpy()) <= STATE_RTOL / 10
    assert torch.equal(y1, y2)  # the split changes the state only
    assert _rel(_np(y2), _np(y_p)) <= Y_RTOL


def test_ssd_tc_emulation_rounds_y_within_half_the_tolerance():
    """The emulation is not the f32 plain version (its bf16 roundings show
    in y), and they stay within half of y's tolerance."""
    x, dt, a, bm, cm, st = _case(9, b=1, s=64, init=True)
    y, _ = ref.ssd_chunked_tc_plain(x, dt, a, bm, cm, chunk=64, init_state=st)
    y_p, _ = ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk=64, init_state=st)
    assert 0.0 < _rel(_np(y), _np(y_p)) <= Y_RTOL / 2
