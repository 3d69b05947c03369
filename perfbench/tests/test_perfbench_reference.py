"""The plain references against the port's CPU path at the
configurations' smoke sizes, in f32, on the same seeded weights: the
chunked prefill over a contiguous cache and then decode steps must give
the reference's logits at every position."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.harness import weights
from perfbench.harness.engine import port_config
from perfbench.harness.manifest import load_module
from perfbench.tests import smoke

PROMPT, DECODE, CHUNK = 37, 6, 16


@pytest.mark.parametrize("name", sorted(smoke.CONFIGS))
def test_reference_matches_the_port_on_the_cpu(name):
    from repro_torch.models import transformer as T

    conf = smoke.CONFIGS[name]
    ref = load_module(smoke.REPO / "perfbench/reference" / f"{conf['reference']}.py")
    cfg = port_config(conf)
    params = weights.make_params(cfg, 2**32 + 3, "cpu")
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab_size, size=PROMPT + DECODE).astype(np.int64)
    unembed = T.unembed_f32(cfg, params)
    caches = T.init_cache(cfg, 1, 128, ring=False, device="cpu")
    toks = torch.as_tensor(seq[None], dtype=torch.int32)
    got = []
    with torch.inference_mode():
        for lo in range(0, PROMPT, CHUNK):
            logits, caches = T.prefill_chunk(cfg, params, toks[:, lo: min(PROMPT, lo + CHUNK)],
                                             caches, lo, unembed=unembed)
        got.append(logits[0, -1])
        for pos in range(PROMPT, PROMPT + DECODE - 1):
            logits, caches = T.decode_step(cfg, params, toks[:, pos: pos + 1], caches,
                                           torch.tensor([pos], dtype=torch.int32),
                                           unembed=unembed)
            got.append(logits[0, -1])
    want = ref.logits(conf["model"], params, [seq[:-1]], [PROMPT - 1], device="cpu")[0]
    got = torch.stack(got)
    assert want.shape == got.shape == (DECODE, cfg.padded_vocab)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale
    assert torch.equal(got.argmax(-1), want.argmax(-1))
