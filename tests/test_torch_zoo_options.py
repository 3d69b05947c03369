"""More of the engine's options on the zoo's new layer kinds, the port
against the JAX ``StreamedBatchEngine`` on the CPU, f32, equal weights
through the bridge: gemma2-27b (local and global layers, sandwich norms,
softcaps) and qwen2-moe-a2.7b (MoE with shared and padded experts), smoke
configs, served with scatter-after-prefill (non-fused), over fp8 pages, in
a pool small enough to preempt and with prefix sharing.  Greedy tokens per
uid must be identical (fp8: mean agreement >= 0.5, the reference's
floor), and the preemption and sharing counters equal.  At temperature the
two frameworks' streams differ, so the port's paged serve is held to its
contiguous serve instead."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.runtime import serving as PS

QUANT_FLOOR = 0.5
LENS = (24, 17, 40, 9, 33, 16)
KW = dict(max_seq=48, prefill_chunk=16, max_new_tokens=6, max_batch=2, block_size=8)
# 9 blocks (trash included) at 16 new tokens: the 6 requests preempt (a CPU
# run of the engine at these lengths; the count follows from them alone)
PRESSURE_KW = dict(KW, max_seq=64, max_new_tokens=16, paged=True, num_blocks=9)
OPTIONS = {"non-fused": dict(KW, paged=True, fused_prefill=False),
           "fp8": dict(KW, paged=True, kv_dtype="fp8"),
           "preempting pool": PRESSURE_KW,
           "prefix sharing": dict(KW, paged=True, prefix_sharing=True)}


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, rmsnorm scales set to random values."""
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def fill(t):
        for k, v in t.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "scale":
                t[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
    fill(tree)
    return tree


def _prompts(vocab):
    """LENS, every prompt longer than 16 tokens starting with one 16-token
    head (two pages of 8: what prefix sharing maps)."""
    rng = np.random.default_rng(11)
    head = rng.integers(0, vocab, 16)
    return [np.concatenate([head, rng.integers(0, vocab, n - 16)]).astype(np.int32)
            if n > 16 else rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


@pytest.mark.parametrize("option", [*OPTIONS, "temperature"])
@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen2-moe-a2.7b"])
def test_engine_options_match_reference(arch, option):
    rcfg, pcfg = RC.get_smoke_config(arch), PC.get_smoke_config(arch)
    tree = _numpy_params(rcfg)
    params = bridge.params_from_numpy(tree, pcfg, device="cpu")
    prompts = _prompts(rcfg.vocab_size)
    if option == "temperature":
        out = []
        for paged in (True, False):
            eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(
                **dict(KW, paged=paged, temperature=0.8)), device="cpu")
            uids = [eng.submit(p) for p in prompts]
            got = eng.run()
            out.append([got[u] for u in uids])
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)
        return
    kw = OPTIONS[option]
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**kw))
    r_uids = [ref.submit(p) for p in prompts]
    want = ref.run()
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    p_uids = [eng.submit(p) for p in prompts]
    got = eng.run()
    pairs = [(got[p], want[r]) for p, r in zip(p_uids, r_uids)]
    if option == "fp8":
        assert np.mean([np.mean(a == b) for a, b in pairs]) >= QUANT_FLOOR
    else:
        for a, b in pairs:
            np.testing.assert_array_equal(a, b)
    assert (eng.preemptions, eng.prefix_hits) == (ref.preemptions, ref.prefix_hits)
    if option == "preempting pool":
        assert eng.preemptions > 0
    if option == "prefix sharing":
        assert eng.prefix_hits > 0
    eng.kv.clear_prefixes()
    assert eng.kv.pages_in_use == 0
    eng.kv.check_invariants()
