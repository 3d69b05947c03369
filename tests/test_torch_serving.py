"""The port's paged engine against the JAX StreamedBatchEngine: smoke
qwen3-4b, paged, fused prefill, greedy, equal weights through the bridge.
Greedy tokens per uid must be identical on full-precision pools; on int8 /
fp8 pools (with and without speculative decode) the mean greedy agreement
must reach the reference's own floor, 0.5 (``QUANT_TOL`` in
``tests/test_quant_kv.py``): one flipped argmax cascades."""

import jax
import numpy as np
import pytest

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.launch import serve as pserve
from repro_torch.runtime import serving as PS

LENS = (24, 17, 40, 9, 33, 16)
NEW = 6
CHUNK, BLOCK, SLOTS = 16, 8, 2
MAX_SEQ = 48  # longest prompt + NEW, rounded up to a whole page


def _numpy_params(cfg, seed=0):
    """Reference init, as numpy, with the zero-init rmsnorm scales set to
    random values so the ``1 + scale`` gain is exercised."""
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


@pytest.fixture(scope="module")
def setup():
    rcfg = RC.get_smoke_config("qwen3-4b")
    pcfg = PC.get_smoke_config("qwen3-4b")
    tree = _numpy_params(rcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32) for n in LENS]
    return rcfg, pcfg, tree, prompts


def test_engine_matches_reference_greedy(setup):
    rcfg, pcfg, tree, prompts = setup
    kw = dict(max_seq=MAX_SEQ, prefill_chunk=CHUNK, max_new_tokens=NEW,
              max_batch=SLOTS, block_size=BLOCK)
    ref = RS.StreamedBatchEngine(
        rcfg, jax.tree.map(jax.numpy.asarray, tree),
        RS.ServeConfig(paged=True, **kw))
    assert ref.scfg.fused_prefill
    r_uids = [ref.submit(p) for p in prompts]
    want = ref.run()

    eng = PS.StreamedBatchEngine(
        pcfg, bridge.params_from_numpy(tree, pcfg, device="cpu"),
        PS.ServeConfig(paged=True, **kw), device="cpu")
    p_uids = [eng.submit(p) for p in prompts]
    got = eng.run()
    for ru, pu in zip(r_uids, p_uids):
        np.testing.assert_array_equal(got[pu], want[ru])
    assert eng.admissions == len(prompts)
    assert eng.decode_steps == ref.decode_steps
    assert eng.peak_active == SLOTS
    # every slot drained: all pages back on the free list
    eng.kv.check_invariants()
    assert eng.kv.pages_in_use == 0


QUANT_FLOOR = 0.5


def test_engine_rejects_unported_features():
    for bad in (dict(temperature=0.5), dict(prefix_sharing=True),
                dict(spec_decode=True, temperature=0.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PS.ServeConfig(**bad)
    # The contiguous cache is ported: the reference's default serves.
    assert PS.ServeConfig(paged=False, arch_kind="transformer").fused_prefill is False
    with pytest.raises(NotImplementedError, match="temperature sampling"):
        PS.ServeConfig(spec_decode=True, temperature=0.5)
    with pytest.raises(ValueError, match="kv_dtype"):
        PS.ServeConfig(kv_dtype="int4")
    with pytest.raises(ValueError, match="spec_k"):
        PS.ServeConfig(spec_decode=True, spec_k=0)


@pytest.mark.parametrize("extra", [dict(kv_dtype="int8"), dict(kv_dtype="fp8"),
                                   dict(kv_dtype="int8", spec_decode=True, spec_k=2)],
                         ids=str)
def test_quantized_engine_agrees_with_reference(setup, extra):
    rcfg, pcfg, tree, prompts = setup
    kw = dict(max_seq=MAX_SEQ, prefill_chunk=CHUNK, max_new_tokens=NEW,
              max_batch=SLOTS, block_size=BLOCK, **extra)
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jax.numpy.asarray, tree),
                                 RS.ServeConfig(paged=True, **kw))
    r_uids = [ref.submit(p) for p in prompts]
    want = ref.run()
    eng = PS.StreamedBatchEngine(
        pcfg, bridge.params_from_numpy(tree, pcfg, device="cpu"),
        PS.ServeConfig(paged=True, **kw), device="cpu")
    p_uids = [eng.submit(p) for p in prompts]
    got = eng.run()
    agree = float(np.mean([np.mean(got[pu] == want[ru]) for pu, ru in zip(p_uids, r_uids)]))
    print(f"{extra}: mean greedy agreement with the JAX engine {agree:.3f}")
    assert all(got[pu].shape == want[ru].shape for pu, ru in zip(p_uids, r_uids))
    assert agree >= QUANT_FLOOR
    assert eng.kv.pages_in_use == 0
    eng.kv.check_invariants()


def test_engine_raises_instead_of_preempting(setup):
    """A pool too small for both slots' growth: the port preempts, as the
    reference does, and both requests finish with the JAX engine's tokens
    and preemption count."""
    rcfg, pcfg, tree, _ = setup
    kw = dict(max_seq=32, prefill_chunk=8, max_new_tokens=16, max_batch=2, block_size=8,
              num_blocks=5, paged=True)
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jax.numpy.asarray, tree),
                                 RS.ServeConfig(**kw))
    eng = PS.StreamedBatchEngine(
        pcfg, bridge.params_from_numpy(tree, pcfg, device="cpu"), PS.ServeConfig(**kw),
        device="cpu")
    prompts = [np.arange(n, dtype=np.int32) for n in (8, 8)]
    r_uids = [ref.submit(p) for p in prompts]
    p_uids = [eng.submit(p) for p in prompts]
    want, got = ref.run(), eng.run()
    for ru, pu in zip(r_uids, p_uids):
        np.testing.assert_array_equal(got[pu], want[ru])
    assert eng.preemptions == ref.preemptions >= 1
    assert eng.kv.pages_in_use == 0
    eng.kv.check_invariants()


def test_launcher_runs_on_cpu(capsys):
    pserve.main(["--device", "cpu", "--paged", "--requests", "3", "--prompt-len",
                 "20", "--new-tokens", "4", "--prefill-chunk", "8",
                 "--block-size", "8", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "3 requests x 20 prompt -> 4 new tokens each" in out


def test_launcher_runs_spec_decode_over_int8_pages(capsys):
    pserve.main(["--device", "cpu", "--paged", "--requests", "2", "--prompt-len", "12",
                 "--new-tokens", "8", "--prefill-chunk", "8", "--block-size", "8",
                 "--max-batch", "2", "--spec-decode", "--spec-k", "3", "--spec-ngram", "2",
                 "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "2 requests x 12 prompt -> 8 new tokens each" in out
    assert "spec k=3" in out and "acceptance" in out
    assert "kv_dtype=int8" in out and "page_bytes=" in out


def test_launcher_requires_paged(capsys):
    """Without ``--paged`` a transformer now serves over the contiguous
    slot cache (the reference's default) instead of exiting."""
    pserve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "12",
                 "--new-tokens", "3", "--prefill-chunk", "8", "--block-size", "8",
                 "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "contiguous slot cache" in out
    assert "2 requests x 12 prompt -> 3 new tokens each" in out
