"""The port's engine serving mamba2 (smoke) against the JAX
StreamedBatchEngine on the CPU, f32, equal weights through the bridge:
greedy tokens per uid identical over a contiguous slot cache, beside a
paged pool, and with state snapshots (whose counters must equal the
reference's); and the flag rules of ``ServeConfig`` / ``build_servable``
for the arch kinds.  Request lengths and sizes are tests/test_zoo.py's
(max_seq 128, prefill chunk 16, 2 slots, 6 new tokens)."""

import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.launch import serve as pserve
from repro_torch.runtime import model_iface as PI
from repro_torch.runtime import serving as PS

ARCH = "mamba2-2.7b"
KW = dict(max_seq=128, prefill_chunk=16, max_new_tokens=6, max_batch=2)
LENS = (20, 33, 17)  # tests/test_zoo.py::_parity_with_evict


@pytest.fixture(scope="module")
def setup():
    rcfg = RC.get_smoke_config(ARCH)
    pcfg = PC.get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(0)))
    return rcfg, pcfg, tree


def _both(setup, prompts, **extra):
    """Serve ``prompts`` on the JAX engine and on the port's (CPU); returns
    (reference engine, port engine, reference tokens, port tokens) in
    prompt order."""
    rcfg, pcfg, tree = setup
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jax.numpy.asarray, tree),
                                 RS.ServeConfig(**KW, **extra))
    r_uids = [ref.submit(p) for p in prompts]
    want = ref.run()
    eng = PS.StreamedBatchEngine(pcfg, bridge.params_from_numpy(tree, pcfg, device="cpu"),
                                 PS.ServeConfig(**KW, **extra), device="cpu")
    p_uids = [eng.submit(p) for p in prompts]
    got = eng.run()
    return ref, eng, [want[u] for u in r_uids], [got[u] for u in p_uids]


@pytest.mark.parametrize("extra", [dict(paged=False), dict(paged=True, block_size=16)],
                         ids=str)
def test_mamba_engine_matches_reference_greedy(setup, extra):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, setup[0].vocab_size, n).astype(np.int32) for n in LENS]
    ref, eng, want, got = _both(setup, prompts, **extra)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not eng.scfg.fused_prefill and not ref.scfg.fused_prefill
    assert eng.decode_steps == ref.decode_steps
    assert eng.admissions == len(prompts) and eng.peak_active == 2
    if extra["paged"]:
        assert eng.kv.pages_in_use == 0 and eng.kv.page_bytes == 0
        eng.kv.check_invariants()


@pytest.mark.parametrize("paged", [False, True])
def test_mamba_snapshot_engine_matches_reference(setup, paged):
    """Two prompts sharing a 32-token head (tests/test_zoo.py::
    test_snapshot_reuse): the second admission restores the stored state
    and streams only its tail, with the reference's tokens and counters."""
    rcfg = setup[0]
    rng = np.random.default_rng(7)
    head = rng.integers(0, rcfg.vocab_size, size=32).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, rcfg.vocab_size, size=n)
                               .astype(np.int32)]) for n in (9, 14)]
    extra = dict(state_snapshots=True, paged=paged, **(dict(block_size=16) if paged else {}))
    ref, eng, want, got = _both(setup, prompts, **extra)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (eng.snapshot_hits, eng.snapshot_tokens_reused) == (
        ref.snapshot_hits, ref.snapshot_tokens_reused)
    assert eng.snapshot_hits >= 1 and eng.snapshot_tokens_reused >= 32
    # ... and the same tokens as serving without snapshots.
    _, _, _, plain = _both(setup, prompts, paged=paged,
                           **(dict(block_size=16) if paged else {}))
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)


def test_snapshots_are_host_copies(setup):
    """The store holds host copies: a later admission updating its caches in
    place never changes what the store returns."""
    _, pcfg, tree = setup
    eng = PS.StreamedBatchEngine(pcfg, bridge.params_from_numpy(tree, pcfg, device="cpu"),
                                 PS.ServeConfig(**KW, paged=False, state_snapshots=True),
                                 device="cpu")
    prompt = np.arange(40, dtype=np.int32)
    eng.submit(prompt)
    eng.run()
    n, snap = eng.servable.lookup_snapshot(prompt)
    assert n == 32
    before = {k: v.clone() for k, v in snap["blocks"]["layer0"].items()}
    for v in snap["blocks"]["layer0"].values():
        v.add_(1.0)  # a restored copy is the admission's to update
    _, again = eng.servable.lookup_snapshot(prompt)
    for k, v in again["blocks"]["layer0"].items():
        np.testing.assert_array_equal(v.numpy(), before[k].numpy())


@pytest.mark.parametrize("bad", [dict(prefix_sharing=True), dict(spec_decode=True),
                                 dict(kv_dtype="int8"), dict(fused_prefill=True)], ids=str)
def test_mamba_rejects_reference_rejections(setup, bad):
    _, pcfg, tree = setup
    with pytest.raises(NotImplementedError):
        PS.ServeConfig(**KW, paged=True, arch_kind="mamba", **bad)
    params = bridge.params_from_numpy(tree, pcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**KW, paged=True, **bad),
                               device="cpu")


def test_flag_rules_per_arch():
    # A transformer serves contiguously (the default) or paged, fused or not.
    assert PS.ServeConfig(paged=False, arch_kind="transformer").fused_prefill is False
    assert PS.ServeConfig(paged=True, fused_prefill=False,
                          arch_kind="transformer").fused_prefill is False
    with pytest.raises(ValueError, match="mamba only"):
        PS.ServeConfig(state_snapshots=True, arch_kind="transformer")
    with pytest.raises(ValueError, match="paged=True"):
        PS.ServeConfig(paged=False, kv_dtype="int8")
    with pytest.raises(ValueError, match="paged=True"):
        PS.ServeConfig(paged=False, fused_prefill=True)
    assert PS.ServeConfig(paged=True, arch_kind="transformer").fused_prefill is True
    assert PS.ServeConfig(arch_kind="transformer").fused_prefill is False
    assert PS.ServeConfig(paged=True, arch_kind="mamba").fused_prefill is False
    assert PS.ServeConfig(paged=False, arch_kind="mamba").fused_prefill is False


def test_transformer_engine_still_rejects_the_contiguous_path():
    """The transformer engine now builds over the contiguous slot cache:
    full-length K/V rows per slot, no pool."""
    from repro_torch.models import transformer as PT
    cfg = PC.get_smoke_config("qwen3-4b")
    params = PT.init_params(cfg, 0, device="cpu")
    eng = PS.StreamedBatchEngine(cfg, params, PS.ServeConfig(paged=False, max_seq=32),
                                 device="cpu")
    assert eng.kv is None and not eng.scfg.fused_prefill
    assert tuple(eng.caches["blocks"]["layer0"]["k"].shape) == (
        cfg.n_repeats, 4, 32, cfg.n_kv_heads, cfg.head_dim)
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=2)
    assert len(eng.run()[0]) == 2


def test_arch_kinds_match_reference():
    """The port's taxonomy on every reference config (built field by field
    into the port's ModelConfig), and the reference's rejection of the
    prefix-LM kind (paligemma) by the batched engine, before the params are
    touched."""
    for arch in RC.list_archs():
        rcfg = RC.get_config(arch)
        fields = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)
                  if f.name not in ("param_dtype", "compute_dtype", "layer_unit")}
        pcfg = PC.ModelConfig(**fields, layer_unit=tuple(
            PC.LayerSpec(**dataclasses.asdict(s)) for s in rcfg.layer_unit))
        from repro.runtime import model_iface as RI
        assert PI.arch_kind_of(pcfg) == RI.arch_kind_of(rcfg), arch
        if PI.arch_kind_of(pcfg) == "prefix_lm":
            with pytest.raises(NotImplementedError, match="prefix-LM"):
                PI.build_servable(pcfg, {}, PS.ServeConfig(), device="cpu")


@pytest.mark.parametrize("flags", [[], ["--paged"], ["--state-snapshots"],
                                   ["--paged", "--state-snapshots"]], ids=str)
def test_launcher_serves_mamba_on_cpu(capsys, flags):
    pserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--prompt-len", "20",
                 "--new-tokens", "4", "--prefill-chunk", "8", "--max-batch", "2", *flags])
    out = capsys.readouterr().out
    assert "3 requests x 20 prompt -> 4 new tokens each" in out
    assert ("paged block=16" in out) == ("--paged" in flags)
    assert ("contiguous slot cache" in out) == ("--paged" not in flags)
    assert ("state snapshots:" in out) == ("--state-snapshots" in flags)


@pytest.mark.slow
@pytest.mark.parametrize("arch", RC.list_archs())
def test_zoo_streamed_smoke(arch):
    """``tests/test_zoo.py::test_zoo_streamed_smoke`` (slow there too):
    every config serves one streamed admission end to end on the port's
    engine with the JAX engine's tokens (whisper with its encoder frames),
    or, prefix-LM, is rejected with the reference's message before its
    params are touched."""
    rcfg, pcfg = RC.get_smoke_config(arch), PC.get_smoke_config(arch)
    if PI.arch_kind_of(pcfg) == "prefix_lm":
        with pytest.raises(NotImplementedError, match="prefix-LM"):
            PS.StreamedBatchEngine(pcfg, {}, PS.ServeConfig(**KW), device="cpu")
        return
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    kw = {}
    if rcfg.is_encoder_decoder:
        kw["enc_inputs"] = rng.standard_normal((rcfg.encoder_seq, rcfg.d_model)).astype(
            np.float32)
    tokens = rng.integers(0, rcfg.vocab_size, 24).astype(np.int32)
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jax.numpy.asarray, tree),
                                 RS.ServeConfig(**KW))
    r_uid = ref.submit(tokens, **kw)
    want = ref.run()[r_uid]
    eng = PS.StreamedBatchEngine(pcfg, bridge.params_from_numpy(tree, pcfg, device="cpu"),
                                 PS.ServeConfig(**KW), device="cpu")
    uid = eng.submit(tokens, **kw)
    out = eng.run()
    assert out[uid].shape == (KW["max_new_tokens"],)
    np.testing.assert_array_equal(out[uid], want)
