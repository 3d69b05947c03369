"""jamba-1.5-large-398b (smoke config: the 8-layer unit twice, mamba heads
of 8, 4 experts) in the port against the JAX package on the CPU, f32,
equal weights through the bridge:

* the hybrid layer kinds -- mamba + dense FFN, mamba + MoE FFN, attention
  without positions + MoE FFN -- one layer from equal hidden states,
  within 1e-5;
* the model: the reference's ``prefill`` then 4 ``decode_step`` calls
  against the port's ``init_cache`` / ``prefill_chunk`` / ``decode_step``,
  logits within 1e-5;
* the engine: greedy tokens per uid equal to the JAX
  ``StreamedBatchEngine``'s, contiguous and paged, with one evict /
  readmit after 3 scheduling steps (the reference's ``_parity_with_evict``
  script, ``tests/test_zoo.py``): the per-slot SSM state rides the caches
  beside the attention K/V;
* the flag rules: state snapshots, speculative decode, quantized pools and
  prefix sharing rejected with the reference's messages.

The JAX engine compiles a function per chunk shape, so each engine case
runs it once (module-scoped)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.models import transformer as PT
from repro_torch.runtime import model_iface as PI
from repro_torch.runtime import serving as PS

ARCH = "jamba-1.5-large-398b"
TOL = dict(atol=1e-5, rtol=1e-5)
KW = dict(max_seq=128, prefill_chunk=16, max_new_tokens=6, max_batch=2)


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, rmsnorm scales set to random non-zero values
    (zero at init, so the ``1 + scale`` gain would otherwise go untested)."""
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
def jamba():
    rcfg, pcfg = RC.get_smoke_config(ARCH), PC.get_smoke_config(ARCH)
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, tree, bridge.params_from_numpy(tree, pcfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_smoke_config_matches_reference():
    rcfg, pcfg = RC.get_smoke_config(ARCH), PC.get_smoke_config(ARCH)
    assert (pcfg.mamba_headdim, pcfg.ssm_state, pcfg.n_experts) == (8, 16, 4)
    assert (rcfg.mamba_headdim, rcfg.ssm_state, rcfg.n_experts) == (8, 16, 4)
    assert [(s.mixer, s.ffn) for s in pcfg.layer_unit] == [
        ("attn" if i == 3 else "mamba", "moe" if i % 2 else "dense") for i in range(8)]
    assert not pcfg.use_rope


@pytest.mark.parametrize("pos", [0, 1, 3], ids=["mamba-dense", "mamba-moe", "attn-moe"])
def test_hybrid_layer_kinds_match_reference(jamba, pos):
    rcfg, pcfg, tree, params = jamba
    assert set(params["blocks"][f"layer{pos}"]) == {"mixer_norm", "mixer", "ffn_norm", "ffn"}
    rng = np.random.default_rng(pos)
    h = rng.standard_normal((2, 16, rcfg.d_model)).astype(np.float32)
    pr = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"][f"layer{pos}"])
    want, _, _ = RT._apply_layer(rcfg, rcfg.layer_unit[pos], pr, jnp.asarray(h),
                                 positions=jnp.arange(16), cache=None, cur_len=None,
                                 enc_out=None, prefix_len=0, causal=True)
    got = PT._apply_layer(pcfg, pcfg.layer_unit[pos], PT._at(params["blocks"][f"layer{pos}"], 0),
                          _t(h), positions=torch.arange(16), cache=None, cur_len=None,
                          q_offset=0, page_table=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_model_prefill_and_decode_match_reference(jamba):
    """Prefill of 2 x 32 tokens (two MoE chunks), then 4 greedy decode
    steps fed the reference's picks, over the contiguous cache: SSM state,
    conv tail and the attention layer's K/V all carried."""
    rcfg, pcfg, tree, params = jamba
    b, max_seq, s = 2, 64, 32
    toks = np.random.default_rng(s).integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    want, rcache = RT.prefill(rcfg, jax.tree.map(jnp.asarray, tree),
                              {"tokens": jnp.asarray(toks)}, max_seq=max_seq)
    caches = PT.init_cache(pcfg, b, max_seq, ring=False, device="cpu")
    un = PT.unembed_f32(pcfg, params)
    got, caches = PT.prefill_chunk(pcfg, params, _t(toks), caches, 0, unembed=un)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jp = jax.tree.map(jnp.asarray, tree)
    nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    for i in range(4):
        cur = np.full((b,), s + i, np.int32)
        want, rcache = RT.decode_step(rcfg, jp, jnp.asarray(nxt[:, None]), rcache,
                                      jnp.asarray(cur))
        got, caches = PT.decode_step(pcfg, params, _t(nxt[:, None]), caches, _t(cur),
                                     unembed=un)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    for name, c in caches["blocks"].items():
        assert set(c) == set(rcache["blocks"][name]), name
        np.testing.assert_allclose(c[next(iter(c))].numpy(),
                                   np.asarray(rcache["blocks"][name][next(iter(c))]),
                                   atol=1e-4, rtol=1e-4)


def _script(eng, prompts):
    """The reference's ``_parity_with_evict``: submit, 3 steps, evict the
    first active slot and readmit it, drain."""
    uids = [eng.submit(p) for p in prompts]
    for _ in range(3):
        if eng.pending:
            eng.step()
    assert eng.active_slots, "expected in-flight slots to evict"
    eng.readmit(eng.evict(eng.active_slots[0].uid))
    out = eng.run()
    return [out[u] for u in uids], eng


@pytest.mark.parametrize("extra", [{}, dict(paged=True, block_size=16)],
                         ids=["contiguous", "paged"])
def test_engine_with_evict_matches_reference(jamba, extra):
    rcfg, pcfg, tree, params = jamba
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32) for n in (20, 33, 17)]
    want, ref = _script(RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree),
                                               RS.ServeConfig(**KW, **extra)), prompts)
    got, eng = _script(PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**KW, **extra),
                                              device="cpu"), prompts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert eng.decode_steps == ref.decode_steps and eng.scfg.arch_kind == "mamba"
    assert isinstance(eng.servable, PI.MambaServable)
    if eng.paged:
        assert eng.kv.pages_in_use == 0
        eng.kv.check_invariants()
        layers = eng.kv.pools["blocks"]
        assert set(layers["layer3"]) == {"k", "v"} and set(layers["layer0"]) == {"ssm", "conv"}


def _raises_like_reference(make_ref, make_port):
    with pytest.raises(NotImplementedError) as want:
        make_ref()
    with pytest.raises(NotImplementedError) as got:
        make_port()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", [dict(spec_decode=True), dict(paged=True, kv_dtype="int8"),
                                   dict(paged=True, prefix_sharing=True),
                                   dict(paged=True, fused_prefill=True)], ids=str)
def test_flag_rejections_match_reference(flags):
    _raises_like_reference(lambda: RS.ServeConfig(arch_kind="mamba", **flags),
                           lambda: PS.ServeConfig(arch_kind="mamba", **flags))


def test_state_snapshots_rejected_for_hybrid():
    """Before the params are touched, with the reference's message."""
    rcfg, pcfg = RC.get_smoke_config(ARCH), PC.get_smoke_config(ARCH)
    _raises_like_reference(
        lambda: RS.StreamedBatchEngine(rcfg, {}, RS.ServeConfig(state_snapshots=True)),
        lambda: PS.StreamedBatchEngine(pcfg, {}, PS.ServeConfig(state_snapshots=True),
                                       device="cpu"))


@pytest.mark.parametrize("flags", [[], ["--paged"]], ids=str)
def test_launcher_serves_jamba_on_cpu(capsys, flags):
    from repro_torch.launch import serve as pserve
    pserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--prompt-len", "20",
                 "--new-tokens", "4", "--prefill-chunk", "8", "--max-batch", "2", *flags])
    out = capsys.readouterr().out
    assert "3 requests x 20 prompt -> 4 new tokens each" in out
    assert ("contiguous slot cache" in out) == ("--paged" not in flags)


@pytest.mark.slow
def test_paged_parity_other_archs_jamba(jamba):
    """``tests/test_kv_cache.py::test_paged_parity_other_archs`` for jamba
    (slow there too): the port's paged engine, the per-slot SSM state
    beside the pages, gives the JAX single-request ``generate``'s tokens."""
    rcfg, pcfg, tree, params = jamba
    kw = dict(max_seq=64, prefill_chunk=16, max_new_tokens=4, max_batch=2, block_size=16)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32) for n in (24, 40)]
    single = RS.ServingEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**kw))
    want = [np.asarray(single.generate(jnp.asarray(p[None]))[0]) for p in prompts]
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(paged=True, **kw), device="cpu")
    uids = [eng.submit(p) for p in prompts]
    got = eng.run()
    for u, ref in zip(uids, want):
        np.testing.assert_array_equal(got[u], ref)
