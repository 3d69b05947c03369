"""whisper-medium (smoke config: 2 decoder and 2 encoder layers, 16
frames) in the port against the JAX package on the CPU, f32, equal
weights through the bridge:

* ``sinusoidal_positions`` / ``sinusoidal_positions_at`` within 1e-5;
* ``encode`` and one decoder layer (self-attention without rope, the
  cross-attention block over the encoder output, gelu_mlp) within 1e-5;
* the streamed prefill (chunks of 16) equal to the reference's one-shot
  ``prefill`` within 1e-4, the reference's own tolerance
  (``tests/test_runtime.py``), and its decode steps after it;
* the engine: greedy tokens per uid equal to the JAX
  ``StreamedBatchEngine``'s, contiguous and paged, with one evict /
  readmit after 3 scheduling steps (the cross-attention K/V travel with the
  slot's state); ``ServingEngine.generate`` equal to the reference's;
* ``submit``'s errors (``tests/test_zoo.py:251-272``) and the flag rules,
  with the reference's messages; the launcher."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.runtime import model_iface as PI
from repro_torch.runtime import serving as PS

ARCH = "whisper-medium"
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
def whisper():
    rcfg, pcfg = RC.get_smoke_config(ARCH), PC.get_smoke_config(ARCH)
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, tree, bridge.params_from_numpy(tree, pcfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _encs(cfg, n, seed=5, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((cfg.encoder_seq, cfg.d_model))).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("seq,d", [(16, 64), (1500, 1024), (7, 10)])
def test_sinusoidal_positions_match_reference(seq, d):
    """Row p within 1e-5 + p * 2^-23: XLA's and torch's f32 ``exp`` differ by
    one ulp in some frequencies (all <= 1, so an ulp is <= 2^-23), and the
    angle ``p * freq`` carries p times that."""
    want = np.asarray(RL.sinusoidal_positions(seq, d, jnp.float32))
    got = PL.sinusoidal_positions(seq, d, torch.float32).numpy()
    bound = 1e-5 + np.arange(seq)[:, None] * 2.0 ** -23
    assert (np.abs(got - want) <= bound).all()
    pos = np.array([[0], [5], [seq - 1]], np.int32)  # decode: (B, 1) device positions
    want = np.asarray(RL.sinusoidal_positions_at(jnp.asarray(pos), d, jnp.float32))
    got = PL.sinusoidal_positions_at(_t(pos), d, torch.float32).numpy()
    assert (np.abs(got - want) <= 1e-5 + pos[..., None] * 2.0 ** -23).all()
    np.testing.assert_array_equal(got[:, 0], PL.sinusoidal_positions(seq, d, torch.float32)
                                  .numpy()[pos[:, 0]])


def test_encode_matches_reference(whisper):
    rcfg, pcfg, tree, params = whisper
    assert set(params["encoder"]) == {"blocks", "final_norm"}
    enc = np.stack(_encs(rcfg, 2))
    want = RT.encode(rcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(enc))
    got = PT.encode(pcfg, params, _t(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_layer_matches_reference(whisper):
    """One decoder layer at prefill: causal self-attention without rope,
    the cross-attention block over ``enc_out`` (no mask), gelu_mlp."""
    rcfg, pcfg, tree, params = whisper
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 12, rcfg.d_model)).astype(np.float32)
    enc_out = rng.standard_normal((2, rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
    assert {"cross_norm", "cross"} <= set(params["blocks"]["layer0"])
    pr = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["layer0"])
    want, _, _ = RT._apply_layer(rcfg, rcfg.layer_unit[0], pr, jnp.asarray(h), positions=None,
                                 cache=None, cur_len=None, enc_out=jnp.asarray(enc_out),
                                 prefix_len=0, causal=True)
    got = PT._apply_layer(pcfg, pcfg.layer_unit[0], PT._at(params["blocks"]["layer0"], 0),
                          _t(h), positions=None, cache=None, cur_len=None, q_offset=0,
                          page_table=None, enc_out=_t(enc_out))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_streamed_prefill_equals_one_shot(whisper):
    """The port's streamed prefill (chunks of 16, the first storing the
    cross K/V) against the reference's one-shot ``prefill`` (atol 1e-4, the
    reference test's), then 3 decode steps over the contiguous cache with
    the cross K/V read back, within 1e-5."""
    rcfg, pcfg, tree, params = whisper
    b, s = 2, 64
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    enc = np.stack(_encs(rcfg, b, scale=0.1))
    jp = jax.tree.map(jnp.asarray, tree)
    want, rcache = RT.prefill(rcfg, jp, {"tokens": jnp.asarray(toks),
                                         "enc_inputs": jnp.asarray(enc)}, max_seq=s + 8)
    eng = PS.ServingEngine(pcfg, params, PS.ServeConfig(max_seq=s + 8, prefill_chunk=16),
                           device="cpu", unembed=PT.unembed_f32(pcfg, params))
    chunks = list(eng.iter_prefill_chunks(_t(toks), enc_inputs=enc))
    assert [p for _, _, p in chunks] == [16, 32, 48, 64]
    logits, caches, _ = chunks[-1]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4)
    nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    for i in range(3):
        cur = np.full((b,), s + i, np.int32)
        want, rcache = RT.decode_step(rcfg, jp, jnp.asarray(nxt[:, None]), rcache,
                                      jnp.asarray(cur))
        got, caches = PT.decode_step(pcfg, params, _t(nxt[:, None]), caches, _t(cur),
                                     unembed=eng.unembed)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    np.testing.assert_allclose(caches["blocks"]["layer0"]["cross_k"].numpy(),
                               np.asarray(rcache["blocks"]["layer0"]["cross_k"]), **TOL)


def _script(eng, prompts, encs):
    """The reference's ``_parity_with_evict`` with encoder inputs."""
    uids = [eng.submit(p, enc_inputs=e) for p, e in zip(prompts, encs)]
    for _ in range(3):
        if eng.pending:
            eng.step()
    assert eng.active_slots, "expected in-flight slots to evict"
    eng.readmit(eng.evict(eng.active_slots[0].uid))
    out = eng.run()
    return [out[u] for u in uids], eng


@pytest.mark.parametrize("extra", [{}, dict(paged=True, block_size=16)],
                         ids=["contiguous", "paged"])
def test_engine_with_evict_matches_reference(whisper, extra):
    rcfg, pcfg, tree, params = whisper
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32) for n in (20, 33, 17)]
    encs = _encs(rcfg, 3, seed=1)
    want, ref = _script(RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree),
                                               RS.ServeConfig(**KW, **extra)), prompts, encs)
    got, eng = _script(PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**KW, **extra),
                                              device="cpu"), prompts, encs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert eng.decode_steps == ref.decode_steps
    assert isinstance(eng.servable, PI.WhisperServable) and eng.scfg.arch_kind == "whisper"
    assert not eng.scfg.fused_prefill
    # the first chunk of each admission carries the encoder output; keys
    # as the reference's (len, first, pos0)
    assert list(eng.servable.single._chunk_jit) == list(ref.single._chunk_jit)
    if eng.paged:
        assert eng.kv.pages_in_use == 0
        eng.kv.check_invariants()
        assert set(eng.kv.pools["blocks"]["layer0"]) == {"k", "v", "cross_k", "cross_v"}


def test_generate_matches_reference(whisper):
    rcfg, pcfg, tree, params = whisper
    rng = np.random.default_rng(2)
    toks = rng.integers(0, rcfg.vocab_size, (3, 20)).astype(np.int32)
    enc = np.stack(_encs(rcfg, 3, seed=2, scale=0.1))
    scfg = dict(max_seq=64, prefill_chunk=16, max_new_tokens=6)
    want = RS.ServingEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**scfg)
                            ).generate(jnp.asarray(toks), enc_inputs=jnp.asarray(enc))
    got = PS.ServingEngine(pcfg, params, PS.ServeConfig(**scfg), device="cpu",
                           unembed=PT.unembed_f32(pcfg, params)).generate(toks, enc_inputs=enc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _raises_like_reference(exc, make_ref, make_port):
    with pytest.raises(exc) as want:
        make_ref()
    with pytest.raises(exc) as got:
        make_port()
    assert str(got.value) == str(want.value)


def test_submit_errors_match_reference(whisper):
    rcfg, pcfg, tree, params = whisper
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**KW))
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**KW), device="cpu")
    toks = np.arange(8, dtype=np.int32)
    _raises_like_reference(ValueError, lambda: ref.submit(toks), lambda: eng.submit(toks))
    bad = np.zeros((rcfg.encoder_seq + 1, rcfg.d_model), np.float32)
    _raises_like_reference(ValueError, lambda: ref.submit(toks, enc_inputs=bad),
                           lambda: eng.submit(toks, enc_inputs=bad))
    ok = np.zeros((rcfg.encoder_seq, rcfg.d_model), np.float32)
    assert eng.submit(toks, enc_inputs=ok) == 0 and eng.submit(toks, enc_inputs=ok[None]) == 1
    assert eng.queue[0].enc_inputs.shape == (1, rcfg.encoder_seq, rcfg.d_model)
    probe = eng.servable.probe_enc_out()
    assert probe.shape == (1, pcfg.encoder_seq, pcfg.d_model) and not probe.any()


def test_text_arch_rejects_enc_inputs():
    rcfg, pcfg = RC.get_smoke_config("qwen3-4b"), PC.get_smoke_config("qwen3-4b")
    ref = RS.StreamedBatchEngine(rcfg, RT.init_params(rcfg, jax.random.PRNGKey(0)),
                                 RS.ServeConfig(**KW))
    eng = PS.StreamedBatchEngine(pcfg, PT.init_params(pcfg, 0, device="cpu"),
                                 PS.ServeConfig(**KW), device="cpu")
    enc = np.zeros((4, rcfg.d_model), np.float32)
    toks = np.arange(8, dtype=np.int32)
    _raises_like_reference(ValueError, lambda: ref.submit(toks, enc_inputs=enc),
                           lambda: eng.submit(toks, enc_inputs=enc))
    assert eng.servable.probe_enc_out() is None


@pytest.mark.parametrize("flags", [dict(spec_decode=True), dict(paged=True, kv_dtype="fp8"),
                                   dict(paged=True, prefix_sharing=True),
                                   dict(paged=True, fused_prefill=True)], ids=str)
def test_flag_rejections_match_reference(flags):
    _raises_like_reference(NotImplementedError,
                           lambda: RS.ServeConfig(arch_kind="whisper", **flags),
                           lambda: PS.ServeConfig(arch_kind="whisper", **flags))


@pytest.mark.parametrize("flags", [[], ["--paged"], ["--sequential"]], ids=str)
def test_launcher_serves_whisper_on_cpu(capsys, flags):
    from repro_torch.launch import serve as pserve
    pserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--prompt-len", "20",
                 "--new-tokens", "4", "--prefill-chunk", "8", "--max-batch", "2", *flags])
    out = capsys.readouterr().out
    assert "3 requests x 20 prompt -> 4 new tokens each" in out
    assert ("sequential-batch" in out) == ("--sequential" in flags)
