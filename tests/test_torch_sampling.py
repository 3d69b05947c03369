"""Temperature sampling in the port (``runtime/sampling.py``, the
temperature branch of ``transformer.sample_tokens``, ``spec.verify_sampled``
and the engine's streams) on the CPU.  The two frameworks' random streams
cannot match, so the draws are held statistically against the analytic
``softmax(logits / T)`` that the JAX samplers also meet (TV < 0.05, as
``tests/test_spec_decode.py`` judges them), the hash is held bit for bit
against a plain Python one, and the engine's tokens are held to the
property the reference's keys give: a request's draws depend on its own
(uid, step) stream only, not on its slot, its neighbours, the cache layout
or preemption (``tests/test_kv_cache.py:195``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro.runtime.spec import verify_sampled as r_verify_sampled
from repro_torch import configs as PC
from repro_torch.launch import serve as pserve
from repro_torch.models import transformer as PT
from repro_torch.runtime import sampling as S
from repro_torch.runtime import serving as PS
from repro_torch.runtime.spec import verify_sampled

M32 = 0xFFFFFFFF


def _fmix32_py(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _absorb_py(h, x):
    return _fmix32_py(h ^ ((((x + 0x9E3779B9) & M32) * 0x9E3779B9) & M32))


def _key_py(uid, step, tag, seed=0):
    h = _fmix32_py((seed & M32) ^ 0x5BD1E995)
    for x in (uid, step, tag):
        h = _absorb_py(h, x & M32)
    return h


def _tv(draws, p):
    got = np.bincount(np.asarray(draws).reshape(-1), minlength=len(p)) / np.size(draws)
    return 0.5 * np.abs(got - p).sum()


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def test_hash_matches_plain_python_and_stays_below_2_63():
    """The batched int64 hash equals unbounded-integer 32-bit arithmetic,
    for uids and steps up to 2^31 - 1, so it is the same function on any
    device."""
    rng = np.random.default_rng(0)
    uids = np.concatenate([[0, 1, 2**31 - 1], rng.integers(0, 2**31 - 1, 61)])
    steps = np.concatenate([[0, 2**31 - 1, 5], rng.integers(0, 2**31 - 1, 61)])
    for tag in (0, 1, 2):
        keys = S.stream_keys(torch.from_numpy(uids), torch.from_numpy(steps), tag=tag)
        assert keys.dtype == torch.int64
        assert keys.tolist() == [_key_py(int(u), int(s), tag) for u, s in zip(uids, steps)]
    u = S.uniforms(keys[:3], 5)
    for r, k in enumerate(keys[:3].tolist()):
        for i in range(5):
            h = _fmix32_py(k ^ ((i * 0x9E3779B9) & M32))
            assert u[r, i].item() == ((h >> 9) + 0.5) / 2**23


def test_hash_is_deterministic_and_independent_of_batch_order():
    uids = torch.arange(64, dtype=torch.int32)
    steps = torch.arange(64, dtype=torch.int32) % 7
    a = S.uniforms(S.stream_keys(uids, steps), 300)
    assert torch.equal(a, S.uniforms(S.stream_keys(uids, steps), 300))
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(S.uniforms(S.stream_keys(uids[perm], steps[perm]), 300), a[perm])
    assert bool(((a > 0) & (a < 1)).all())
    assert abs(a.mean().item() - 0.5) < 0.01
    # tags and seeds give other streams
    assert not torch.equal(S.stream_keys(uids, steps, tag=1), S.stream_keys(uids, steps))
    assert not torch.equal(S.stream_keys(uids, steps, seed=1), S.stream_keys(uids, steps))


def test_greedy_stays_the_first_argmax():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, -1.0, 3.0, 0.0]])
    assert PT.sample_tokens(logits).tolist() == [1, 0]
    assert PT.sample_tokens(logits, temperature=0.0, uids=torch.zeros(2),
                            steps=torch.zeros(2)).dtype == torch.int32
    with pytest.raises(ValueError, match="uids and steps"):
        PT.sample_tokens(logits, temperature=0.5)


@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0, 2.0])
def test_sampler_matches_softmax_like_the_reference(temperature):
    """20 000 draws over one fixed 64-way logits row, each from its own
    (uid, step) stream: TV < 0.05 against softmax(l / T), which the JAX
    sample_tokens with per-row keys also meets on the same logits."""
    rng = np.random.default_rng(int(temperature * 10))
    raw = (rng.normal(size=64) * 1.5).astype(np.float32)
    n = 20000
    want = _softmax(raw.astype(np.float64) / temperature)
    uids = torch.arange(n) % 97
    steps = torch.arange(n) // 97
    got = PT.sample_tokens(torch.from_numpy(raw).expand(n, 64), temperature=temperature,
                           uids=uids, steps=steps)
    assert _tv(got.numpy(), want) < 0.05
    keys = jax.vmap(RS.slot_key)(jnp.asarray(uids.numpy()), jnp.asarray(steps.numpy()))
    ref = RT.sample_tokens(jnp.broadcast_to(jnp.asarray(raw), (n, 64)),
                           temperature=temperature, key=keys)
    assert _tv(np.asarray(ref), want) < 0.05


@pytest.mark.parametrize("case", range(6))
def test_verify_first_token_matches_target(case):
    """tests/test_spec_decode.py:141: whatever the point-mass draft, the
    first emitted token is distributed as the target (TV < 0.05), for the
    port's verify_sampled and the reference's on the same inputs."""
    rng = np.random.default_rng(case)
    v, t, n = 4, 3, 20000
    raw = rng.normal(size=v) * 1.5
    draft_tok = int(rng.integers(0, v))
    logits = np.broadcast_to(raw, (n, t, v)).astype(np.float32)
    draft = np.full((n, t - 1), draft_tok, np.int32)
    d_len = np.full((n,), t - 1, np.int32)
    uids, steps = np.arange(n, dtype=np.int32), np.zeros((n,), np.int32)
    emit, n_acc = verify_sampled(*(torch.from_numpy(a) for a in (logits, draft, d_len, uids,
                                                                 steps)), 1.0)
    want = _softmax(raw)
    assert _tv(emit[:, 0].numpy(), want) < 0.05
    assert emit.dtype == n_acc.dtype == torch.int32
    assert bool(((n_acc >= 0) & (n_acc <= t - 1)).all())
    r_emit, _ = r_verify_sampled(*(jnp.asarray(a) for a in (logits, draft, d_len, uids,
                                                            steps)), 1.0)
    assert _tv(np.asarray(r_emit)[:, 0], want) < 0.05


def test_verify_acceptance_probability_is_p_draft():
    """tests/test_spec_decode.py:161: a draft token of target probability
    ~1 is always accepted, of ~0 always rejected (and the token after the
    rejection is a target sample), and in between the acceptance rate is
    within 0.02 of p(d)."""
    v, n = 4, 400
    hot = np.full((n, 2, v), -20.0, np.float32)
    hot[:, :, 1] = 20.0
    uids, steps = torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    d_len = torch.ones(n, dtype=torch.int32)
    emit, n_acc = verify_sampled(torch.from_numpy(hot), torch.full((n, 1), 1), d_len, uids,
                                 steps, 1.0)
    assert int(n_acc.sum()) == n
    emit, n_acc = verify_sampled(torch.from_numpy(hot), torch.full((n, 1), 2), d_len, uids,
                                 steps, 1.0)
    assert int(n_acc.sum()) == 0 and bool((emit[:, 0] == 1).all())
    n = 20000
    raw = torch.tensor([0.3, -0.2, 1.1, 0.0])
    p = torch.softmax(raw / 0.8, 0)
    emit, n_acc = verify_sampled(raw.expand(n, 2, 4).contiguous(), torch.full((n, 1), 0),
                                 torch.ones(n, dtype=torch.int32),
                                 torch.arange(n, dtype=torch.int32),
                                 torch.full((n,), 3, dtype=torch.int32), 0.8)
    assert abs(n_acc.float().mean().item() - p[0].item()) < 0.02
    # after a rejection the residual excludes the draft token
    rejected = n_acc == 0
    assert not bool((emit[rejected, 0] == 0).any())


# -- the engine --------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    cfg = PC.get_smoke_config("qwen3-4b")
    return cfg, PT.init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def mamba():
    cfg = PC.get_smoke_config("mamba2-2.7b")
    return cfg, PT.init_params(cfg, 0, device="cpu")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(setup, prompts, **kw):
    cfg, params = setup
    base = dict(max_seq=96, prefill_chunk=16, max_new_tokens=6, max_batch=3,
                temperature=0.8)
    eng = PS.StreamedBatchEngine(cfg, params, PS.ServeConfig(**{**base, **kw}), device="cpu")
    uids = [eng.submit(p) for p in prompts]
    out = eng.run()
    if eng.paged:
        eng.kv.check_invariants()
    return eng, [out[u] for u in uids]


def test_temperature_paged_equals_contiguous(qwen):
    """tests/test_kv_cache.py:195, and the slot / batch independence: the
    same requests paged, contiguous, one slot at a time, in a pool small
    enough to preempt, and sharing a prefix give the same tokens per uid,
    unlike a greedy serve's."""
    prompts = _prompts(qwen[0].vocab_size, (24, 32, 40, 17), 21)
    _, want = _serve(qwen, prompts, max_new_tokens=10)
    _, greedy = _serve(qwen, prompts, temperature=0.0, max_new_tokens=10)
    assert any(not np.array_equal(a, b) for a, b in zip(want, greedy))
    runs = [dict(paged=True, block_size=16), dict(max_batch=1),
            dict(paged=True, block_size=16, fused_prefill=False),
            dict(paged=True, block_size=16, max_batch=2, num_blocks=6)]
    for kw in runs:
        eng, got = _serve(qwen, prompts, max_new_tokens=10, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=str(kw))
    assert eng.preemptions >= 1
    head = _prompts(qwen[0].vocab_size, (32,), 5)[0]
    shared = [np.concatenate([head, p]) for p in prompts]
    _, a = _serve(qwen, shared, paged=True, block_size=16)
    eng, b = _serve(qwen, shared, paged=True, block_size=16, prefix_sharing=True)
    assert eng.prefix_hits == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_engine_stream_equals_generate_row(qwen):
    """Request uid 0 draws from stream (0, i), as row 0 of ServingEngine.generate."""
    cfg, params = qwen
    p = _prompts(cfg.vocab_size, (24,), 3)[0]
    _, got = _serve(qwen, [p], paged=True, block_size=16)
    scfg = PS.ServeConfig(max_seq=96, prefill_chunk=16, max_new_tokens=6, temperature=0.8)
    single = PS.ServingEngine(cfg, params, scfg, device="cpu",
                              unembed=PT.unembed_f32(cfg, params))
    np.testing.assert_array_equal(single.generate(p[None])[0].numpy(), got[0])


class _EchoDrafter:
    """Proposes the context's last ``k`` tokens: a draft every tick."""

    def propose(self, context, k):
        return np.asarray(context[-k:], np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_spec_temperature_run_completes(qwen, paged):
    """tests/test_spec_decode.py:247: rejection-sampling mode gives the right
    lengths and valid tokens through verify ticks, and returns every page."""
    cfg, params = qwen
    prompts = _prompts(cfg.vocab_size, (24, 30, 40), 17)
    kw = dict(max_seq=96, prefill_chunk=16, max_new_tokens=12, max_batch=3,
              temperature=0.8, spec_decode=True, spec_k=3)
    if paged:
        kw.update(paged=True, block_size=16)
    eng = PS.StreamedBatchEngine(cfg, params, PS.ServeConfig(**kw), device="cpu",
                                 drafter=_EchoDrafter())
    uids = [eng.submit(p) for p in prompts]
    out = eng.run()
    got = [out[u] for u in uids]
    assert [len(g) for g in got] == [12, 12, 12]
    assert eng.spec_ticks > 0 and eng.spec_accepted <= eng.spec_proposed
    assert all(((g >= 0) & (g < cfg.padded_vocab)).all() for g in got)
    if paged:
        assert eng.kv.pages_in_use == 0


@pytest.mark.parametrize("extra", [dict(), dict(paged=True, block_size=16),
                                   dict(state_snapshots=True)], ids=str)
def test_mamba_at_temperature(mamba, extra):
    """The mamba step samples from the same streams: contiguous, beside a
    pool and with snapshots give the same tokens."""
    prompts = _prompts(mamba[0].vocab_size, (20, 33, 17), 1)
    _, want = _serve(mamba, prompts)
    _, got = _serve(mamba, prompts, **extra)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_launcher_temperature_and_sharing(capsys, tmp_path):
    store = tmp_path / "store.npz"
    args = ["--device", "cpu", "--paged", "--requests", "3", "--prompt-len", "40",
            "--new-tokens", "4", "--prefill-chunk", "16", "--block-size", "16",
            "--temperature", "0.8", "--prefix-sharing", "--prefix-store", str(store)]
    pserve.main(args)
    first = capsys.readouterr().out
    assert "temperature 0.8" in first and "prefix-sharing 2 hits" in first
    assert "cow_forks" in first and "0 restored" in first and store.exists()
    pserve.main(args)
    second = capsys.readouterr().out
    assert "restored" in second and " 0 restored" not in second
    assert first.split("\n")[1:] == second.split("\n")[1:]  # the same tokens
    with pytest.raises(SystemExit):
        pserve.main(["--device", "cpu", "--prefix-sharing"])
