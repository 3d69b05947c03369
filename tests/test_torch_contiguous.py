"""The port's contiguous attention cache and scatter-after-prefill against
the JAX reference on the CPU, on equal weights (the bridge) and inputs (a
numpy seed), smoke qwen3-4b, f32: ``decode_attention``, the three
contiguous branches of ``attention_apply``, ``init_cache``, the contiguous
prefill chunk and decode steps, the page scatter / gather (fp32 bit-equal,
int8 / fp8 codes and scales bit-equal to the reference's eager
quantization), ``ServingEngine.generate``, the contiguous, contiguous +
spec and non-fused paged engines (greedy tokens per uid and counters equal
to the JAX engine's) and the launcher.  Tolerance 1e-5 abs/rel (``TOL`` of
``tests/test_torch_model.py``: sums run in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.kernels import quant as RQ
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.runtime import kv_cache as RK
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.launch import serve as pserve
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT
from repro_torch.runtime import kv_cache as PK
from repro_torch.runtime import serving as PS

TOL = dict(atol=1e-5, rtol=1e-5)
LENS = (24, 17, 40, 9, 33, 16)
ENGINE_KW = dict(max_seq=48, prefill_chunk=16, max_new_tokens=6, max_batch=2, block_size=8)


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
def smoke():
    rcfg = RC.get_smoke_config("qwen3-4b")
    pcfg = PC.get_smoke_config("qwen3-4b")
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, tree, bridge.params_from_numpy(tree, pcfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)


def _mixer(tree, params):
    pr = {k: v[0] if not isinstance(v, dict) else {"scale": v["scale"][0]}
          for k, v in tree["blocks"]["layer0"]["mixer"].items()}
    return pr, PT._at(params["blocks"]["layer0"]["mixer"], 0)


# -- decode_attention --------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("case", [
    dict(s=40, window=0, cur=[0, 13, 35]),
    dict(s=40, window=0, cur=[3, 20, 31], softcap=30.0),
    dict(s=40, window=12, cur=[2, 20, 35]),  # a window over a full-length cache
    dict(s=8, window=8, cur=[2, 7, 30]),  # an SWA ring: S == window, wrapped rows
], ids=str)
def test_decode_attention_matches_reference(t, case):
    rng = np.random.default_rng(t)
    b, h, hkv, hd, s = 3, 4, 2, 16, case["s"]
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    cl = np.array(case["cur"], np.int32)
    kw = dict(window=case["window"], softcap_val=case.get("softcap", 0.0))
    want = RA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               cur_len=jnp.asarray(cl), **kw)
    got = PA.decode_attention(_t(q), _t(k), _t(v), cur_len=_t(cl), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a scalar cur_len puts every row at one position
    want = RA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               cur_len=jnp.int32(cl[1]), **kw)
    got = PA.decode_attention(_t(q), _t(k), _t(v), cur_len=torch.tensor(int(cl[1])), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- attention_apply: the three contiguous branches --------------------------------


@pytest.mark.parametrize("case", [
    dict(s=1, s_cache=32, cur=[5, 31, 0]),
    dict(s=4, s_cache=32, cur=[5, 30, 0]),  # row 1's tail runs past the cache: dropped
    dict(s=1, s_cache=8, window=8, cur=[5, 19, 0]),  # ring
], ids=str)
def test_attention_contiguous_decode_matches_reference(smoke, case):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(11)
    pr, pp = _mixer(tree, params)
    b, s = 3, case["s"]
    shape = (b, case["s_cache"], rcfg.n_kv_heads, rcfg.head_dim)
    k_c = rng.standard_normal(shape).astype(np.float32)
    v_c = rng.standard_normal(shape).astype(np.float32)
    cl = np.array(case["cur"], np.int32)
    pos = cl[:, None] + np.arange(s)
    x = rng.standard_normal((b, s, rcfg.d_model)).astype(np.float32)
    window = case.get("window", 0)
    out_r, c_r = RA.attention_apply(
        _j(pr), jnp.asarray(x), positions=jnp.asarray(pos), window=window,
        cache={"k": jnp.asarray(k_c), "v": jnp.asarray(v_c)}, cur_len=jnp.asarray(cl),
        **_attn_kw(rcfg))
    cache = {"k": _t(k_c), "v": _t(v_c)}
    out_p, _ = PA.attention_apply(pp, _t(x), positions=_t(pos), window=window, cache=cache,
                                  cur_len=_t(cl), **_attn_kw(pcfg))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(c_r[key]), **TOL)


@pytest.mark.parametrize("s,q_offset", [(16, 16), (7, 32), (16, 24)])
def test_attention_streamed_continuation_matches_reference(smoke, s, q_offset):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(12)
    pr, pp = _mixer(tree, params)
    shape = (1, 48, rcfg.n_kv_heads, rcfg.head_dim)
    k_c = rng.standard_normal(shape).astype(np.float32)
    v_c = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((1, s, rcfg.d_model)).astype(np.float32)
    pos = q_offset + np.arange(s)
    out_r, c_r = RA.attention_apply(
        _j(pr), jnp.asarray(x), positions=jnp.asarray(pos), chunk=rcfg.attn_chunk,
        cache={"k": jnp.asarray(k_c), "v": jnp.asarray(v_c)}, q_offset=q_offset,
        **_attn_kw(rcfg))
    cache = {"k": _t(k_c), "v": _t(v_c)}
    out_p, _ = PA.attention_apply(pp, _t(x), positions=_t(pos), cache=cache,
                                  q_offset=q_offset, **_attn_kw(pcfg))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(c_r[key]), **TOL)


@pytest.mark.parametrize("case", [
    dict(s=16, s_cache=48),
    dict(s=20, s_cache=8, window=8),  # a ring shorter than the chunk: rolled tail
    dict(s=5, s_cache=8, window=8),
], ids=str)
def test_attention_first_chunk_matches_reference(smoke, case):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(13)
    pr, pp = _mixer(tree, params)
    s, window = case["s"], case.get("window", 0)
    shape = (2, case["s_cache"], rcfg.n_kv_heads, rcfg.head_dim)
    k_c = rng.standard_normal(shape).astype(np.float32)
    v_c = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    out_r, c_r = RA.attention_apply(
        _j(pr), jnp.asarray(x), positions=jnp.asarray(pos), chunk=rcfg.attn_chunk,
        window=window, cache={"k": jnp.asarray(k_c), "v": jnp.asarray(v_c)},
        **_attn_kw(rcfg))
    cache = {"k": _t(k_c), "v": _t(v_c)}
    out_p, _ = PA.attention_apply(pp, _t(x), positions=_t(pos), window=window, cache=cache,
                                  **_attn_kw(pcfg))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(c_r[key]), **TOL)


# -- caches and the contiguous steps -----------------------------------------------


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("window", [0, 8])
def test_init_cache_matches_reference_layout(ring, window):
    rcfg = dataclasses.replace(RC.get_smoke_config("qwen3-4b"), sliding_window=window)
    pcfg = dataclasses.replace(PC.get_smoke_config("qwen3-4b"), sliding_window=window)
    ref = RT.init_cache(rcfg, 3, 40, ring=ring)
    port = PT.init_cache(pcfg, 3, 40, ring=ring, device="cpu")
    assert set(port["blocks"]) == set(ref["blocks"])
    for name, c in ref["blocks"].items():
        assert set(port["blocks"][name]) == set(c) == {"k", "v"}
        for k, v in c.items():
            leaf = port["blocks"][name][k]
            assert tuple(leaf.shape) == v.shape
            assert v.shape[2] == (8 if ring and window else 40)
            assert str(leaf.dtype).removeprefix("torch.") == np.dtype(v.dtype).name
            assert not leaf.any()


def _filled(cfg, bsz, seq, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_repeats, bsz, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"blocks": {"layer0": {"k": rng.standard_normal(shape).astype(np.float32),
                                  "v": rng.standard_normal(shape).astype(np.float32)}}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


@pytest.mark.parametrize("first", [True, False])
def test_prefill_chunk_matches_reference(smoke, first):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(14)
    pos0, s = (0, 16) if first else (16, 16)
    caches = _filled(rcfg, 1, 48, 15)
    if first:  # a fresh cache, as the streamed prefill starts from
        caches = jax.tree.map(np.zeros_like, caches)
    tok = rng.integers(0, rcfg.vocab_size, (1, s)).astype(np.int32)
    scfg = RS.ServeConfig(max_seq=48, prefill_chunk=s)
    fn = RS.ServingEngine(rcfg, _j(tree), scfg)._prefill_chunk_fn(s, first, pos0)
    logits_r, c_r = fn(_j(tree), _j(caches), jnp.asarray(tok), None, None)
    pc = _torch_tree(caches)
    logits_p, _ = PT.prefill_chunk(pcfg, params, _t(tok), pc, pos0,
                                   unembed=PT.unembed_f32(pcfg, params))
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(pc["blocks"]["layer0"][key].numpy(),
                                   np.asarray(c_r["blocks"]["layer0"][key]), **TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_decode_steps_match_reference(smoke, t):
    """``decode_step`` (t = 1) and ``decode_step_multi`` (a draft block
    whose tail runs past the cache in row 1) at per-slot positions."""
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(16)
    caches = _filled(rcfg, 3, 40, 17)
    cl = np.array([5, 38, 20], np.int32)
    tok = rng.integers(0, rcfg.vocab_size, (3, t)).astype(np.int32)
    step_r, step_p = ((RT.decode_step, PT.decode_step) if t == 1
                      else (RT.decode_step_multi, PT.decode_step_multi))
    logits_r, c_r = step_r(rcfg, _j(tree), jnp.asarray(tok), _j(caches), jnp.asarray(cl))
    pc = _torch_tree(caches)
    logits_p, _ = step_p(pcfg, params, _t(tok), pc, _t(cl),
                         unembed=PT.unembed_f32(pcfg, params))
    assert logits_p.shape == (3, t, pcfg.padded_vocab)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(pc["blocks"]["layer0"][key].numpy(),
                                   np.asarray(c_r["blocks"]["layer0"][key]), **TOL)


def test_decode_step_multi_rejects_a_ring(smoke):
    _, pcfg, _, params = smoke
    cfg = dataclasses.replace(pcfg, sliding_window=8)
    caches = PT.init_cache(cfg, 2, 32, ring=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        PT.decode_step_multi(cfg, params, torch.zeros((2, 3), dtype=torch.int32), caches,
                             torch.zeros(2, dtype=torch.int32),
                             unembed=PT.unembed_f32(cfg, params))


# -- page scatter / gather ---------------------------------------------------------


GEOM = dict(max_batch=2, max_seq=64, block_size=16)


def _pool_pair(rcfg, pcfg, kv_dtype, seed):
    """A reference and a port pool with equal (random) contents, slot 1
    owning 3 pages, slot 0 one page."""
    ref = RK.PagedKVCache(rcfg, kv_dtype=kv_dtype, **GEOM)
    port = PK.PagedKVCache(pcfg, kv_dtype=kv_dtype, device="cpu", **GEOM)
    rng = np.random.default_rng(seed)
    for kv in (ref, port):
        assert kv.alloc(0, 10) and kv.alloc(1, 40)
    for name, c in port.pools["blocks"].items():
        for key, leaf in c.items():
            if key.endswith("_scale"):
                a = rng.uniform(0.01, 0.05, leaf.shape).astype(np.float32)
            elif leaf.dtype == torch.float32:
                a = rng.standard_normal(leaf.shape).astype(np.float32)
            else:
                a = rng.integers(-100, 100, leaf.shape).astype(np.float32)
            leaf.copy_(torch.from_numpy(a).to(leaf.dtype))
            ref.pools["blocks"][name][key] = jnp.asarray(leaf.float().numpy()).astype(
                ref.pools["blocks"][name][key].dtype)
    return ref, port


@pytest.mark.parametrize("start_page", [0, 1])
def test_fp32_scatter_and_gather_bit_equal_to_reference(smoke, start_page):
    rcfg, pcfg, _, _ = smoke
    ref, port = _pool_pair(rcfg, pcfg, "fp32", 21)
    src = _filled(rcfg, 1, 64, 22)
    ref.scatter(1, _j(src), 40, start_page=start_page)
    port.scatter(1, _torch_tree(src), 40, start_page=start_page)
    for key in ("k", "v"):
        np.testing.assert_array_equal(port.pools["blocks"]["layer0"][key].numpy(),
                                      np.asarray(ref.pools["blocks"]["layer0"][key]))
    got, want = port.gather(1, 40), ref.gather(1, 40)
    for key in ("k", "v"):
        leaf = got["blocks"]["layer0"][key]
        assert tuple(leaf.shape) == want["blocks"]["layer0"][key].shape == (
            rcfg.n_repeats, 1, 48, rcfg.n_kv_heads, rcfg.head_dim)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want["blocks"]["layer0"][key]))
        # a copy: writing the pool leaves the gathered rows alone
        before = leaf.clone()
        port.pools["blocks"]["layer0"][key].add_(1.0)
        torch.testing.assert_close(leaf, before, rtol=0, atol=0)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("start_page", [0, 1])
def test_quantized_scatter_and_gather_bit_equal_to_reference(smoke, kv_dtype, start_page):
    """Codes and scales written by the scatter equal the reference's
    ``scales_of`` / ``quantize`` called eagerly on the same page rows; the
    gather equals its eager ``dequantize`` of the pool's pages."""
    rcfg, pcfg, _, _ = smoke
    _, port = _pool_pair(rcfg, pcfg, kv_dtype, 23)
    src = _filled(rcfg, 1, 64, 24)
    bs = GEOM["block_size"]
    untouched = {k: v.clone() for k, v in port.pools["blocks"]["layer0"].items()}
    port.scatter(1, _torch_tree(src), 40, start_page=start_page)
    pages = port.slot_pages(1)[start_page:3]
    c = port.pools["blocks"]["layer0"]
    for key in ("k", "v"):
        rows = src["blocks"]["layer0"][key][:, 0, start_page * bs: 3 * bs]
        rows = jnp.asarray(rows.reshape(rows.shape[0], -1, bs, *rows.shape[2:]))
        scales = RQ.scales_of(rows, kv_dtype)
        codes = RQ.quantize(rows, scales, kv_dtype)
        np.testing.assert_array_equal(c[f"{key}_scale"][:, pages].numpy(), np.asarray(scales))
        np.testing.assert_array_equal(c[key][:, pages].float().numpy(),
                                      np.asarray(codes).astype(np.float32))
        others = [p for p in range(port.num_blocks) if p not in pages]
        for k2 in (key, f"{key}_scale"):
            torch.testing.assert_close(c[k2][:, others], untouched[k2][:, others],
                                       rtol=0, atol=0)
    got = port.gather(1, 40)
    own = port.slot_pages(1)[:3]
    for key in ("k", "v"):
        want = RQ.dequantize(jnp.asarray(c[key][:, own].float().numpy()).astype(
            RQ.storage_dtype(kv_dtype)), jnp.asarray(c[f"{key}_scale"][:, own].numpy()))
        want = np.asarray(want).reshape(rcfg.n_repeats, 48, rcfg.n_kv_heads, rcfg.head_dim)
        np.testing.assert_array_equal(got["blocks"]["layer0"][key][:, 0].numpy(), want)


def test_int8_scatter_gather_within_half_scale(smoke):
    """The round trip of ``tests/test_quant_kv.py::
    test_scatter_gather_within_half_scale`` on the port: every gathered row
    within half its page's scale of the scattered one."""
    _, pcfg, _, _ = smoke
    kv = PK.PagedKVCache(pcfg, max_batch=2, max_seq=64, block_size=16, kv_dtype="int8",
                         device="cpu")
    assert kv.alloc(0, 40)
    cache = _torch_tree(_filled(pcfg, 1, 48, 11))
    kv.scatter(0, cache, 40)
    got = kv.gather(0, 40)
    bs, n = kv.block_size, kv.pages_for(40)
    for key in ("k", "v"):
        want = cache["blocks"]["layer0"][key][:, :, : n * bs].numpy()
        have = got["blocks"]["layer0"][key].numpy()
        r, b, _, hkv, hd = want.shape
        pages = want.reshape(r, b, n, bs, hkv, hd)
        bound = np.repeat((np.abs(pages).max(axis=(3, 5)) / 127.0)[:, :, :, None], bs, 3) / 2
        err = np.abs(have - want).reshape(r, b, n, bs, hkv, hd).max(-1)
        assert np.all(err <= bound + 1e-6), np.max(err - bound)


# -- engines -----------------------------------------------------------------------


def _prompts(vocab, lens=LENS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _tiled(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, vocab, n), 3).astype(np.int32) for n in (6, 5, 8, 4)]


COUNTERS = ("decode_steps", "admissions", "peak_active", "preemptions", "spec_ticks",
            "spec_proposed", "spec_accepted")


@pytest.mark.parametrize("extra", [
    dict(), dict(spec_decode=True, spec_k=3), dict(paged=True, fused_prefill=False),
    dict(paged=True, fused_prefill=False, kv_dtype="int8"),
], ids=str)
def test_engine_matches_reference(smoke, extra):
    """Contiguous, contiguous + spec (tiled prompts, so prompt lookup
    drafts) and non-fused paged engines: tokens per uid and counters equal
    the JAX engine's (over int8 pages too, where the scatter quantizes)."""
    rcfg, pcfg, tree, params = smoke
    prompts = (_tiled(rcfg.vocab_size) if extra.get("spec_decode")
               else _prompts(rcfg.vocab_size))
    kw = dict(ENGINE_KW, **extra)
    ref = RS.StreamedBatchEngine(rcfg, _j(tree), RS.ServeConfig(**kw))
    r_uids = [ref.submit(p) for p in prompts]
    want = ref.run()
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**kw), device="cpu")
    assert eng.paged == ref.paged and eng.scfg.fused_prefill == ref.scfg.fused_prefill
    p_uids = [eng.submit(p) for p in prompts]
    got = eng.run()
    for ru, pu in zip(r_uids, p_uids):
        np.testing.assert_array_equal(got[pu], want[ru])
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(ref, name), name
    assert not extra.get("spec_decode") or eng.spec_accepted > 0
    if eng.paged:
        assert eng.kv.pages_in_use == 0
        eng.kv.check_invariants()


def test_contiguous_engine_is_the_default(smoke):
    _, pcfg, _, params = smoke
    assert PS.ServeConfig().paged is False
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**ENGINE_KW), device="cpu")
    assert eng.kv is None and not eng.scfg.fused_prefill
    k = eng.caches["blocks"]["layer0"]["k"]
    assert tuple(k.shape) == (pcfg.n_repeats, 2, 48, pcfg.n_kv_heads, pcfg.head_dim)


@pytest.mark.parametrize("b", [1, 2])
def test_generate_matches_reference(smoke, b):
    rcfg, pcfg, tree, params = smoke
    scfg = dict(max_seq=48, prefill_chunk=16, max_new_tokens=6)
    tokens = np.stack(_prompts(rcfg.vocab_size, (24,) * b, seed=5))
    want = RS.ServingEngine(rcfg, _j(tree), RS.ServeConfig(**scfg)).generate(
        jnp.asarray(tokens))
    single = PS.ServingEngine(pcfg, params, PS.ServeConfig(**scfg), device="cpu",
                              unembed=PT.unembed_f32(pcfg, params))
    got = single.generate(tokens)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_launcher_serves_a_transformer_contiguously(capsys):
    pserve.main(["--device", "cpu", "--requests", "3", "--prompt-len", "20",
                 "--new-tokens", "4", "--prefill-chunk", "8", "--block-size", "8",
                 "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "3 requests x 20 prompt -> 4 new tokens each" in out
    assert "contiguous slot cache" in out and "preemptions" not in out


def test_launcher_sequential_equals_the_batched_engine(capsys):
    args = ["--device", "cpu", "--requests", "2", "--prompt-len", "12", "--new-tokens",
            "5", "--prefill-chunk", "8", "--block-size", "8", "--max-batch", "2"]
    pserve.main(args + ["--sequential"])
    seq = capsys.readouterr().out
    assert "sequential-batch, contiguous cache" in seq
    assert "2 requests x 12 prompt -> 5 new tokens each" in seq
    pserve.main(args)
    batched = capsys.readouterr().out
    rows = [line.split(": ", 1)[1] for line in seq.splitlines() if "] req" in line]
    assert rows == [line.split(": ", 1)[1] for line in batched.splitlines()
                    if "] req" in line]
