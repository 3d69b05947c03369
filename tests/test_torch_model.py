"""The port's model code against the JAX reference on equal weights and
inputs: configs, the weight bridge, layers, both paged attention branches
(single-token and draft-block decode, fused prefill) over full-precision
and int8 / fp8 pools, the fused prefill chunk and the paged decode steps.
All f32; tolerance 1e-5 abs/rel unless stated (sums run in another
order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.kernels import quant as RQ
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.kernels import quant as PQ
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

TOL = dict(atol=1e-5, rtol=1e-5)


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


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_reference_field_by_field(getter):
    assert PC.list_archs() == ["qwen3-4b", "mamba2-2.7b"]
    for arch in PC.list_archs():
        ref = getattr(RC, getter)(arch)
        port = getattr(PC, getter)(arch)
        for f in dataclasses.fields(ref):
            a, b = getattr(ref, f.name), getattr(port, f.name)
            if f.name in ("param_dtype", "compute_dtype"):
                assert np.dtype(a).name == str(b).removeprefix("torch."), (arch, f.name)
            elif f.name == "layer_unit":
                assert [dataclasses.asdict(s) for s in a] == [dataclasses.asdict(s) for s in b]
            else:
                assert a == b, (arch, f.name)
        assert (port.padded_vocab, port.n_repeats) == (ref.padded_vocab, ref.n_repeats)
        assert port.spec_window(port.layer_unit[0]) == ref.spec_window(ref.layer_unit[0])


def test_bridge_copies_every_leaf(smoke):
    _, pcfg, tree, params = smoke

    def walk(t, p):
        assert set(t) == set(p)
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], p[k])
            else:
                np.testing.assert_array_equal(p[k].numpy(), t[k])
    walk(tree, params)
    assert "unembed" not in params  # qwen3-4b ties its embeddings
    assert params["embed"].shape == (pcfg.padded_vocab, pcfg.d_model)


def test_bridge_rejects_misshapen_trees(smoke):
    _, pcfg, tree, _ = smoke
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        bridge.params_from_numpy(bad, pcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy({k: v for k, v in tree.items() if k != "final_norm"},
                                 pcfg, device="cpu")


def test_init_params_shapes_and_distributions(smoke):
    _, pcfg, tree, _ = smoke
    params = PT.init_params(pcfg, 0, device="cpu")
    fresh = jax.tree.map(np.asarray, RT.init_params(
        RC.get_smoke_config("qwen3-4b"), jax.random.PRNGKey(0)))
    flat_p = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), params))[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(fresh)[0])
    for path, a in flat_p:
        r = flat_r[path]
        assert a.shape == r.shape, path
        if path[-1].key == "scale":
            assert not a.any()
        else:  # same distribution: std within 10% of the reference draw's
            assert abs(a.std() / r.std() - 1) < 0.1, path
            assert np.abs(a).max() <= np.abs(r).max() * 1.5 + 1e-6, path
    g1 = PT.init_params(pcfg, torch.Generator().manual_seed(3), device="cpu")
    g2 = PT.init_params(pcfg, 3, device="cpu")
    torch.testing.assert_close(g1["embed"], g2["embed"], rtol=0, atol=0)


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(0, 0.3, 16).astype(np.float32)
    np.testing.assert_allclose(
        PL.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))), **TOL)
    for pos in (np.arange(7, 12), rng.integers(0, 5000, (2, 5))):
        s_r, c_r = RL.rope_angles(jnp.asarray(pos), 16, 1e6)
        s_p, c_p = PL.rope_angles(_t(pos), 16, 1e6)
        np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), atol=2e-4, rtol=1e-5)
        np.testing.assert_allclose(c_p.numpy(), np.asarray(c_r), atol=2e-4, rtol=1e-5)
        if pos.ndim == 1:
            s_r, c_r, s_p, c_p = s_r[None], c_r[None], s_p[None], c_p[None]
        np.testing.assert_allclose(
            PL.apply_rope(_t(x), _t(s_r), _t(c_r)).numpy(),
            np.asarray(RL.apply_rope(jnp.asarray(x), s_r, c_r)), **TOL)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wi", (16, 32)), ("wg", (16, 32)), ("wo", (32, 16)))}
    np.testing.assert_allclose(
        PL.ffn_apply({k: _t(v) for k, v in p.items()}, _t(x)).numpy(),
        np.asarray(RL.ffn_apply(_j(p), jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(PL.softcap(_t(x * 40), 30.0).numpy(),
                               np.asarray(RL.softcap(jnp.asarray(x * 40), 30.0)), **TOL)


def _pools(rng, nb, bs, hkv, hd, r=None):
    shape = (nb, bs, hkv, hd) if r is None else (r, nb, bs, hkv, hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)


def test_attention_paged_decode_matches_reference(smoke):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(1)
    pr = {k: v[0] if not isinstance(v, dict) else {"scale": v["scale"][0]}
          for k, v in tree["blocks"]["layer0"]["mixer"].items()}
    pp = PT._at(params["blocks"]["layer0"]["mixer"], 0)
    b, bs, n_pages = 3, 8, 4
    k_pool, v_pool = _pools(rng, 1 + b * n_pages, bs, rcfg.n_kv_heads, rcfg.head_dim)
    pt = (rng.permutation(b * n_pages) + 1).reshape(b, n_pages).astype(np.int32)
    pt[2] = 0  # a free slot: all trash
    cl = np.array([13, 31, 0], np.int32)
    x = rng.standard_normal((b, 1, rcfg.d_model)).astype(np.float32)
    out_r, c_r = RA.attention_apply(
        _j(pr), jnp.asarray(x), positions=jnp.asarray(cl[:, None]),
        cache={"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool)},
        cur_len=jnp.asarray(cl), page_table=jnp.asarray(pt), **_attn_kw(rcfg))
    cache = {"k": _t(k_pool), "v": _t(v_pool)}
    out_p, _ = PA.attention_apply(
        pp, _t(x), positions=_t(cl[:, None]), cache=cache, cur_len=_t(cl),
        page_table=_t(pt), **_attn_kw(pcfg))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    live = np.ones(k_pool.shape[0], bool)
    live[0] = False  # the trash page's contents are unspecified
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy()[live],
                                   np.asarray(c_r[key])[live], **TOL)


@pytest.mark.parametrize("s,q_offset", [(16, 0), (16, 16), (7, 32)])
def test_attention_fused_prefill_matches_reference(smoke, s, q_offset):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(2)
    pr = {k: v[0] if not isinstance(v, dict) else {"scale": v["scale"][0]}
          for k, v in tree["blocks"]["layer0"]["mixer"].items()}
    pp = PT._at(params["blocks"]["layer0"]["mixer"], 0)
    bs = 8
    n_ctx = -(-(q_offset + s) // bs)
    k_pool, v_pool = _pools(rng, 9, bs, rcfg.n_kv_heads, rcfg.head_dim)
    pt = (rng.permutation(8)[:n_ctx] + 1)[None].astype(np.int32)
    x = rng.standard_normal((1, s, rcfg.d_model)).astype(np.float32)
    pos = q_offset + np.arange(s)
    out_r, c_r = RA.attention_apply(
        _j(pr), jnp.asarray(x), positions=jnp.asarray(pos), chunk=rcfg.attn_chunk,
        cache={"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool)},
        q_offset=q_offset, page_table=jnp.asarray(pt), **_attn_kw(rcfg))
    cache = {"k": _t(k_pool), "v": _t(v_pool)}
    out_p, _ = PA.attention_apply(
        pp, _t(x), positions=_t(pos), cache=cache, q_offset=q_offset,
        page_table=_t(pt), **_attn_kw(pcfg))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(c_r[key]), **TOL)


def test_attention_rejects_unported_paths(smoke):
    """Attention without any cache (the reference's no-cache branch) is
    ported and matches; an unknown pool type still raises."""
    rcfg, pcfg, tree, params = smoke
    pr, pp = _mixer(tree, params)
    x = np.random.default_rng(9).standard_normal((2, 5, pcfg.d_model)).astype(np.float32)
    pos = np.arange(5)
    out_r, c_r = RA.attention_apply(_j(pr), jnp.asarray(x), positions=jnp.asarray(pos),
                                    chunk=rcfg.attn_chunk, **_attn_kw(rcfg))
    out_p, c_p = PA.attention_apply(pp, _t(x), positions=_t(pos), **_attn_kw(pcfg))
    assert c_r is None and c_p is None
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    with pytest.raises(ValueError, match="kv_dtype"):
        PT.init_paged_cache(pcfg, 2, 4, 8, "int4", device="cpu")


def test_decode_step_paged_logits_match_reference(smoke):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(3)
    b, bs, n_pages = 3, 8, 4
    nb = 1 + b * n_pages
    k_pool, v_pool = _pools(rng, nb, bs, rcfg.n_kv_heads, rcfg.head_dim, r=rcfg.n_repeats)
    pt = (rng.permutation(b * n_pages) + 1).reshape(b, n_pages).astype(np.int32)
    cl = np.array([5, 30, 17], np.int32)
    tok = rng.integers(0, rcfg.vocab_size, (b, 1)).astype(np.int32)
    logits_r, c_r = RT.decode_step_paged(
        rcfg, _j(tree), jnp.asarray(tok),
        {"blocks": {"layer0": {"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool)}}},
        jnp.asarray(pt), jnp.asarray(cl))
    pools = {"blocks": {"layer0": {"k": _t(k_pool), "v": _t(v_pool)}}}
    unembed = PT.unembed_f32(pcfg, params)
    logits_p, _ = PT.decode_step_paged(pcfg, params, _t(tok), pools, _t(pt), _t(cl),
                                       unembed=unembed)
    assert logits_p.shape == (b, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(pools["blocks"]["layer0"][key].numpy()[:, 1:],
                                   np.asarray(c_r["blocks"]["layer0"][key])[:, 1:], **TOL)
    picks, _ = PT.decode_and_sample_paged(pcfg, params, _t(tok), pools, _t(pt), _t(cl),
                                          unembed=unembed)
    assert picks.dtype == torch.int32 and picks.shape == (b,)


def test_prefill_chunk_matches_reference_fused_chunk(smoke):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(4)
    bs, pos0, s = 8, 16, 16
    k_pool, v_pool = _pools(rng, 7, bs, rcfg.n_kv_heads, rcfg.head_dim, r=rcfg.n_repeats)
    pt = np.array([[3, 1, 5, 2]], np.int32)
    tok = rng.integers(0, rcfg.vocab_size, (1, s)).astype(np.int32)
    scfg = RS.ServeConfig(max_seq=32, prefill_chunk=s, paged=True, block_size=bs)
    fn = RS.ServingEngine(rcfg, _j(tree), scfg)._fused_chunk_fn(s, pos0)
    logits_r, c_r = fn(_j(tree), {"blocks": {"layer0": {
        "k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool)}}}, jnp.asarray(pt),
        jnp.asarray(tok))
    pools = {"blocks": {"layer0": {"k": _t(k_pool), "v": _t(v_pool)}}}
    logits_p, _ = PT.prefill_chunk_paged(pcfg, params, _t(tok), pools, _t(pt), pos0,
                                         unembed=PT.unembed_f32(pcfg, params))
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(pools["blocks"]["layer0"][key].numpy(),
                                   np.asarray(c_r["blocks"]["layer0"][key]), **TOL)


# -- draft blocks (speculative verify) and quantized pools ---------------------------


def _mixer(tree, params):
    pr = {k: v[0] if not isinstance(v, dict) else {"scale": v["scale"][0]}
          for k, v in tree["blocks"]["layer0"]["mixer"].items()}
    return pr, PT._at(params["blocks"]["layer0"]["mixer"], 0)


def _draft_case(rng, cfg, s, *, b=3, bs=8, n_pages=4):
    """Pools, a table and positions for a (B, S) block: row 0 crosses a
    page edge, row 1 runs past its table into trash, row 2 is a free slot
    (cur_len 0, all-trash row)."""
    nb = 1 + b * n_pages
    k_pool, v_pool = _pools(rng, nb, bs, cfg.n_kv_heads, cfg.head_dim)
    pt = (rng.permutation(b * n_pages) + 1).reshape(b, n_pages).astype(np.int32)
    cl = np.array([6, n_pages * bs - 2, 0], np.int32)
    pt[2] = 0
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return k_pool, v_pool, pt, cl, x, cl[:, None] + np.arange(s)


def test_attention_paged_draft_block_matches_reference(smoke):
    rcfg, pcfg, tree, params = smoke
    pr, pp = _mixer(tree, params)
    k_pool, v_pool, pt, cl, x, pos = _draft_case(np.random.default_rng(5), rcfg, 5)
    out_r, c_r = RA.attention_apply(
        _j(pr), jnp.asarray(x), positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool)},
        cur_len=jnp.asarray(cl), page_table=jnp.asarray(pt), **_attn_kw(rcfg))
    cache = {"k": _t(k_pool), "v": _t(v_pool)}
    out_p, _ = PA.attention_apply(pp, _t(x), positions=_t(pos), cache=cache, cur_len=_t(cl),
                                  page_table=_t(pt), **_attn_kw(pcfg))
    assert out_p.shape == (3, 5, pcfg.d_model)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    for key in ("k", "v"):  # the trash page's contents are unspecified
        np.testing.assert_allclose(cache[key].numpy()[1:], np.asarray(c_r[key])[1:], **TOL)


def test_decode_step_multi_paged_logits_match_reference(smoke):
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(6)
    b, bs, n_pages, t = 3, 8, 4, 4
    nb = 1 + b * n_pages
    k_pool, v_pool = _pools(rng, nb, bs, rcfg.n_kv_heads, rcfg.head_dim, r=rcfg.n_repeats)
    pt = (rng.permutation(b * n_pages) + 1).reshape(b, n_pages).astype(np.int32)
    cl = np.array([5, 14, 30], np.int32)
    tok = rng.integers(0, rcfg.vocab_size, (b, t)).astype(np.int32)
    logits_r, c_r = RT.decode_step_multi_paged(
        rcfg, _j(tree), jnp.asarray(tok),
        {"blocks": {"layer0": {"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool)}}},
        jnp.asarray(pt), jnp.asarray(cl))
    pools = {"blocks": {"layer0": {"k": _t(k_pool), "v": _t(v_pool)}}}
    logits_p, _ = PT.decode_step_multi_paged(pcfg, params, _t(tok), pools, _t(pt), _t(cl),
                                             unembed=PT.unembed_f32(pcfg, params))
    assert logits_p.shape == (b, t, pcfg.padded_vocab)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(pools["blocks"]["layer0"][key].numpy()[:, 1:],
                                   np.asarray(c_r["blocks"]["layer0"][key])[:, 1:], **TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_init_paged_cache_quantized_layout_matches_reference(smoke, kv_dtype):
    rcfg, pcfg, _, _ = smoke
    ref = RT.init_paged_cache(rcfg, 2, 9, 8, kv_dtype)["blocks"]["layer0"]
    port = PT.init_paged_cache(pcfg, 2, 9, 8, kv_dtype, device="cpu")["blocks"]["layer0"]
    assert set(port) == set(ref) == {"k", "v", "k_scale", "v_scale"}
    for key in port:
        assert tuple(port[key].shape) == ref[key].shape
    assert port["k"].dtype == PQ.storage_dtype(kv_dtype)
    assert port["k_scale"].dtype == torch.float32


def _codes_np(a):
    """int8 / fp8 codes (torch or reference) as comparable integers."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy().astype(int)
    a = np.array(a)
    return (a if a.dtype == np.int8 else a.view(np.uint8)).astype(int)


def _quant_cache(rng, cfg, kv_dtype, nb, bs):
    """A quantized pool with live codes and scales, as (reference cache,
    port cache)."""
    ref, port = {}, {}
    for key in ("k", "v"):
        full = rng.standard_normal((nb, bs, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
        sc = RQ.scales_of(jnp.asarray(full), kv_dtype)
        codes = RQ.quantize(jnp.asarray(full), sc, kv_dtype)
        ref[key], ref[f"{key}_scale"] = codes, sc
        t = torch.from_numpy(_codes_np(codes).astype(np.uint8 if kv_dtype == "fp8" else np.int8))
        port[key] = t.view(torch.float8_e4m3fn) if kv_dtype == "fp8" else t
        port[f"{key}_scale"] = _t(sc)
    return ref, port


def _ref_kv_rows(pr, x, positions, cfg):
    """The reference attention_apply's K/V rows, op for op (eager), so the
    port's write helpers can be fed bit-identical rows."""
    b, s, _ = x.shape
    x = jnp.asarray(x)
    k = (x @ pr["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ pr["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    k = RL.rmsnorm(pr["k_norm"], k)
    sin, cos = RL.rope_angles(jnp.asarray(positions), cfg.head_dim, cfg.rope_theta)
    if positions.ndim == 1:
        sin, cos = sin[None], cos[None]
    return RL.apply_rope(k, sin, cos), v


def _assert_quant_pools(port, ref, live):
    """Codes equal but for rare one-ulp row differences (the projections run
    in another framework), scales within 1e-6 relative."""
    for key in ("k", "v"):
        a, r = _codes_np(port[key])[live], _codes_np(ref[key])[live]
        assert (a != r).mean() <= 0.01, f"{key}: {(a != r).mean():.4f} of codes differ"
        np.testing.assert_allclose(port[f"{key}_scale"].numpy()[live],
                                   np.asarray(ref[f"{key}_scale"])[live], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("s", [1, 3])
def test_attention_quantized_decode_matches_reference(smoke, kv_dtype, s):
    """The quantized decode write (rescale-on-grow, a fresh page's stale
    scale ignored) and the fused-dequant read: codes and scales bit-equal
    to the reference's on the reference's own rows; through the whole
    layer, outputs within 1e-5."""
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(7)
    pr, pp = _mixer(tree, params)
    b, bs, n_pages = 3, 8, 4
    ref, port = _quant_cache(rng, rcfg, kv_dtype, 1 + b * n_pages, bs)
    pt = (rng.permutation(b * n_pages) + 1).reshape(b, n_pages).astype(np.int32)
    cl = np.array([7, 16, 0], np.int32)  # a page edge, a fresh page, a free slot
    pt[2] = 0
    x = rng.standard_normal((b, s, rcfg.d_model)).astype(np.float32)
    pos = cl[:, None] + np.arange(s)
    out_r, c_r = RA.attention_apply(
        _j(pr), jnp.asarray(x), positions=jnp.asarray(pos), cache=dict(ref),
        cur_len=jnp.asarray(cl), page_table=jnp.asarray(pt), **_attn_kw(rcfg))
    live = slice(1, None)

    rows = _ref_kv_rows(_j(pr), x, pos, rcfg)
    idx = pos // bs
    page = np.where(idx < n_pages, np.take_along_axis(pt, np.minimum(idx, n_pages - 1), 1), 0)
    fed = {k: v.clone() for k, v in port.items()}
    for key, r in zip(("k", "v"), rows):
        PA._quant_paged_write(fed[key], fed[f"{key}_scale"], _t(r), _t(page).long(),
                              _t(pos % bs).long(), kv_dtype)
        np.testing.assert_array_equal(_codes_np(fed[key])[live], _codes_np(c_r[key])[live])
        np.testing.assert_array_equal(fed[f"{key}_scale"].numpy()[live],
                                      np.asarray(c_r[f"{key}_scale"])[live])

    out_p, _ = PA.attention_apply(pp, _t(x), positions=_t(pos), cache=port, cur_len=_t(cl),
                                  page_table=_t(pt), **_attn_kw(pcfg))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    _assert_quant_pools(port, c_r, live)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("s,q_offset", [(16, 0), (7, 12)])
def test_attention_quantized_fused_prefill_matches_reference(smoke, kv_dtype, s, q_offset):
    """The quantized prefill write (fresh pages from offset 0, a chunk that
    starts mid-page merging into the previous chunk's page) and the
    dequantized context read into the prefill kernel."""
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(8)
    pr, pp = _mixer(tree, params)
    bs = 8
    ref, port = _quant_cache(rng, rcfg, kv_dtype, 9, bs)
    n_ctx = -(-(q_offset + s) // bs)
    pt = (rng.permutation(8)[:n_ctx] + 1)[None].astype(np.int32)
    x = rng.standard_normal((1, s, rcfg.d_model)).astype(np.float32)
    pos = q_offset + np.arange(s)
    out_r, c_r = RA.attention_apply(
        _j(pr), jnp.asarray(x), positions=jnp.asarray(pos), chunk=rcfg.attn_chunk,
        cache=dict(ref), q_offset=q_offset, page_table=jnp.asarray(pt), **_attn_kw(rcfg))

    rows = _ref_kv_rows(_j(pr), x, pos, rcfg)
    fed = {k: v.clone() for k, v in port.items()}
    for key, r in zip(("k", "v"), rows):
        PA._quant_prefill_write(fed[key], fed[f"{key}_scale"], _t(r), _t(pt), q_offset,
                                kv_dtype)
        np.testing.assert_array_equal(_codes_np(fed[key]), _codes_np(c_r[key]))
        np.testing.assert_array_equal(fed[f"{key}_scale"].numpy(),
                                      np.asarray(c_r[f"{key}_scale"]))

    out_p, _ = PA.attention_apply(pp, _t(x), positions=_t(pos), cache=port,
                                  q_offset=q_offset, page_table=_t(pt), **_attn_kw(pcfg))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    _assert_quant_pools(port, c_r, slice(None))
