"""The port's model code against the JAX reference on equal weights and
inputs: configs, the weight bridge, layers, both paged attention branches,
the fused prefill chunk and the paged decode step.  All f32; tolerance
1e-5 abs/rel unless stated (sums run in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
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
    ref = getattr(RC, getter)("qwen3-4b")
    port = getattr(PC, getter)("qwen3-4b")
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert np.dtype(a).name == str(b).removeprefix("torch."), f.name
        elif f.name == "layer_unit":
            assert [dataclasses.asdict(s) for s in a] == [dataclasses.asdict(s) for s in b]
        else:
            assert a == b, f.name
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
    _, pcfg, _, params = smoke
    pp = PT._at(params["blocks"]["layer0"]["mixer"], 0)
    x = torch.zeros((1, 2, pcfg.d_model))
    with pytest.raises(NotImplementedError, match="contiguous"):
        PA.attention_apply(pp, x, **_attn_kw(pcfg))
    pools = {"k": torch.zeros((3, 8, 2, 16)), "v": torch.zeros((3, 8, 2, 16))}
    with pytest.raises(NotImplementedError, match="speculative"):
        PA.attention_apply(pp, x, cache=pools, cur_len=torch.zeros(1, dtype=torch.int32),
                           page_table=torch.zeros((1, 2), dtype=torch.int32),
                           **_attn_kw(pcfg))


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
