"""The port's mamba2 pieces against the JAX package on the CPU, f32: the
plain SSD chunk scan (the kernel's CPU path), ``ops.ssd``, ``mamba_apply``
(prefill, chunked prefill with conv/state carry, decode), the smoke model's
prefill-chunk logits and greedy picks, the bridge's f32 leaves, the caches
and the snapshot store.  Weights are the reference's ``init_params`` on
``get_smoke_config("mamba2-2.7b")`` through the bridge; inputs are drawn
with numpy.

Tolerance 1e-5 (atol and rtol) against the reference's own chunked scan:
the port sums in another order (torch einsum and cumsum).  1e-4 against the
per-token recurrence, as the reference's own tests hold its chunked scan to
it (exp of differences of cumulative sums, against a running product)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.kernels import ops as rops
from repro.models import mamba as RM
from repro.models import transformer as RT
from repro.runtime import kv_cache as RK
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as SK
from repro_torch.models import mamba as PM
from repro_torch.models import transformer as PT
from repro_torch.runtime import kv_cache as PK

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "mamba2-2.7b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(seed, *, b=2, s=24, h=3, p=4, n=16, init=False):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, s, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    a = -np.exp(np.linspace(-1.0, 1.0, h)).astype(np.float32)
    b_ = (0.3 * rng.standard_normal((b, s, n))).astype(np.float32)
    c_ = (0.3 * rng.standard_normal((b, s, n))).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    return x, dt, a, b_, c_, st


SSD_CASES = [dict(s=24, chunk=8), dict(s=27, chunk=8), dict(s=5, chunk=8),
             dict(s=24, chunk=8, init=True), dict(s=29, chunk=8, init=True),
             dict(s=36, chunk=256), dict(s=13, chunk=256, init=True),
             dict(s=40, chunk=16, init=True)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_plain_matches_reference(case):
    x, dt, a, b_, c_, st = _ssd_inputs(case["s"], s=case["s"], init=case.get("init", False))
    chunk = case["chunk"]
    y_r, f_r = RM.ssd_chunked(*map(jnp.asarray, (x, dt, a, b_, c_)), chunk=chunk,
                              init_state=None if st is None else jnp.asarray(st))
    y_p, f_p = PM.ssd_chunked(*map(_t, (x, dt, a, b_, c_)), chunk=chunk,
                              init_state=None if st is None else _t(st))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_r), **TOL)
    # ... and the per-token recurrence, reference and port.
    y_rr, f_rr = RM.ssd_ref(*map(jnp.asarray, (x, dt, a, b_, c_)),
                            init_state=None if st is None else jnp.asarray(st))
    y_pr, f_pr = PM.ssd_ref(*map(_t, (x, dt, a, b_, c_)),
                            init_state=None if st is None else _t(st))
    np.testing.assert_allclose(y_pr.numpy(), np.asarray(y_rr), **TOL)
    np.testing.assert_allclose(f_pr.numpy(), np.asarray(f_rr), **TOL)
    np.testing.assert_allclose(y_p.numpy(), y_pr.numpy(), atol=1e-4)
    np.testing.assert_allclose(f_p.numpy(), f_pr.numpy(), atol=1e-4)


def test_ssd_wrapper_on_cpu_is_the_plain_version():
    x, dt, a, b_, c_, st = map(lambda v: None if v is None else _t(v),
                               _ssd_inputs(3, s=19, init=True))
    n0 = SK.KERNEL.launches
    y, f = SK.ssd_chunked(x, dt, a, b_, c_, chunk=8, init_state=st)
    y_p, f_p = SK.ssd_chunked_plain(x, dt, a, b_, c_, chunk=8, init_state=st)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(f, f_p, rtol=0, atol=0)
    assert SK.KERNEL.launches == n0  # a CPU tensor never launches


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 16), (64, 32)])
def test_ops_ssd_matches_reference_pallas_kernel(s, chunk):
    """The reference's ``ops.ssd`` runs its Pallas kernel in interpret mode
    on the CPU (as tests/test_kernels.py does); it needs S % chunk == 0."""
    x, dt, a, b_, c_, _ = _ssd_inputs(s + chunk, s=s)
    want = rops.ssd(*map(jnp.asarray, (x, dt, a, b_, c_)), chunk=chunk, interpret=True)
    got = ops.ssd(*map(_t, (x, dt, a, b_, c_)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_wrapper_rejects_bad_inputs():
    x, dt, a, b_, c_, st = map(lambda v: None if v is None else _t(v),
                               _ssd_inputs(0, s=8, init=True))
    with pytest.raises(ValueError, match="float32"):
        SK.ssd_chunked(x, dt.double(), a, b_, c_)
    with pytest.raises(ValueError, match="share"):
        SK.ssd_chunked(x, dt, a, b_.bfloat16(), c_)
    with pytest.raises(ValueError, match="init_state"):
        SK.ssd_chunked(x, dt, a, b_, c_, init_state=st[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        SK.ssd_chunked(x.transpose(0, 1).contiguous().transpose(0, 1), dt, a, b_, c_)
    with pytest.raises(ValueError, match="fit"):
        SK.ssd_chunked(x, dt[:, :4], a, b_, c_)
    with pytest.raises(ValueError, match="chunk"):
        SK.ssd_chunked(x, dt, a, b_, c_, chunk=0)


# -- the block and the model ---------------------------------------------------------


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, with the zero-init leaves (rmsnorm scales,
    conv_b, dt_bias) set to random values so they are exercised."""
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def fill(t):
        for k, v in t.items():
            if isinstance(v, dict):
                fill(v)
            elif k in ("scale", "conv_b", "dt_bias"):
                t[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
    fill(tree)
    return tree


@pytest.fixture(scope="module")
def smoke():
    rcfg = RC.get_smoke_config(ARCH)
    pcfg = PC.get_smoke_config(ARCH)
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, tree, bridge.params_from_numpy(tree, pcfg, device="cpu")


def _block(tree, params, i=0):
    """Repeat ``i``'s mamba mixer params: (reference jnp tree, port tree)."""
    def pick(t, f):
        return {k: pick(v, f) if isinstance(v, dict) else f(v[i]) for k, v in t.items()}
    return (pick(tree["blocks"]["layer0"]["mixer"], jnp.asarray),
            pick(params["blocks"]["layer0"]["mixer"], lambda v: v))


def _kw(cfg):
    return dict(headdim=cfg.mamba_headdim, d_state=cfg.ssm_state, expand=cfg.mamba_expand,
                chunk=cfg.ssd_chunk)


def _assert_cache(port, ref):
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), **TOL)


def test_mamba_apply_whole_prefill_matches_reference(smoke):
    rcfg, pcfg, tree, params = smoke
    pr, pp = _block(tree, params)
    u = np.random.default_rng(1).standard_normal((2, 21, pcfg.d_model)).astype(np.float32)
    out_r, c_r = RM.mamba_apply(pr, jnp.asarray(u), **_kw(rcfg))
    out_p, c_p = PM.mamba_apply(pp, _t(u), **_kw(pcfg))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **TOL)
    _assert_cache(c_p, c_r)


def test_mamba_apply_two_piece_prefill_carries_conv_and_state(smoke):
    rcfg, pcfg, tree, params = smoke
    pr, pp = _block(tree, params)
    u = np.random.default_rng(2).standard_normal((2, 29, pcfg.d_model)).astype(np.float32)
    o1_r, c_r = RM.mamba_apply(pr, jnp.asarray(u[:, :16]), **_kw(rcfg))
    o2_r, c_r = RM.mamba_apply(pr, jnp.asarray(u[:, 16:]), state=c_r["ssm"],
                               conv_state=c_r["conv"], **_kw(rcfg))
    o1_p, c_p = PM.mamba_apply(pp, _t(u[:, :16]), **_kw(pcfg))
    o2_p, c_p = PM.mamba_apply(pp, _t(u[:, 16:]), state=c_p["ssm"],
                               conv_state=c_p["conv"], **_kw(pcfg))
    np.testing.assert_allclose(o1_p.numpy(), np.asarray(o1_r), **TOL)
    np.testing.assert_allclose(o2_p.numpy(), np.asarray(o2_r), **TOL)
    _assert_cache(c_p, c_r)
    # The carry is the whole story: one piece gives the same output.
    whole, _ = PM.mamba_apply(pp, _t(u), **_kw(pcfg))
    np.testing.assert_allclose(torch.cat([o1_p, o2_p], 1).numpy(), whole.numpy(), **TOL)


def test_mamba_apply_decode_matches_reference(smoke):
    rcfg, pcfg, tree, params = smoke
    pr, pp = _block(tree, params)
    u = np.random.default_rng(3).standard_normal((2, 12, pcfg.d_model)).astype(np.float32)
    _, c_r = RM.mamba_apply(pr, jnp.asarray(u[:, :8]), **_kw(rcfg))
    _, c_p = PM.mamba_apply(pp, _t(u[:, :8]), **_kw(pcfg))
    for t in range(8, 12):
        o_r, c_r = RM.mamba_apply(pr, jnp.asarray(u[:, t: t + 1]), state=c_r["ssm"],
                                  conv_state=c_r["conv"], decode=True, **_kw(rcfg))
        o_p, c_p = PM.mamba_apply(pp, _t(u[:, t: t + 1]), state=c_p["ssm"],
                                  conv_state=c_p["conv"], decode=True, **_kw(pcfg))
        np.testing.assert_allclose(o_p.numpy(), np.asarray(o_r), **TOL)
        _assert_cache(c_p, c_r)


def test_model_prefill_chunks_and_decode_match_reference(smoke):
    """Two prompt chunks (the second ragged) then three decode ticks of the
    smoke model: the chunk logits, the caches and the greedy picks against
    the reference's contiguous prefill chunk and ``decode_and_sample``."""
    rcfg, pcfg, tree, params = smoke
    rng = np.random.default_rng(4)
    toks = rng.integers(0, pcfg.vocab_size, (2, 27)).astype(np.int32)
    rp = jax.tree.map(jnp.asarray, tree)
    r_caches = RT.init_cache(rcfg, 2, 64, ring=False)
    p_caches = PT.init_cache(pcfg, 2, 64, device="cpu")
    unembed = PT.unembed_f32(pcfg, params)
    pos = 0
    for piece in (toks[:, :16], toks[:, 16:]):
        h = RT._embed_tokens(rcfg, rp, jnp.asarray(piece))
        h, r_caches, _ = RT.forward_hidden(
            rcfg, rp, h, positions=pos + jnp.arange(piece.shape[1]), caches=r_caches,
            q_offset=pos)
        from repro.models import layers as RL
        h = RL.rmsnorm(rp["final_norm"], h)
        want = h[:, -1:].astype(jnp.float32) @ RT._unembed(rcfg, rp).astype(jnp.float32).T
        got, p_caches = PT.prefill_chunk(pcfg, params, _t(piece), p_caches, pos,
                                         unembed=unembed)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pos += piece.shape[1]
    nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1), np.int32)
    for i in range(3):
        cur = np.full((2,), pos + i, np.int32)
        r_pick, r_caches = RT.decode_and_sample(rcfg, rp, jnp.asarray(nxt[:, None]),
                                                r_caches, jnp.asarray(cur))
        p_pick, p_caches = PT.decode_and_sample(pcfg, params, _t(nxt[:, None]), p_caches,
                                                _t(cur), unembed=unembed)
        np.testing.assert_array_equal(p_pick.numpy(), np.asarray(r_pick))
        nxt = np.asarray(r_pick)
    for name in r_caches["blocks"]:
        _assert_cache(p_caches["blocks"][name], r_caches["blocks"][name])


def test_bridge_keeps_ssm_leaves_f32_under_bf16(smoke):
    rcfg, _, _, _ = smoke
    rcfg16 = dataclasses.replace(rcfg, param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    pcfg16 = dataclasses.replace(PC.get_smoke_config(ARCH), param_dtype=torch.bfloat16,
                                 compute_dtype=torch.bfloat16)
    ref = RT.init_params(rcfg16, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda v: np.asarray(v.astype(jnp.float32)), ref)
    params = bridge.params_from_numpy(tree, pcfg16, device="cpu")
    mixer, rmixer = params["blocks"]["layer0"]["mixer"], ref["blocks"]["layer0"]["mixer"]
    for k, v in mixer.items():
        if isinstance(v, dict):
            continue
        want = torch.float32 if k in ("A_log", "D", "dt_bias") else torch.bfloat16
        assert v.dtype == want, k
        assert np.dtype(rmixer[k].dtype).name == str(want).removeprefix("torch."), k
    np.testing.assert_array_equal(mixer["A_log"].numpy(),
                                  np.asarray(rmixer["A_log"]))  # f32, no bf16 rounding
    fresh = PT.init_params(pcfg16, 0, device="cpu")["blocks"]["layer0"]["mixer"]
    assert {k: v.dtype for k, v in fresh.items() if not isinstance(v, dict)} == \
        {k: v.dtype for k, v in mixer.items() if not isinstance(v, dict)}


def test_init_params_matches_reference_layout_and_distributions(smoke):
    rcfg, pcfg, _, _ = smoke
    params = PT.init_params(pcfg, 0, device="cpu")
    ref = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(0)))
    flat_p = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), params))[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_p) == len(flat_r)
    for path, a in flat_p:
        r = flat_r[path]
        assert a.shape == r.shape and a.dtype == r.dtype, path
        name = path[-1].key
        if name in ("scale", "conv_b", "dt_bias", "A_log", "D"):  # deterministic
            # (log of linspace: torch and jnp round its points apart by an ulp)
            np.testing.assert_allclose(a, r, rtol=1e-6, atol=0, err_msg=str(path))
        else:  # same distribution: std within 10% of the reference draw's
            assert abs(a.std() / r.std() - 1) < 0.1, path


def test_caches_match_reference_layout(smoke):
    rcfg, pcfg, _, _ = smoke
    for port, ref in ((PT.init_cache(pcfg, 3, 64, device="cpu"),
                       RT.init_cache(rcfg, 3, 64, ring=False)),
                      (PT.init_paged_cache(pcfg, 3, 9, 8, device="cpu"),
                       RT.init_paged_cache(rcfg, 3, 9, 8))):
        for name, c in ref["blocks"].items():
            assert set(port["blocks"][name]) == set(c) == {"ssm", "conv"}
            for k, v in c.items():
                assert tuple(port["blocks"][name][k].shape) == v.shape
                assert str(port["blocks"][name][k].dtype).removeprefix("torch.") == \
                    np.dtype(v.dtype).name
                assert not port["blocks"][name][k].any()
    # Attention rows are ported too: (r, bsz, max_seq, n_kv_heads, head_dim).
    qcfg = PC.get_smoke_config("qwen3-4b")
    k = PT.init_cache(qcfg, 2, 32, device="cpu")["blocks"]["layer0"]["k"]
    assert tuple(k.shape) == (qcfg.n_repeats, 2, 32, qcfg.n_kv_heads, qcfg.head_dim)


def test_pool_scatter_overwrites_slot_state_whole(smoke):
    _, pcfg, _, _ = smoke
    kv = PK.PagedKVCache(pcfg, max_batch=3, max_seq=32, block_size=8, device="cpu")
    assert kv.page_bytes == 0  # slot state only: a page holds nothing
    for c in kv.pools["blocks"].values():
        for leaf in c.values():
            leaf.fill_(7.0)  # padding-tick garbage
    src = PT.init_cache(pcfg, 1, 32, device="cpu")
    for c in src["blocks"].values():
        for leaf in c.values():
            leaf.copy_(torch.randn(leaf.shape))
    assert kv.alloc(1, 12)
    kv.scatter(1, src, 11)
    for name, c in kv.pools["blocks"].items():
        for k, leaf in c.items():
            torch.testing.assert_close(leaf[:, 1:2], src["blocks"][name][k], rtol=0, atol=0)
            assert (leaf[:, 0] == 7.0).all() and (leaf[:, 2] == 7.0).all()


def test_state_store_matches_reference():
    rng = np.random.default_rng(5)
    ref, port = RK.StateStore(max_entries=3), PK.StateStore(max_entries=3)
    heads = [rng.integers(0, 50, 48).astype(np.int32) for _ in range(4)]
    for i, hd in enumerate(heads):
        for n in (16, 32):
            ref.put(hd[:n], (i, n))
            port.put(hd[:n], (i, n))
        assert len(ref) == len(port)
    for hd in heads:
        for q in (hd, hd[:40], hd[:32], hd[:17], np.concatenate([hd[:20], hd[:5]])):
            assert port.lookup(q, align_tokens=16) == ref.lookup(q, align_tokens=16)
    assert (port.hits, port.misses) == (ref.hits, ref.misses)
    with pytest.raises(ValueError):
        port.lookup(heads[0], align_tokens=0)
