"""The training path's model half against the JAX package, on the CPU: the
prefill kernel's ``autograd.Function`` (plain forward + the twin of the
reference's flash backward) against ``jax.vjp`` of ``flash_attention_ref``
and its lse against ``_flash_fwd_impl``'s, the SSD ``autograd.Function``
against ``jax.vjp`` of ``models/mamba.ssd_chunked``, ``train_loss`` (value,
parts, every leaf's grad) for all ten smoke configs on bridged params, the
reference's chunk-invariance cases, the three remat modes, and the
parameter counts.

All f32.  Tolerances: the Functions' outputs and grads atol 1e-5; the
loss rtol 1e-5; each grad leaf within 1e-5 x its largest magnitude, but
jamba's within 4e-5 x: its 16 smoke layers (mamba, attention, MoE) leave
the reference's own jitted and eager gradients 1.8e-5 x apart.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import attention as RA
from repro.models import mamba as RM
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.core.tree import tree_paths
from repro_torch.models import attention as PA
from repro_torch.models import mamba as PM
from repro_torch.models import transformer as PT

ARCHS = PC.list_archs()
GRAD_TOL = {"jamba-1.5-large-398b": 4e-5}


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread (the tier-1 run's workers
    share the machine's cores; the old count comes back after the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the flash Function -------------------------------------------------------

FLASH_CASES = {  # g = h / hkv; sq 21 at chunk 8 is ragged (chunks of 7)
    "causal_g1": dict(h=2, hkv=2, sq=24, chunk=8),
    "window_softcap_g4": dict(h=8, hkv=2, sq=24, chunk=8, window=5, softcap_val=2.0),
    "prefix_g2": dict(h=4, hkv=2, sq=24, chunk=8, prefix_len=6),
    "noncausal_g2": dict(h=4, hkv=2, sq=24, chunk=8, causal=False),
    "ragged_g4": dict(h=4, hkv=1, sq=21, chunk=8, window=9, softcap_val=3.0),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_function_matches_reference_vjp(name):
    c = dict(FLASH_CASES[name])
    h, hkv, sq, chunk = c.pop("h"), c.pop("hkv"), c.pop("sq"), c.pop("chunk")
    kw = dict(causal=True, window=0, prefix_len=0, softcap_val=0.0) | c
    b, hd = 2, 16
    rng = np.random.default_rng(sum(map(ord, name)))
    q, dout = (rng.standard_normal((b, sq, h, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sq, hkv, hd)).astype(np.float32) for _ in range(2))

    ref = lambda q_, k_, v_: RA.flash_attention_ref(q_, k_, v_, chunk=chunk, **kw)  # noqa: E731
    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_w, dk_w, dv_w = vjp(jnp.asarray(dout))
    scale = 1.0 / math.sqrt(hd)
    rcfg = (chunk, kw["causal"], kw["window"], kw["prefix_len"], kw["softcap_val"], scale, 0)
    lse_w = RA._flash_fwd_impl(rcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))[1]
    lse_w = np.moveaxis(np.asarray(lse_w), 0, 1).reshape(b, sq, h)

    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out, lse = PA.FlashAttention.apply(tq, tk, tv, chunk, kw["causal"], kw["window"],
                                       kw["softcap_val"], None, 0, kw["prefix_len"])
    assert not lse.requires_grad
    out.backward(_t(dout))
    tol = dict(atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(lse.numpy(), lse_w, **tol)
    for got, w in ((tq.grad, dq_w), (tk.grad, dk_w), (tv.grad, dv_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **tol)


def test_flash_dispatch_keeps_serving_on_the_plain_path():
    """No gradient wanted: ``flash`` is ``ops.flash_attention`` (no lse, no
    graph); wanted: the Function's output, with a grad_fn."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.standard_normal((1, 8, 2, 16))) for _ in range(3))
    plain = PA.flash(q, k, v, chunk=4)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_(True)
    got = PA.flash(qg, k, v, chunk=4)
    assert type(got.grad_fn).__name__ == "FlashAttentionBackward"
    np.testing.assert_array_equal(got.detach().numpy(), plain.numpy())
    with torch.no_grad():
        assert PA.flash(qg, k, v, chunk=4).grad_fn is None


# -- the SSD Function -----------------------------------------------------------


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "random_state"])
def test_ssd_function_matches_reference_vjp(init):
    rng = np.random.default_rng(7 + init)
    b, s, h, p, n, chunk = 2, 20, 3, 4, 8, 8  # a ragged tail chunk of 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dst = rng.standard_normal((b, h, p, n)).astype(np.float32)

    args = [x, dt, a, bm, cm] + ([st] if init else [])
    def fn(*xs):
        return RM.ssd_chunked(*xs[:5], chunk=chunk, init_state=xs[5] if init else None)

    (y_w, st_w), vjp = jax.vjp(fn, *map(jnp.asarray, args))
    grads_w = vjp((jnp.asarray(dy), jnp.asarray(dst)))

    ts = [_t(t, True) for t in args]
    y, final = PM.SSDChunked.apply(*ts[:5], ts[5] if init else None, chunk)
    grads = torch.autograd.grad((y, final), ts, (_t(dy), _t(dst)))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_w), **tol)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(st_w), **tol)
    for got, w in zip(grads, grads_w):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **tol)


# -- train_loss over the ten smoke configs ------------------------------------------


def _numpy_params(pcfg, seed=0):
    """The port's init as numpy, rmsnorm scales set to random non-zero
    values (zero at init, so the ``1 + scale`` gain would go untested)."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    for path, leaf in tree_paths(PT.init_params(pcfg, seed, device="cpu")):
        a = leaf.numpy()
        if path[-1] == "scale":
            a = rng.normal(0.0, 0.3, a.shape).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def _batch(cfg, seed=1, b=2, s=32):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "loss_mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = (0.1 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if cfg.prefix_len:
        batch["prefix_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    return batch


def _port_loss_grads(pcfg, tree, batch):
    params = bridge.params_from_numpy(tree, pcfg, device="cpu")
    paths = tree_paths(params)
    leaves = [p.requires_grad_(True) for _, p in paths]
    loss, parts = PT.train_loss(pcfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, parts, {path: (torch.zeros_like(p) if g is None else g).numpy()
                         for (path, p), g in zip(paths, gs)}


@pytest.fixture(scope="module")
def reference():
    """arch -> (numpy params, batch, the reference's loss, parts, grads by
    path), computed once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg, pcfg = RC.get_smoke_config(arch), PC.get_smoke_config(arch)
            tree, batch = _numpy_params(pcfg), _batch(pcfg)
            fn = jax.jit(jax.value_and_grad(lambda p, bt: RT.train_loss(rcfg, p, bt),
                                            has_aux=True))
            (loss, parts), grads = fn(jax.tree.map(jnp.asarray, tree),
                                      jax.tree.map(jnp.asarray, batch))
            cache[arch] = (tree, batch, float(loss), {k: float(v) for k, v in parts.items()},
                           dict(tree_paths(jax.tree.map(np.asarray, grads))))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, reference):
    tree, batch, loss_w, parts_w, grads_w = reference(arch)
    loss, parts, grads = _port_loss_grads(PC.get_smoke_config(arch), tree, batch)
    np.testing.assert_allclose(float(loss), loss_w, rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k]), parts_w[k], rtol=1e-5, atol=1e-7)
    assert set(grads) == set(grads_w)
    tol = GRAD_TOL.get(arch, 1e-5)
    for path, w in grads_w.items():
        bound = tol * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(grads[path] - w).max())
        assert err <= bound, (path, err, bound)


# -- chunking, remat, counts ---------------------------------------------------------


def _port_loss(cfg, tree, batch, part=None):
    params = bridge.params_from_numpy(tree, cfg, device="cpu")
    with torch.no_grad():
        loss, parts = PT.train_loss(cfg, params, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
    return float(parts[part] if part else loss)


@pytest.mark.parametrize("arch,field,values,rtol,part,over", [
    ("qwen3-4b", "loss_chunk", (8, 16, 32), 1e-5, None, {}),
    ("gemma2-27b", "attn_chunk", (8, 16, 32), 1e-5, None, {}),
    ("mamba2-2.7b", "ssd_chunk", (4, 8, 16), 1e-4, None, {}),
    # capacity scales with the chunk: a generous factor avoids drops; the
    # aux balance loss is a per-chunk statistic, so compare the CE part
    ("mixtral-8x7b", "moe_chunk", (16, 32), 1e-4, "ce", {"capacity_factor": 8.0}),
], ids=["loss", "attn", "ssd", "moe"])
def test_chunk_invariance(arch, field, values, rtol, part, over):
    """The reference's TestChunkingInvariance: streaming knobs are a
    schedule, not a change of the math."""
    cfg = dataclasses.replace(PC.get_smoke_config(arch), **over)
    tree, batch = _numpy_params(cfg), _batch(cfg, b=2, s=32)
    batch.pop("loss_mask")
    losses = [_port_loss(dataclasses.replace(cfg, **{field: c}), tree, batch, part)
              for c in values]
    np.testing.assert_allclose(losses, losses[0], rtol=rtol)


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-2.7b", "qwen2-moe-a2.7b",
                                  "whisper-medium"])
def test_remat_modes_give_equal_grads(arch):
    """none / full / dots: the checkpoints recompute the Functions' forwards
    (attention, SSD) and everything they do not save; the grads agree."""
    base = PC.get_smoke_config(arch)
    tree, batch = _numpy_params(base), _batch(base)
    runs = {m: _port_loss_grads(dataclasses.replace(base, remat=m), tree, batch)
            for m in ("none", "full", "dots")}
    for m in ("full", "dots"):
        assert float(runs[m][0]) == pytest.approx(float(runs["none"][0]), rel=1e-6)
        for path, g in runs["none"][2].items():
            np.testing.assert_allclose(runs[m][2][path], g, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{m} {path}")


def test_dots_policy_saves_plain_matmuls_only():
    from repro_torch.models.transformer import _dots_policy
    from torch.utils.checkpoint import CheckpointPolicy

    assert _dots_policy(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.mul.Tensor,
               torch.ops.aten.exp.default):
        assert _dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    rcfg, pcfg = RC.get_config(arch), PC.get_config(arch)
    assert PT.param_count(pcfg) == rcfg.param_count()
    assert PT.active_param_count(pcfg) == rcfg.active_param_count()
