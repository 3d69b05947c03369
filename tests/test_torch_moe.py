"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the cases of ``tests/test_moe.py``, and the engine
serving qwen2-moe-a2.7b and mixtral-8x7b (smoke) against the JAX
``StreamedBatchEngine`` on the CPU, f32, equal weights through the bridge.

Routing (expert indices, queue positions, the one-hot dispatch) is held
exactly; gates, outputs and the aux loss within 1e-5 (f32 sums in another
order), as ``tests/test_moe.py`` holds its own implementations to each
other.  Engine greedy tokens per uid must be identical, paged and
contiguous, with spec decode, at ``capacity_factor=0.5`` (where a decode
tick of 2 slots has capacity 1 and drops choices; the test asserts that a
drop happened) and for mixtral with its 16-token smoke window on prompts
longer than it; over int8 pages the mean agreement reaches 0.5.  More
options (non-fused, fp8, a preempting pool, prefix sharing, temperature):
``tests/test_torch_zoo_options.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as RC
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.runtime import serving as PS

TOL = dict(atol=1e-5, rtol=1e-5)
QUANT_FLOOR = 0.5
LENS = (24, 17, 40, 9, 33, 16)
KW = dict(max_seq=48, prefill_chunk=16, max_new_tokens=6, max_batch=2, block_size=8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def _ref_params(seed, **kw):
    """The reference's ``moe_init`` as numpy (f32)."""
    return _np(RM.moe_init(jax.random.PRNGKey(seed), dtype=jnp.float32, **kw))


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- routing ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("e", [4, 8])
@pytest.mark.parametrize("n", [8, 32, 64])
def test_routing_matches_reference(n, e, k):
    logits = _x(n + e, (n, e), 1.0)
    cap = max(1, n * k // e)
    eidx_r, pos_r, gates_r, aux_r = RM.route_topk_indices(jnp.asarray(logits), top_k=k,
                                                          capacity=cap)
    eidx, pos, gates, aux = PM.route_topk_indices(_t(logits), top_k=k, capacity=cap)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(eidx_r))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_r))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), **TOL)
    assert float(aux) == pytest.approx(float(aux_r), rel=1e-5)
    disp_r, comb_r, _ = RM.route_topk(jnp.asarray(logits), top_k=k, capacity=cap)
    disp, comb, _ = PM.route_topk(_t(logits), top_k=k, capacity=cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(disp_r))
    np.testing.assert_allclose(comb.numpy(), np.asarray(comb_r), **TOL)
    assert (eidx.dtype, pos.dtype) == (torch.int32, torch.int32)


def test_capacity_drops_in_order():
    """Tokens beyond capacity are dropped in token order (priority)."""
    logits = torch.tensor([[10.0, 0.0]]).repeat(6, 1)  # all pick e0
    disp, _, _ = PM.route_topk(logits, top_k=1, capacity=2)
    np.testing.assert_array_equal(disp.sum(dim=(1, 2)).numpy(), [1, 1, 0, 0, 0, 0])
    _, pos, gates, _ = PM.route_topk_indices(logits, top_k=1, capacity=2)
    np.testing.assert_array_equal(pos[:, 0].numpy(), np.arange(6))
    assert (gates[2:] == 0).all() and (gates[:2] > 0).all()


# -- moe_apply -------------------------------------------------------------------------


@pytest.mark.parametrize("capf", [0.5, 1.25, 8.0])
def test_gather_and_einsum_match_reference(capf):
    """Both impls, with and without drops, shared experts on: the port's
    gather equals its einsum and both equal the reference's."""
    tree = _ref_params(0, d_model=32, d_ff=64, n_experts=8, n_shared_experts=2)
    x = _x(1, (2, 16, 32))
    for impl in ("gather", "einsum"):
        want, aux_r = RM.moe_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), top_k=2,
                                   capacity_factor=capf, moe_chunk=16, impl=impl)
        got, aux = PM.moe_apply(_torch(tree), _t(x), top_k=2, capacity_factor=capf,
                                moe_chunk=16, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert float(aux) == pytest.approx(float(aux_r), rel=1e-5)
    yg, _ = PM.moe_apply(_torch(tree), _t(x), top_k=2, capacity_factor=capf, moe_chunk=16)
    ye, _ = PM.moe_apply(_torch(tree), _t(x), top_k=2, capacity_factor=capf, moe_chunk=16,
                         impl="einsum")
    np.testing.assert_allclose(yg.numpy(), ye.numpy(), **TOL)


def test_gather_vs_dropless_oracle():
    tree = _ref_params(0, d_model=32, d_ff=64, n_experts=8)
    x = _x(2, (2, 16, 32))
    y, _ = PM.moe_apply(_torch(tree), _t(x), top_k=2, capacity_factor=8.0, moe_chunk=16)
    want = PM.moe_ref_dense(_torch(tree), _t(x), top_k=2)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    ref = RM.moe_ref_dense(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), top_k=2)
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), **TOL)


def test_expert_shards_equivalent():
    """Half-width virtual experts equal the unsharded experts, and the
    reference's sharded output."""
    e, d, f = 4, 16, 32
    p2 = _torch(_ref_params(0, d_model=d, d_ff=f, n_experts=e, expert_shards=2))
    p1 = dict(p2,
              wi=torch.stack([torch.cat([p2["wi"][2 * i], p2["wi"][2 * i + 1]], -1)
                              for i in range(e)]),
              wg=torch.stack([torch.cat([p2["wg"][2 * i], p2["wg"][2 * i + 1]], -1)
                              for i in range(e)]),
              wo=torch.stack([torch.cat([p2["wo"][2 * i], p2["wo"][2 * i + 1]], 0)
                              for i in range(e)]))
    x = _x(3, (1, 16, d))
    y2, _ = PM.moe_apply(p2, _t(x), top_k=2, capacity_factor=8.0, moe_chunk=16,
                         expert_shards=2)
    y1, _ = PM.moe_apply(p1, _t(x), top_k=2, capacity_factor=8.0, moe_chunk=16)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), **TOL)
    want, _ = RM.moe_apply({k: jnp.asarray(v.numpy()) for k, v in p2.items()}, jnp.asarray(x),
                           top_k=2, capacity_factor=1.0, moe_chunk=8, expert_shards=2)
    got, _ = PM.moe_apply(p2, _t(x), top_k=2, capacity_factor=1.0, moe_chunk=8,
                          expert_shards=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_padded_experts_inert():
    """Dead padding experts never contribute (nor receive a token)."""
    p = _torch(_ref_params(0, d_model=16, d_ff=32, n_experts=6, n_experts_pad=8))
    assert p["wi"].shape[0] == 8 and p["router"].shape == (16, 6)
    p_nopad = dict(p, wi=p["wi"][:6], wg=p["wg"][:6], wo=p["wo"][:6])
    x = _x(4, (1, 16, 16))
    y_pad, _ = PM.moe_apply(p, _t(x), top_k=2, capacity_factor=8.0, moe_chunk=16)
    np.testing.assert_allclose(y_pad.numpy(), PM.moe_ref_dense(p_nopad, _t(x), top_k=2).numpy(),
                               **TOL)
    poisoned = dict(p, wo=p["wo"].clone())
    poisoned["wo"][6:] = 1e6  # a dead expert's output would show
    y, _ = PM.moe_apply(poisoned, _t(x), top_k=2, capacity_factor=8.0, moe_chunk=16)
    np.testing.assert_allclose(y.numpy(), y_pad.numpy(), **TOL)


@pytest.mark.parametrize("capf", [0.5, 1.25])
def test_moe_chunk_smaller_than_the_sequence(capf):
    """Routing and capacity per chunk of 8 of a 32-long sequence, as the
    reference's scan over chunks."""
    tree = _ref_params(5, d_model=16, d_ff=32, n_experts=4, n_shared_experts=1,
                       shared_d_ff=24)
    x = _x(5, (2, 32, 16))
    want, aux_r = RM.moe_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), top_k=2,
                               capacity_factor=capf, moe_chunk=8)
    got, aux = PM.moe_apply(_torch(tree), _t(x), top_k=2, capacity_factor=capf, moe_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == pytest.approx(float(aux_r), rel=1e-5)
    with pytest.raises(ValueError, match="moe chunk"):
        PM.moe_apply(_torch(tree), _t(x[:, :12]), top_k=2, moe_chunk=8)


def test_init_matches_reference_layout():
    """Leaf names, shapes and stored types of ``moe_init``: the router in
    f32 under a bf16 parameter type, as the reference's."""
    kw = dict(d_model=16, d_ff=32, n_experts=6, n_shared_experts=2, shared_d_ff=48,
              expert_shards=2, n_experts_pad=8)
    ref = RM.moe_init(jax.random.PRNGKey(0), dtype=jnp.bfloat16, **kw)
    got = PM.moe_init(torch.Generator().manual_seed(0), dtype=torch.bfloat16, **kw)
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_p = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat_r) == len(flat_p)
    for path, a in flat_p:
        r = flat_r[path]
        assert tuple(a.shape) == r.shape, path
        assert str(a.dtype).removeprefix("torch.") == np.dtype(r.dtype).name, path
    assert PM.moe_shapes(**kw)["shared"]["wi"] == (16, 48)


def test_moe_step_has_no_data_dependent_shape_or_host_read():
    """Under FakeTensorMode an op whose output shape depends on the data
    (boolean indexing, ``nonzero``) or that reads a value to the host
    (``.item()``) raises; the MoE step runs there, so the tick that holds
    it can be captured in a CUDA graph."""
    p = PM.moe_init(torch.Generator().manual_seed(0), d_model=16, d_ff=32, n_experts=6,
                    n_experts_pad=8, n_shared_experts=2, expert_shards=2)
    x = torch.randn(4, 1, 16)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fx = mode.from_tensor(x)
        y, _ = PM.moe_apply(p, fx, top_k=2, capacity_factor=0.5, moe_chunk=16,
                            expert_shards=2)
        assert y.shape == (4, 1, 16)
        with pytest.raises(Exception):
            fx[fx > 0]  # the check does catch a data-dependent shape


# -- the engine -------------------------------------------------------------------------


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, rmsnorm scales set to random values."""
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


def _prompts(vocab, tiled):
    rng = np.random.default_rng(7)
    if not tiled:
        return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]
    return [np.resize(rng.integers(0, vocab, 5), n).astype(np.int32) for n in LENS]


MODES = {"paged": dict(paged=True), "contiguous": dict(paged=False),
         "spec": dict(paged=True, spec_decode=True, spec_k=3),
         "int8": dict(paged=True, kv_dtype="int8")}
# qwen2-moe and mixtral (its smoke window of 16 on prompts up to 40) in
# every mode; qwen2-moe with decode ticks that drop (capacity factor 0.5:
# capacity 1 an expert at 2 slots) paged and contiguous.
ENGINE_CASES = [("qwen2-moe-a2.7b", {}, list(MODES)),
                ("qwen2-moe-a2.7b", dict(capacity_factor=0.5), ["paged", "contiguous"]),
                ("mixtral-8x7b", dict(sliding_window=16), list(MODES))]


@pytest.fixture
def decode_drops(monkeypatch):
    """Counts, per decode tick of the port (routing over ``max_batch`` rows),
    the choices dropped for capacity."""
    drops = []
    route = PM.route_topk_indices

    def counted(logits, *, top_k, capacity):
        out = route(logits, top_k=top_k, capacity=capacity)
        if logits.shape[0] == KW["max_batch"]:
            drops.append(int((out[1] >= capacity).sum()))
        return out
    monkeypatch.setattr(PM, "route_topk_indices", counted)
    return drops


@pytest.mark.parametrize("arch,over,mode", [
    pytest.param(a, o, m, id=a + "".join(f"-{k}={v}" for k, v in o.items()) + f"-{m}")
    for a, o, modes in ENGINE_CASES for m in modes])
def test_engine_matches_reference(arch, over, mode, decode_drops):
    rcfg = dataclasses.replace(RC.get_smoke_config(arch), **over)
    pcfg = dataclasses.replace(PC.get_smoke_config(arch), **over)
    tree = _numpy_params(rcfg)
    extra = MODES[mode]
    prompts = _prompts(rcfg.vocab_size, tiled="spec" in mode)
    ref = RS.StreamedBatchEngine(rcfg, jax.tree.map(jnp.asarray, tree),
                                 RS.ServeConfig(**KW, **extra))
    r_uids = [ref.submit(p) for p in prompts]
    want = ref.run()
    params = bridge.params_from_numpy(tree, pcfg, device="cpu")
    assert params["blocks"]["layer0"]["ffn"]["router"].dtype == torch.float32
    eng = PS.StreamedBatchEngine(pcfg, params, PS.ServeConfig(**KW, **extra), device="cpu")
    p_uids = [eng.submit(p) for p in prompts]
    got = eng.run()
    pairs = [(got[p], want[r]) for p, r in zip(p_uids, r_uids)]
    if mode == "int8":
        agree = np.mean([np.mean(a == b) for a, b in pairs])
        assert agree >= QUANT_FLOOR, agree
    else:
        for a, b in pairs:
            np.testing.assert_array_equal(a, b)
        assert eng.decode_steps == ref.decode_steps
    if "spec" in mode:
        assert eng.spec_ticks > 0 and eng.spec_proposed > 0
        assert (eng.spec_ticks, eng.spec_accepted) == (ref.spec_ticks, ref.spec_accepted)
    if over.get("capacity_factor") == 0.5:
        assert sum(decode_drops) > 0, "no decode tick dropped a choice"
    if arch == "mixtral-8x7b":
        assert pcfg.spec_window(pcfg.layer_unit[0]) == 16 < max(LENS)
    if eng.paged:
        assert eng.kv.pages_in_use == 0
        eng.kv.check_invariants()


@pytest.mark.parametrize("flags", [[], ["--paged"], ["--paged", "--kv-dtype", "int8"]],
                         ids=str)
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_launcher_serves_moe_on_cpu(capsys, arch, flags):
    from repro_torch.launch import serve as pserve
    pserve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--prompt-len", "20",
                 "--new-tokens", "4", "--prefill-chunk", "8", "--max-batch", "2", *flags])
    out = capsys.readouterr().out
    assert "3 requests x 20 prompt -> 4 new tokens each" in out
    assert ("kv_dtype=int8" in out) == ("int8" in flags)

