"""The port's sharding policy, mesh placements, cost counter and dry run
against the JAX package, on the CPU in one process.

* The rules (``param_pspec``, ``cache_pspec``, ``batch_pspec``,
  ``logits_pspec``, ``drop_axis``): the port's spec equals the
  reference's for every leaf of all ten full and smoke configs (the
  reference's trees from ``jax.eval_shape``; the port's own param and
  cache trees have the same key paths and shapes) on mesh sizes 16x16,
  2x16x16, 4x2, 2x2x2 and 1x1.  The reference's rules take a
  ``mesh_sizes`` dict and need no devices.
* ``to_placements``: each rank's local block (a fake process group,
  entered once per rank) is the block the reference's ``NamedSharding``
  gives that device: mesh coordinates, major axis first.
* The cost counter's flops of a matmul, a loop of n repeats, nested loops
  and a grad step equal the reference's ``analyse_hlo_text`` on the same
  functions (``tests/test_hloanalysis.py``).
* The dry run: a mixtral smoke cell on a fake 2 x 2 x 2 world fills every
  field of the reference's ``analyse`` (or nulls it with a reason) and
  reports temporaries.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as RC
from repro.core import hloanalysis
from repro.launch import dryrun as RDRY
from repro.launch import sharding as RS
from repro.launch import steps as RSTEPS
from repro.models import transformer as RT
from repro_torch import configs as PC
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import costanalysis, rmetric
from repro_torch.core.tree import tree_paths
from repro_torch.launch import dryrun, sharding
from repro_torch.launch import steps as PSTEPS
from repro_torch.launch.mesh import init_fake, make_mesh
from repro_torch.models import transformer as PT

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
    "1x1": {"data": 1, "model": 1},
}
CONFIGS = [(a, full) for a in RC.list_archs() for full in (True, False)]


def _ref_cfg(arch, full):
    return RC.get_config(arch) if full else RC.get_smoke_config(arch)


def _port_cfg(arch, full):
    return PC.get_config(arch) if full else PC.get_smoke_config(arch)


def _key_path(path) -> tuple:
    return tuple(str(e.key) for e in path)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, full):
    cfg = _ref_cfg(arch, full)
    tree = jax.eval_shape(lambda k: RT.init_params(cfg, k), jax.random.PRNGKey(0))
    return jax.tree_util.tree_flatten_with_path(tree)[0]


#: (batch, seq) of each cache the rules see: the decode cells, and a smoke size.
CACHE_SIZES = {True: ((128, 32768), (1, 524288)), False: ((8, 64), (1, 128))}


@functools.lru_cache(maxsize=None)
def _ref_caches(arch, full):
    cfg = _ref_cfg(arch, full)
    out = []
    for b, s in CACHE_SIZES[full]:
        tree = jax.eval_shape(lambda: RT.init_cache(cfg, b, s, enc_seq=cfg.encoder_seq or None))
        out.append(jax.tree_util.tree_flatten_with_path(tree)[0])
    return out


def _spec(p) -> tuple:
    return tuple(p)


@pytest.fixture(scope="module")
def fake_world():
    """One fake world of 512 ranks (this process is rank 0) for every test
    that needs one after the per-rank test: DTensor caches placements by
    mesh, so a world made again would leave it meshes of a dead world."""
    dryrun._fake_world(512)
    yield
    dist.destroy_process_group()


def test_shapes_and_cells_equal_the_reference():
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in PC.SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in RC.SHAPES.items()}
    assert sorted(PC.cells(include_skipped=True)) == sorted(RC.cells(include_skipped=True))
    assert dryrun.TRAIN_ACCUM == RDRY.TRAIN_ACCUM
    assert set(dryrun.WEIGHT_GATHER_ONCE) == set(RDRY.WEIGHT_GATHER_ONCE)
    assert {k: str(v).removeprefix("torch.") for k, v in dryrun.MOMENT_DTYPE.items()} == {
        k: jnp.dtype(v).name for k, v in RDRY.MOMENT_DTYPE.items()}


@pytest.mark.parametrize("arch,full", CONFIGS)
def test_port_trees_have_the_reference_paths_and_shapes(arch, full):
    """The rules see the same leaves in both packages: params from
    ``param_shapes``, caches from ``init_cache`` (fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = _port_cfg(arch, full)
    ref = {_key_path(p): tuple(v.shape) for p, v in _ref_params(arch, full)}
    got = {path: tuple(shape) for path, shape in _shape_paths(PT.param_shapes(cfg))}
    assert got == ref
    for (b, s), leaves in zip(CACHE_SIZES[full], _ref_caches(arch, full)):
        with FakeTensorMode():
            cache = PT.init_cache(cfg, b, s, ring=True, device="cpu")
        want = {_key_path(p): tuple(v.shape) for p, v in leaves}
        assert {p: tuple(t.shape) for p, t in tree_paths(cache)} == want


def _shape_paths(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _shape_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("mesh", MESHES)
def test_param_pspec_equals_reference(mesh):
    sizes = MESHES[mesh]
    n = 0
    for arch, full in CONFIGS:
        for path, leaf in _ref_params(arch, full):
            want = RS.param_pspec(path, leaf.shape, sizes)
            got = sharding.param_pspec(_key_path(path), tuple(leaf.shape), sizes)
            assert _spec(got) == _spec(want), (arch, full, _key_path(path))
            n += 1
    assert n > 400


@pytest.mark.parametrize("mesh", MESHES)
def test_drop_axis_and_opt_specs_equal_reference(mesh):
    sizes = MESHES[mesh]
    for arch, full in CONFIGS:
        leaves = _ref_params(arch, full)
        ref_tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jax.eval_shape(
                lambda k: RT.init_params(_ref_cfg(arch, full), k), jax.random.PRNGKey(0))),
            [RS.param_pspec(p, v.shape, sizes) for p, v in leaves])
        from repro_torch.core.tree import tree_from_paths

        port_tree = tree_from_paths([(_key_path(p), sharding.param_pspec(
            _key_path(p), tuple(v.shape), sizes)) for p, v in leaves])
        for axis in ("data", "model", "pod"):
            want = RS.drop_axis(ref_tree, axis)
            got = dict(tree_paths(sharding.drop_axis(port_tree, axis)))
            for p, s in jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
                assert _spec(got[_key_path(p)]) == _spec(s), (arch, axis, _key_path(p))
        ospecs = sharding.opt_state_specs(port_tree)
        assert set(ospecs) == set(RS.opt_state_specs(ref_tree)) and _spec(ospecs["count"]) == ()


@pytest.mark.parametrize("mesh", MESHES)
def test_cache_pspec_equals_reference(mesh):
    sizes = MESHES[mesh]
    n = 0
    for arch, full in CONFIGS:
        for leaves in _ref_caches(arch, full):
            for path, leaf in leaves:
                want = RS.cache_pspec(path, leaf.shape, sizes)
                got = sharding.cache_pspec(_key_path(path), tuple(leaf.shape), sizes)
                assert _spec(got) == _spec(want), (arch, full, _key_path(path), leaf.shape)
                n += 1
    assert n > 100


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_pspec_equals_reference(mesh):
    sizes = MESHES[mesh]
    for arch, full in CONFIGS:
        rcfg, pcfg = _ref_cfg(arch, full), _port_cfg(arch, full)
        for b, s in [(v.global_batch, v.seq_len) for v in RC.SHAPES.values()] + [(8, 32)]:
            want = RSTEPS.batch_shapes(rcfg, global_batch=b, seq_len=s)
            got = PSTEPS.batch_shapes(pcfg, global_batch=b, seq_len=s)
            assert {k: tuple(v.shape) for k, v in got.items()} == {
                k: tuple(v.shape) for k, v in want.items()}
            for k, v in want.items():
                assert _spec(sharding.batch_pspec(tuple(v.shape), sizes)) == _spec(
                    RS.batch_pspec(v.shape, sizes)), (arch, k, v.shape)
            assert sharding.batch_axes(sizes, b) == RS.batch_axes(sizes, b)
    if mesh == "1x1":  # the decode shapes, once: no mesh in them
        for arch, full in CONFIGS:
            rc, tok, cur = RSTEPS.decode_shapes(_ref_cfg(arch, full), global_batch=8,
                                                seq_len=64)
            pc, ptok, pcur = PSTEPS.decode_shapes(_port_cfg(arch, full), global_batch=8,
                                                  seq_len=64)
            want = {_key_path(p): tuple(v.shape) for p, v in
                    jax.tree_util.tree_flatten_with_path(rc)[0]}
            assert {p: tuple(t.shape) for p, t in tree_paths(pc)} == want
            assert all(t.device.type == "meta" for _, t in tree_paths(pc))
            assert (tuple(ptok.shape), tuple(pcur.shape)) == (tuple(tok.shape), (8,))
            assert _spec(sharding.batch_pspec((b, 1), sizes)) == _spec(
                RS.batch_pspec((b, 1), sizes))


@pytest.mark.parametrize("mesh", MESHES)
def test_logits_pspec_equals_reference(mesh):
    sizes = MESHES[mesh]
    for arch, full in CONFIGS:
        v = _ref_cfg(arch, full).padded_vocab
        assert v == _port_cfg(arch, full).padded_vocab
        for b in (1, 8, 32, 128, 256):
            assert _spec(sharding.logits_pspec(sizes, b, v)) == _spec(
                RS.logits_pspec(sizes, b, v)), (arch, b)


# ----------------------------------------------------------------------------
# Placements: each rank's block
# ----------------------------------------------------------------------------


def _expected_block(shape, spec, dims, axes, coord):
    """The reference's NamedSharding block of the device at ``coord``:
    entry d's axes split dim d, the first (major) axis outermost."""
    sl = []
    for d, entry in enumerate(list(spec) + [None] * (len(shape) - len(spec))):
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n, idx = 1, 0
        for a in names:
            i = axes.index(a)
            n, idx = n * dims[i], idx * dims[i] + coord[i]
        size = shape[d] // n
        sl.append(slice(idx * size, (idx + 1) * size))
    return tuple(sl)


@pytest.mark.parametrize("dims,axes,spec", [
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (None, "data", "model")),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None, "model")),
    ((4, 2), ("data", "model"), ("model", "data")),
    ((4, 2), ("data", "model"), (None, ("data", "model"))),
])
def test_each_rank_holds_the_reference_block(dims, axes, spec):
    shape = (8, 8, 4)[:len(spec)] if len(spec) < 3 else (8, 4, 8)
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    world = int(np.prod(dims))
    try:
        for rank in range(world):
            init_fake(world, rank=rank)
            mesh = make_mesh(dims, axes)
            got = sharding.distribute({"x": full}, {"x": sharding.P(*spec)}, mesh)["x"]
            coord = [mesh.get_local_rank(a) for a in axes]
            assert coord == list(np.unravel_index(rank, dims))
            want = full[_expected_block(shape, spec, dims, axes, coord)]
            assert torch.equal(got.to_local(), want), (rank, coord)
            # a copy of the block, no view: nothing keeps the full leaf alive
            assert got.shape == full.shape and not got._local_tensor._is_view()
            assert (got._local_tensor.untyped_storage().data_ptr()
                    != full.untyped_storage().data_ptr())
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_to_placements_rejects_axes_out_of_mesh_order(fake_world):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh order"):
        sharding.to_placements(sharding.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in mesh"):
        sharding.to_placements(sharding.P("expert"), mesh)


# ----------------------------------------------------------------------------
# The cost counter against the reference's HLO walker
# ----------------------------------------------------------------------------


def _hlo_flops(fn, *args):
    return hloanalysis.analyse_hlo_text(jax.jit(fn).lower(*args).compile().as_text()).flops


def _port_flops(fn, *args):
    return costanalysis.analyse(fn, *args)[1].flops


def test_cost_counter_flops_of_a_matmul():
    m, k, n = 64, 128, 32
    want = _hlo_flops(lambda a, b: a @ b, jnp.ones((m, k)), jnp.ones((k, n)))
    assert _port_flops(lambda a, b: a @ b, torch.ones(m, k), torch.ones(k, n)) == want
    assert want == 2 * m * k * n


def test_cost_counter_flops_of_loops():
    m, trips = 32, 17

    def ref(x):
        def body(c, _):
            return c @ x, None
        return jax.lax.scan(body, x, None, length=trips)[0]

    def port(x):
        c = x
        for _ in range(trips):
            c = c @ x
        return c

    assert _port_flops(port, torch.ones(m, m)) == _hlo_flops(ref, jnp.ones((m, m)))

    def ref_nested(x):
        def outer(c, _):
            def inner(ci, _):
                return ci @ x, None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    def port_nested(x):
        c = x
        for _ in range(5):
            for _ in range(3):
                c = c @ x
        return c

    m = 16
    assert _port_flops(port_nested, torch.ones(m, m)) == _hlo_flops(ref_nested, jnp.ones((m, m)))


def test_cost_counter_flops_of_a_grad_step():
    m = 32
    xj, wj = jnp.ones((m, m)), jnp.ones((m, m))
    want = _hlo_flops(jax.grad(lambda w: ((xj @ w) ** 2).sum()), wj)
    x = torch.ones(m, m)

    def grad(w):
        w = w.clone().requires_grad_(True)
        return torch.autograd.grad(((x @ w) ** 2).sum(), w)[0]

    got = _port_flops(grad, torch.ones(m, m))
    assert got == want
    assert got >= 2 * _port_flops(lambda w: (x @ w).sum(), torch.ones(m, m))


def test_cost_counter_bytes_and_readers():
    x, w = torch.ones(64, 128), torch.ones(128, 32)
    _, cost = costanalysis.analyse(lambda: (x @ w).t().contiguous())
    mm = (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert cost.bytes == mm + 2 * 64 * 32 * 4  # the view is free, the copy reads + writes
    costanalysis.note_collective("collective-permute", 10.0)  # no counter: ignored
    with costanalysis.CostCounter() as c:
        costanalysis.note_collective("collective-permute", 100.0)
    assert costanalysis.collective_bytes_from_hlo(c.totals)["total"] == 100.0
    assert costanalysis.cost_analysis_scalars(c.totals) == (0.0, 200.0)
    assert costanalysis.cost_analysis_scalars([{"flops": 3.0, "bytes accessed0{}": 5.0}]) == (
        3.0, 5.0)
    terms = rmetric.roofline_from_cost(hlo_flops=989e12, hlo_bytes=3.35e12,
                                       collective_bytes=50e9, n_chips=256)
    assert (terms.compute, terms.memory, terms.collective) == pytest.approx((1.0, 1.0, 1.0))
    assert rmetric.roofline_from_cost(hlo_flops=0, hlo_bytes=0, collective_bytes=450e9,
                                      n_chips=8).collective == pytest.approx(1.0)


@pytest.mark.parametrize("kw", [dict(causal=True, window=0, prefix_len=0),
                                dict(causal=True, window=5, prefix_len=0),
                                dict(causal=True, window=0, prefix_len=6),
                                dict(causal=False, window=0, prefix_len=0)])
def test_cost_counter_counts_a_kernel_not_its_plain_version(kw):
    """The prefill kernel's wrapper counts as the kernel: one op, the flops
    of the visible (query, key) pairs (counted here from the plain
    version's own mask) and its inputs and outputs once; the plain
    version's score matrices are neither counted nor live."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as A

    g = torch.Generator().manual_seed(0)
    b, sq, sk, h, hkv, hd, off = 2, 12, 16, 4, 2, 8, 4
    q = torch.randn(b, sq, h, hd, generator=g)
    k, v = torch.randn(b, sk, hkv, hd, generator=g), torch.randn(b, sk, hkv, hd, generator=g)
    with costanalysis.CostCounter() as c:
        out, lse = FA.flash_attention_lse(q, k, v, scale=0.3, q_offset=off, **kw)
    mask = A._visible(np.arange(sq)[:, None] + off, np.arange(sk)[None, :], **kw)
    pairs = sq * sk if mask is None else int(mask.sum())
    assert c.ops == 1
    assert c.totals.flops == 4.0 * b * pairs * h * hd
    assert c.totals.bytes == (2 * q.numel() + 2 * k.numel()) * 4 + lse.numel() * 4
    assert c.peak_live_bytes == out.numel() * 4 + lse.numel() * 4
    torch.testing.assert_close(out, FA.flash_attention(q, k, v, scale=0.3, q_offset=off, **kw))


# ----------------------------------------------------------------------------
# The dry run
# ----------------------------------------------------------------------------


def test_dry_run_of_a_smoke_cell_on_a_fake_2x2x2_world(fake_world):
    cfg = PC.get_smoke_config("mixtral-8x7b")
    res = dryrun.run_cell("mixtral-8x7b", ShapeSpec("smoke", 32, 8, "train"), multi_pod=True,
                          cfg=cfg, mesh_shape=((2, 2, 2), ("pod", "data", "model")),
                          exact=True)
    ref_keys = {"arch", "shape", "mesh", "n_chips", "model_flops", "lower_s", "compile_s",
                "hlo_flops", "hlo_bytes", "collective_bytes", "collective_breakdown",
                "mem_argument_bytes", "mem_output_bytes", "mem_temp_bytes",
                "mem_generated_code_bytes", "t_compute_s", "t_memory_s", "t_collective_s",
                "bottleneck", "t_serial_s", "t_overlapped_s", "roofline_fraction",
                "useful_flops_ratio", "paper_R"}
    assert ref_keys <= set(res)
    assert {k for k in ref_keys if res[k] is None} == set(res["null_reasons"])
    assert res["mesh"] == "2x2x2" and res["n_chips"] == 8
    assert res["mem_temp_bytes"] > 0 and res["mem_argument_bytes"] > 0
    assert res["hlo_flops"] > 0 and res["bottleneck"] in ("compute", "memory", "collective")
    # FSDP gathers, the TP / pod all-reduces and the gradient reduce-scatters
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(res["collective_breakdown"])


def test_dry_run_extension_equals_the_whole_trace(fake_world):
    """The dry run traces 1 and 2 repeats at 2 and 3 micro-batches and
    extends linearly: on a 3-layer qwen3 smoke step with 6 micro-batches
    on 2 x 2 its flops and collective bytes equal the whole step's trace,
    its bytes and temporaries within 1%."""
    import dataclasses

    cfg = dataclasses.replace(PC.get_smoke_config("qwen3-4b"), n_layers=3)
    kw = dict(multi_pod=False, cfg=cfg, mesh_shape=((2, 2), ("data", "model")))
    shape = ShapeSpec("smoke", 32, 12, "train")
    exact = dryrun.run_cell("qwen3-4b", shape, exact=True, **kw)
    ext = dryrun.run_cell("qwen3-4b", shape, **kw)
    assert (exact["accum"], ext["accum"], ext["traced"]["accum"]) == (6, 6, [2, 3])
    assert ext["hlo_flops"] == exact["hlo_flops"]
    assert ext["collective_breakdown"] == exact["collective_breakdown"]
    assert ext["mem_argument_bytes"] == exact["mem_argument_bytes"]
    assert ext["mem_output_bytes"] == exact["mem_output_bytes"]
    assert ext["hlo_bytes"] == pytest.approx(exact["hlo_bytes"], rel=1e-2)
    assert ext["mem_temp_bytes"] == pytest.approx(exact["mem_temp_bytes"], rel=1e-2)


def test_meshutil_without_a_mesh_and_the_compute_rule():
    from repro.models import meshutil as RM
    from repro_torch.models import meshutil

    x = torch.ones(4, 3)
    assert meshutil.current_mesh() is None
    assert meshutil.shard_batch(x) is x and meshutil.shard_spec(x, "data", None) is x
    assert meshutil.gather(x) is x and meshutil.gather_rows(x) is x
    assert meshutil.to_model_parallel(x) is x and meshutil.from_model_parallel(x) is x
    for sizes in MESHES.values():
        for b in (1, 2, 8, 32, 128, 256):
            assert meshutil.batch_axes_for(b, sizes) == RM.batch_axes_for(b, sizes)
    # qwen3-4b: 32 query / 8 KV heads, d_ff 9728
    cfg = PC.get_config("qwen3-4b")
    spec = cfg.layer_unit[0]
    assert meshutil.compute_dim(cfg, spec, "mixer", "wq", 16) is None  # KV heads 8 % 16
    assert meshutil.compute_dim(cfg, spec, "mixer", "wq", 8) == 1
    assert meshutil.compute_dim(cfg, spec, "mixer", "wo", 8) == 0
    assert meshutil.compute_dim(cfg, spec, "mixer", "scale", 8) is None
    assert meshutil.compute_dim(cfg, spec, "ffn", "wg", 16) == 1
    assert meshutil.compute_dim(cfg, spec, "ffn", "wo", 16) == 0
    assert meshutil.compute_dim(cfg, spec, "ffn", "wo", 1) is None
    moe = PC.get_config("mixtral-8x7b")
    assert meshutil.compute_dim(moe, moe.layer_unit[0], "ffn", "wi", 8) is None  # experts whole


def test_shard_spec_places_a_dtensor_under_a_mesh(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import meshutil

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = sharding.distribute({"x": torch.zeros(8, 6)}, {"x": sharding.P()}, mesh)["x"]
    with meshutil.use_mesh(mesh, batch_axes=("pod", "data")) as ctx:
        assert meshutil.current_mesh() is mesh and ctx.batch_ways == 4
        assert meshutil.shard_batch(x).placements == (Shard(0), Shard(0), Replicate())
        assert meshutil.shard_spec(x, None, "model").placements == (
            Replicate(), Replicate(), Shard(1))
        odd = sharding.distribute({"x": torch.zeros(8, 5)}, {"x": sharding.P()}, mesh)["x"]
        assert meshutil.shard_spec(odd, None, "model").placements == (
            Replicate(), Replicate(), Replicate())  # 5 % 2: the axis is dropped
    assert meshutil.current_mesh() is None
