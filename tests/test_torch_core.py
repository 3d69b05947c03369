"""The port's streaming machinery (``repro_torch.core``) against the JAX
package's ``repro.core`` on the same inputs: the dependency taxonomy, the R
decision and pipeline model, the halo rule and partition, the wavefront
schedule and scan, the task-grid streams, ``plan_streaming`` and the host
executor on the CPU.  Model functions are plain float arithmetic in both
packages, so they must agree exactly; tensors are compared exactly too
(gathers, and the same f32 operations), except where a tolerance is named.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dependency as rdep
from repro.core import halo as rhalo
from repro.core import rmetric as rrm
from repro.core import streams as rstreams
from repro.core import wavefront as rwf
from repro_torch.core import dependency as dep
from repro_torch.core import halo, rmetric, streams, wavefront
from repro_torch.core.tree import tree_leaves

# -- dependency ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(rdep.PAPER_TABLE2))
def test_paper_suite_classification_equal(name):
    got = dep.classify_paper_suite()[name]
    want = rdep.classify_paper_suite()[name]
    assert (got[0].value, got[1].value, got[2]) == (want[0].value, want[1].value, want[2])
    assert got[2], f"{name}: the port's classifier disagrees with the paper"
    assert got[0].streamable == want[0].streamable


@pytest.mark.parametrize("kw", [
    dict(per_task_reads=["prompt"]),
    dict(per_task_reads=["prompt"], carrier="kv"),
    dict(per_task_reads=["prompt"], shared_reads=["params"]),
    dict(per_task_reads=["x"], kernel_iterations=20),
    dict(per_task_reads=["x"], n_tasks=1),
    dict(per_task_reads=["mel"], carrier="state", head=("enc", ["audio"], ["enc_out"])),
    dict(per_task_reads=["x"], sequential_kernel=True),
], ids=str)
def test_unroll_stream_equal(kw):
    got, want = dep.unroll_stream("w", **kw), rdep.unroll_stream("w", **kw)
    assert [(t.name, t.reads, t.writes) for t in got.tasks] == \
        [(t.name, t.reads, t.writes) for t in want.tasks]
    assert dep.classify(got).value == rdep.classify(want).value


# -- rmetric and the halo rule -------------------------------------------------

STAGES = [(0.0, 0.0, 0.0), (0.02, 0.98, 0.0), (0.45, 0.55, 0.0), (0.3, 0.4, 0.3),
          (0.95, 0.05, 0.0), (1.2, 0.3, 0.9), (0.3476, 0.3380, 0.0), (1e-4, 2.0, 5e-5)]


@pytest.mark.parametrize("h2d,kex,d2h", STAGES)
def test_decision_and_pipeline_model_equal(h2d, kex, d2h):
    t, rt = rmetric.StageTimes(h2d, kex, d2h), rrm.StageTimes(h2d, kex, d2h)
    assert (t.total, t.stages, t.ratio(), t.transfer_ratio()) == \
        (rt.total, rt.stages, rt.ratio(), rt.transfer_ratio())
    assert rmetric.streaming_decision(t).value == rrm.streaming_decision(rt).value
    assert (rmetric.R_LOW, rmetric.R_HIGH) == (rrm.R_LOW, rrm.R_HIGH)
    assert rmetric.single_stream_time(t) == rrm.single_stream_time(rt)
    for n in (1, 2, 3, 4, 8, 32):
        assert rmetric.multi_stream_time(t, n) == rrm.multi_stream_time(rt, n)
        assert rmetric.streaming_speedup(t, n) == rrm.streaming_speedup(rt, n)
    for kw in ({}, dict(max_streams=8), dict(overhead_per_task=0.01)):
        assert rmetric.optimal_streams(t, **kw) == rrm.optimal_streams(rt, **kw)
    rf, rrf = rmetric.RooflineTerms(kex, h2d, d2h), rrm.RooflineTerms(kex, h2d, d2h)
    assert (rf.total_serial, rf.total_overlapped, rf.bottleneck, rf.roofline_fraction()) == \
        (rrf.total_serial, rrf.total_overlapped, rrf.bottleneck, rrf.roofline_fraction())
    assert rf.as_stage_times().stages == rrf.as_stage_times().stages
    for n, r in ((1, 0.0), (4, 0.0002), (4, 222 / 250), (8, 0.5)):
        assert halo.streamed_time_with_halo(h2d, kex, n, r) == \
            rhalo.streamed_time_with_halo(h2d, kex, n, r)


@pytest.mark.parametrize("halo_el,task_el", [(254, 1048576), (222, 250), (0, 1), (5, 10),
                                             (4, 10), (1, 0)])
def test_halo_rule_equal(halo_el, task_el):
    assert halo.halo_overhead_ratio(halo_el, task_el) == \
        rhalo.halo_overhead_ratio(halo_el, task_el)
    assert halo.halo_streaming_profitable(halo_el, task_el) == \
        rhalo.halo_streaming_profitable(halo_el, task_el)
    assert halo.DEFAULT_HALO_BREAK_EVEN == rhalo.DEFAULT_HALO_BREAK_EVEN


def test_paper_constants_equal():
    got, want = rmetric.lavamd_counterexample(), rrm.lavamd_counterexample()
    assert (got[0].stages, got[1]) == (want[0].stages, want[1])
    assert rmetric.model_flops(4e9, 1e6) == rrm.model_flops(4e9, 1e6)
    assert rmetric.model_flops(4e9, 1e6, backward=False) == \
        rrm.model_flops(4e9, 1e6, backward=False)


def test_hardware_spec_is_the_h100():
    hw = rmetric.H100_SXM
    assert (hw.peak_flops, hw.peak_flops_f32, hw.hbm_bw, hw.nvlink_bw) == \
        (989e12, 67e12, 3.35e12, 450e9)
    assert hw.smem_per_sm_bytes == 232_448 and hw.sms == 132
    names = {f.name for f in rmetric.HardwareSpec.__dataclass_fields__.values()}
    assert not names & {"ici_bw", "vmem_bytes"}
    assert not hasattr(rmetric, "TPU_V5E")


# -- halo partition --------------------------------------------------------------


@pytest.mark.parametrize("n,chunks,h", [(16, 2, 0), (16, 4, 1), (32, 4, 3), (64, 8, 2),
                                        (64, 2, 4), (8, 8, 1)])
def test_halo_partition_equal(n, chunks, h):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    tree = {"a": torch.from_numpy(x), "b": (torch.arange(n),)}
    got = halo.halo_partition(tree, chunks, h)
    want = rhalo.halo_partition({"a": jnp.asarray(x), "b": (jnp.arange(n),)}, chunks, h)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
    np.testing.assert_array_equal(halo.halo_indices(n, chunks, h).numpy(),
                                  np.asarray(rhalo.halo_indices(n, chunks, h)))
    core = halo.strip_halo(got, h)
    np.testing.assert_array_equal(core["a"].reshape(n, 3).numpy(), x)


def test_halo_indivisible_raises():
    with pytest.raises(ValueError):
        halo.halo_indices(10, 4, 1)


# -- wavefront -------------------------------------------------------------------


@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 5), (3, 4), (4, 5), (5, 7), (64, 64)])
def test_diagonals_equal(rows, cols):
    assert wavefront.diagonal_tiles(rows, cols) == rwf.diagonal_tiles(rows, cols)
    assert wavefront.streams_per_diagonal(rows, cols) == rwf.streams_per_diagonal(rows, cols)
    for h2d, kex, s in ((1.0, 1.0, 8), (0.52, 1.0, 16), (0.5, 0.5, 1), (2.0, 0.1, 3)):
        assert wavefront.wavefront_speedup_model(rows, cols, h2d=h2d, kex=kex, max_streams=s) \
            == rwf.wavefront_speedup_model(rows, cols, h2d=h2d, kex=kex, max_streams=s)


def _grid_inputs(rows, cols, block, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    corner = f(rows + 1, cols + 1)
    return f(cols, block), f(rows, block), corner, f(rows, block), f(cols, block)


@pytest.mark.parametrize("rows,cols,block", [(2, 2, 4), (3, 2, 8), (2, 4, 8), (1, 3, 4)])
def test_wavefront_scan_equal(rows, cols, block):
    """A tile function that reads every input (north, west, corner, the row
    and column inputs, the tile coordinates): the port's batched scan and
    the reference's vmapped scan give the same tiles and boundaries."""
    north, west, corner, row_in, col_in = _grid_inputs(rows, cols, block, rows * 10 + cols)

    def jax_tile(n_, w_, c_, r_, k_, i, j):
        t = n_[None, :] + w_[:, None] + c_ + 0.5 * r_[:, None] * k_[None, :] + i - 2.0 * j
        return t, t[-1, :], t[:, -1], t[-1, -1]

    def torch_tiles(n_, w_, c_, r_, k_, i, j):
        t = (n_[:, None, :] + w_[:, :, None] + c_[:, None, None]
             + 0.5 * r_[:, :, None] * k_[:, None, :] + i[:, None, None] - 2.0 * j[:, None, None])
        return t, t[:, -1, :], t[:, :, -1], t[:, -1, -1]

    want = rwf.wavefront_scan(
        jax_tile, rows=rows, cols=cols, block=block, north_init=jnp.asarray(north),
        west_init=jnp.asarray(west), corner_init=jnp.asarray(corner),
        row_inputs=jnp.asarray(row_in), col_inputs=jnp.asarray(col_in))
    got = wavefront.wavefront_scan(
        wavefront.tile_step(torch_tiles, torch.from_numpy(row_in), torch.from_numpy(col_in)),
        rows=rows, cols=cols, block=block, north_init=torch.from_numpy(north),
        west_init=torch.from_numpy(west), corner_init=torch.from_numpy(corner))
    for f in ("tiles", "south_rows", "east_cols", "corners"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_wavefront_steps_in_dependency_order():
    seen = []

    def step(state, diag):
        for i, j in diag:
            for dep_ij in ((i - 1, j), (i, j - 1), (i - 1, j - 1)):
                assert dep_ij[0] < 0 or dep_ij[1] < 0 or dep_ij in seen
        seen.extend(diag)
    z = torch.zeros
    wavefront.wavefront_scan(step, rows=4, cols=6, block=2, north_init=z(6, 2),
                             west_init=z(4, 2), corner_init=z(5, 7))
    assert sorted(seen) == [(i, j) for i in range(4) for j in range(6)]


# -- task-grid streams -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_stream_map_independent_equal(n):
    xs = np.arange(64, dtype=np.float32) - 20.0
    got = streams.stream_map(lambda c: torch.sqrt(torch.abs(c)) * 2.0, torch.from_numpy(xs),
                             num_streams=n)
    want = rstreams.stream_map(lambda c: jnp.sqrt(jnp.abs(c)) * 2.0, jnp.asarray(xs),
                               num_streams=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_stream_map_pytree():
    a, b = np.arange(16, dtype=np.float32), np.ones((16, 3), np.float32)
    got = streams.stream_map(lambda t: {"y": t["a"][:, None] + t["b"]},
                             {"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                             num_streams=4)
    np.testing.assert_array_equal(got["y"].numpy(), a[:, None] + b)


@pytest.mark.parametrize("n_streams,halo_w", [(1, 1), (2, 1), (4, 2), (8, 3), (2, 3), (4, 1)])
def test_stream_map_halo_stencil_equal(n_streams, halo_w):
    """The reference's halo stencil (tests/test_streams.py): chunks with
    redundant halos, the stencil run on each, the core kept."""
    xs = np.random.default_rng(0).normal(size=64).astype(np.float32)

    def chunk_fn(roll):
        def fn(chunk):
            out = chunk
            for _ in range(halo_w):
                out = 0.5 * (roll(out, 1) + roll(out, -1))
            return out[halo_w:-halo_w]
        return fn

    got = streams.stream_map(chunk_fn(lambda x, s: torch.roll(x, s)), torch.from_numpy(xs),
                             num_streams=n_streams, category=dep.Category.FALSE_DEPENDENT,
                             halo=halo_w)
    want = rstreams.stream_map(chunk_fn(jnp.roll), jnp.asarray(xs), num_streams=n_streams,
                               category=rdep.Category.FALSE_DEPENDENT, halo=halo_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_stream_scan_prefix_sum_equal(n):
    xs = np.arange(32, dtype=np.float32)

    def fn(cumsum):
        def chunk_fn(carry, chunk):
            s = carry + cumsum(chunk)
            return s[-1], s
        return chunk_fn

    carry, out = streams.stream_scan(fn(lambda c: torch.cumsum(c, 0)), torch.tensor(0.0),
                                     torch.from_numpy(xs), num_streams=n)
    rcarry, rout = rstreams.stream_scan(fn(jnp.cumsum), jnp.float32(0), jnp.asarray(xs),
                                        num_streams=n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    assert float(carry) == float(rcarry) == float(xs.sum())


@pytest.mark.parametrize("kw", [dict(num_streams=4, xs=10),
                                dict(num_streams=2, category="SYNC"),
                                dict(num_streams=2, category="ITERATIVE"),
                                dict(num_streams=2, category="TRUE_DEPENDENT")], ids=str)
def test_stream_map_errors_as_reference(kw):
    n = kw.get("xs", 8)
    cat = kw.get("category", "INDEPENDENT")
    with pytest.raises(ValueError):
        rstreams.stream_map(lambda c: c, jnp.arange(float(n)), num_streams=kw["num_streams"],
                            category=rdep.Category[cat])
    with pytest.raises(ValueError):
        streams.stream_map(lambda c: c, torch.arange(float(n)), num_streams=kw["num_streams"],
                           category=dep.Category[cat])


@pytest.mark.parametrize("costs,n", [([8.0, 7.0, 6.0, 5.0, 4.0, 3.0], 2), ([2.0, 1.0], 4),
                                     ([], 3), ([float(i % 5 + 1) for i in range(12)], 4),
                                     ([1.0, 1.0, 1.0], 1)])
def test_batch_schedule_equal(costs, n):
    assert streams.batch_schedule(costs, n) == rstreams.batch_schedule(costs, n)


def test_batch_schedule_invalid():
    with pytest.raises(ValueError):
        streams.batch_schedule([1.0], 0)


# -- plan_streaming ------------------------------------------------------------------


@pytest.mark.parametrize("name,stages,halo_kw", [
    ("nn", (0.02, 0.98, 0.0), {}),
    ("nn", (0.45, 0.55, 0.0), {}),
    ("sgemm", (0.3, 0.5, 0.2), dict(max_streams=4)),
    ("lavaMD", (0.3476, 0.3380, 0.0), dict(halo_elements=222, task_elements=250)),
    ("FastWalshTransform", (0.4, 0.5, 0.1), dict(halo_elements=254, task_elements=1048576)),
    ("hotspot", (0.4, 0.6, 0.0), {}),
    ("kmeans-centroids", (0.4, 0.6, 0.0), {}),
    ("nw", (0.2, 0.7, 0.1), {}),
    ("nw", (0.95, 0.05, 0.0), {}),
], ids=str)
def test_plan_streaming_equal(name, stages, halo_kw):
    got = streams.plan_streaming(dep.PAPER_TABLE2[name][0], rmetric.StageTimes(*stages),
                                 **halo_kw)
    want = rstreams.plan_streaming(rdep.PAPER_TABLE2[name][0], rrm.StageTimes(*stages),
                                   **halo_kw)
    assert (got.category.value, got.decision, got.num_streams, got.notes) == \
        (want.category.value, want.decision, want.num_streams, want.notes)


# -- the host executor on the CPU ------------------------------------------------------


def test_executor_cpu_outputs_equal_unstreamed_and_reference():
    tasks = [np.full((128,), i, np.float32) + np.arange(128, dtype=np.float32)
             for i in range(6)]
    ex = streams.HostStreamExecutor(lambda x: (x * 2.0).sum(), num_streams=3, device="cpu")
    out1, stats1 = ex.single_stream_run([torch.from_numpy(t) for t in tasks])
    out2, stats2 = ex.multi_stream_run([torch.from_numpy(t) for t in tasks])
    want = [float((torch.from_numpy(t) * 2.0).sum()) for t in tasks]
    assert [float(o) for o in out1] == [float(o) for o in out2] == want
    rex = rstreams.HostStreamExecutor(jax.jit(lambda x: (x * 2.0).sum()), num_streams=3)
    rout, _ = rex.multi_stream_run(tasks)
    np.testing.assert_allclose(np.asarray(rout), want, rtol=1e-6)
    assert stats1.h2d > 0 and stats1.kex > 0 and stats1.wall > 0
    assert stats2.h2d > 0 and stats2.kex > 0 and stats2.d2h >= 0 and stats2.wall > 0


def test_executor_cpu_pytree_tasks():
    rng = np.random.default_rng(3)
    tasks = [(torch.from_numpy(rng.standard_normal((8, 4), np.float32)),
              torch.from_numpy(rng.standard_normal((4, 5), np.float32))) for _ in range(5)]
    ex = streams.HostStreamExecutor(lambda t: {"y": t[0] @ t[1]}, num_streams=2, device="cpu")
    outs, _ = ex.multi_stream_run(tasks)
    for (x, y), o in zip(tasks, outs):
        assert torch.equal(o["y"], x @ y)


def test_executor_cpu_measure_r_and_link_emulation():
    tasks = [torch.ones((64, 64)) for _ in range(4)]
    ex = streams.HostStreamExecutor(lambda x: torch.tanh(x @ x.T).sum(), num_streams=2,
                                    device="cpu")
    r, stats = ex.measure_r(tasks)
    assert 0.0 <= r <= 1.0 and r == stats.stage_times().ratio()
    slow = streams.HostStreamExecutor(lambda x: x + 1, num_streams=2, device="cpu",
                                      link_bw=4 * 64 * 64 * 4 / 0.02)  # 20 ms for 4 tasks
    _, s = slow.single_stream_run(tasks)
    assert s.h2d >= 0.02 and s.d2h >= 0.02


def test_stream_stats_overlap_from_intervals():
    st = streams.StreamStats(intervals=[
        {"h2d": (0.0, 1.0), "kex": (1.0, 3.0), "d2h": (3.0, 3.5)},
        {"h2d": (1.0, 2.5), "kex": (2.5, 4.0), "d2h": (4.0, 4.2)},
        {"h2d": (2.0, 3.5), "kex": (3.5, 5.0), "d2h": (5.0, 5.1)}])
    # task 1's H2D [1, 2.5] under task 0's KEX [1, 3]: 1.5; task 2's H2D
    # [2, 3.5] under task 0's KEX [2, 3] and task 1's [2.5, 3.5]: 1.5 (union).
    assert st.h2d_kex_overlap() == pytest.approx(3.0)
    assert streams.StreamStats().h2d_kex_overlap() == 0.0


def test_executor_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streams.HostStreamExecutor(lambda x: x)


@pytest.mark.cuda
def test_link_bw_raises_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: link_bw is refused only on a CUDA device")
    with pytest.raises(ValueError, match="link"):
        streams.HostStreamExecutor(lambda x: x, device="cuda", link_bw=2e9)


def test_tree_leaves_order():
    tree = {"a": (torch.zeros(1), [torch.ones(1)]), "b": torch.full((1,), 2.0)}
    assert [float(t) for t in tree_leaves(tree)] == [0.0, 1.0, 2.0]
