"""The port's paper kernels on the CPU (their plain versions) against the
JAX package: ``ops.matmul``, ``ops.fwt``, ``ops.nw_tile`` and
``ops.nw_wavefront`` against the reference's ``ops.*`` (the Pallas kernels
in interpret mode) and ``ref.*``, at the reference tests' shapes, plus the
wrappers' input checks and the ``launch/streams`` entry point.  The kernels
themselves run only on a card: ``tests/test_torch_cuda.py``.

Tolerances, the reference tests' own: matmul rtol 1e-4 (f32) / 5e-2 (bf16)
with atol 8x rtol; NW 1e-4, and exact with integer scores.  FWT is held
bit for bit: the port's passes run the reference's f32 butterflies in the
same order (its older tests keep the reference's 1e-5 of max |y|).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import wavefront
from repro_torch.kernels import fwt as fwt_k
from repro_torch.kernels import nw_tile as nw_k
from repro_torch.kernels import ops, ref
from repro_torch.launch import streams as launch

ROOT = Path(__file__).resolve().parents[1]
MM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(x: np.ndarray, dtype: str):
    """The same values in both packages (bf16 rounds to nearest even in both)."""
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


# -- matmul ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm", [(32, 32, 32, 16), (64, 128, 96, 32), (128, 64, 32, 16),
                                      (32, 128, 64, 32)])
def test_matmul_matches_reference(m, k, n, bm, dtype):
    rng = np.random.default_rng(m + n + k)
    xj, xt = _pair(rng.standard_normal((m, k), np.float32), dtype)
    yj, yt = _pair(rng.standard_normal((k, n), np.float32), dtype)
    got = ops.matmul(xt, yt)
    assert got.dtype == xt.dtype and got.shape == (m, n)
    tol = MM_TOL[dtype]
    for want in (rops.matmul(xj, yj, block_m=bm, block_n=16, block_k=16),
                 rref.matmul_ref(xj, yj)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("dx,dy", [("float32", "bfloat16"), ("bfloat16", "float32")])
def test_matmul_mixed_types_match_reference(dx, dy):
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng.standard_normal((48, 40), np.float32), dx)
    yj, yt = _pair(rng.standard_normal((40, 24), np.float32), dy)
    got = ops.matmul(xt, yt)
    want = rref.matmul_ref(xj, yj)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=8e-4)


def test_matmul_ragged_shape_matches_reference():
    """The port takes any shape (its kernel masks edges); the reference's
    oracle is the yardstick where its tiled kernel needs multiples."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((37, 53), np.float32)
    y = rng.standard_normal((53, 29), np.float32)
    np.testing.assert_allclose(ops.matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(rref.matmul_ref(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-4, atol=8e-4)


@pytest.mark.parametrize("bad", ["shape", "inner", "dtype", "empty"])
def test_matmul_rejects(bad):
    x, y = torch.zeros(4, 3), torch.zeros(3, 5)
    if bad == "shape":
        x = torch.zeros(4, 3, 1)
    elif bad == "inner":
        y = torch.zeros(4, 5)
    elif bad == "dtype":
        x = x.double()
    else:
        x, y = torch.zeros(0, 3), torch.zeros(3, 5)
    with pytest.raises(ValueError):
        ops.matmul(x, y)


# -- FWT ---------------------------------------------------------------------------


@pytest.mark.parametrize("logn,block", [(4, 16), (6, 16), (8, 64), (10, 256), (11, 16),
                                        (12, 64), (13, 256), (10, None), (12, None)])
def test_fwt_flat_matches_reference(logn, block):
    n = 2 ** logn
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = ops.fwt(torch.from_numpy(x), block=block and min(block, n)).numpy()
    want = np.asarray(rref.fwt_ref(jnp.asarray(x)))
    kern = np.asarray(rops.fwt(jnp.asarray(x), block=block and min(block, n)))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
    np.testing.assert_allclose(got / scale, kern / scale, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwt_batched_rows_match_reference(dtype):
    xj, xt = _pair(np.random.default_rng(9).standard_normal((8, 128)).astype(np.float32), dtype)
    got = ops.fwt(xt)
    assert got.dtype == xt.dtype
    want = np.asarray(rops.fwt(xj), np.float32)
    scale = float(np.abs(want).max())
    # bf16: both round the same f32 butterflies once at the end.
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale, atol=1e-5)


def test_fwt_involution():
    n = 1024
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(n).astype(np.float32))
    twice = ops.fwt(ops.fwt(x, block=64), block=64)
    np.testing.assert_allclose(twice.numpy() / n, x.numpy(), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 16), (2, 1024), (256, 3), (1, 5)])
def test_fwt_columns_plain_matches_reference(dtype, shape):
    """The column pass's plain version is the reference's transform over
    axis 0 (``fwt_ref`` of the transpose) bit for bit; so is the wrapper on
    the CPU, in place too."""
    yj, yt = _pair(np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32),
                   dtype)
    want = np.asarray(rref.fwt_ref(yj.T).T, np.float32)
    got = ref.fwt_columns_plain(yt)
    assert got.dtype == yt.dtype and got.shape == yt.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(fwt_k.fwt_columns(yt).float().numpy(), want)
    assert fwt_k.fwt_columns(yt, out=yt) is yt
    np.testing.assert_array_equal(yt.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("logn,block", [(11, None), (12, 16), (14, 1024), (16, None),
                                        (13, 64)])
def test_fwt_flat_rows_then_columns_bit_equal(dtype, logn, block):
    """The port's flat path (rows, then columns, no transpose) against the
    JAX ``ops.fwt`` (Pallas, interpret mode) and ``ref.fwt_ref``, bit for
    bit: each butterfly is one correctly rounded f32 operation, in the same
    order.  bf16 rounds between the passes in both packages, so there the
    whole-vector oracle is ``fwt_ref`` applied pass by pass."""
    n = 2 ** logn
    b2 = block or min(n, 1024)
    xj, xt = _pair(np.random.default_rng(logn).standard_normal(n).astype(np.float32), dtype)
    got = ops.fwt(xt, block=block)
    assert got.dtype == xt.dtype and got.shape == (n,)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(rops.fwt(xj, block=block), np.float32))
    passes = rref.fwt_ref(rref.fwt_ref(xj.reshape(n // b2, b2)).T).T.reshape(n)
    np.testing.assert_array_equal(got, np.asarray(passes, np.float32))
    if dtype == "float32":
        np.testing.assert_array_equal(got, np.asarray(rref.fwt_ref(xj)))


@pytest.mark.parametrize("shape", [(12, 4), (3,), (0, 2), (4, 8, 2)])
def test_fwt_columns_rejects(shape):
    with pytest.raises(ValueError):
        fwt_k.fwt_columns(torch.zeros(shape))


def test_fwt_columns_rejects_a_mismatched_out():
    with pytest.raises(ValueError, match="does not match"):
        fwt_k.fwt_columns(torch.zeros((4, 3)), out=torch.zeros((4, 3), dtype=torch.bfloat16))


@pytest.mark.parametrize("shape", [(4, 12), (3,), (2, 0), (4, 8, 2)])
def test_fwt_block_rejects(shape):
    with pytest.raises(ValueError):
        fwt_k.fwt_block(torch.zeros(shape))


def test_fwt_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        ops.fwt(torch.zeros(12))


# -- NW ------------------------------------------------------------------------------


@pytest.mark.parametrize("gap", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_nw_tile_matches_reference(b, gap):
    rng = np.random.default_rng(b)
    north = rng.normal(size=b).astype(np.float32)
    west = rng.normal(size=b).astype(np.float32)
    corner = float(rng.normal())
    sub = rng.normal(size=(b, b)).astype(np.float32)
    got = ops.nw_tile(torch.from_numpy(north), torch.from_numpy(west), corner,
                      torch.from_numpy(sub), gap=gap).numpy()
    kern = np.asarray(rops.nw_tile(jnp.asarray(north), jnp.asarray(west), jnp.asarray(corner),
                                   jnp.asarray(sub), gap=gap))
    np.testing.assert_allclose(got, kern, atol=1e-4)
    np.testing.assert_allclose(got, rref.nw_ref(north, west, corner, sub, gap=gap), atol=1e-4)
    np.testing.assert_array_equal(ref.nw_ref(north, west, corner, sub, gap=gap),
                                  rref.nw_ref(north, west, corner, sub, gap=gap))


@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_nw_tile_integer_scores_exact(b):
    rng = np.random.default_rng(100 + b)
    north = rng.integers(-b, b, b).astype(np.float32)
    west = rng.integers(-b, b, b).astype(np.float32)
    sub = rng.choice([-1.0, 1.0], size=(b, b)).astype(np.float32)
    got = ops.nw_tile(torch.from_numpy(north), torch.from_numpy(west), -3.0,
                      torch.from_numpy(sub)).numpy()
    np.testing.assert_array_equal(got, rref.nw_ref(north, west, -3.0, sub))


@pytest.mark.parametrize("n,m,block", [(32, 32, 16), (48, 32, 16), (16, 32, 8), (64, 48, 16)])
def test_nw_wavefront_matches_reference(n, m, block):
    scores = np.random.default_rng(n * 100 + m).normal(size=(n, m)).astype(np.float32)
    got = ops.nw_wavefront(torch.from_numpy(scores), block=block).numpy()
    kern = np.asarray(rops.nw_wavefront(jnp.asarray(scores), block=block))
    np.testing.assert_allclose(got, kern, atol=1e-4)
    np.testing.assert_allclose(got, rref.nw_full_ref(scores), atol=1e-4)


@pytest.mark.parametrize("n,m,block,gap", [(64, 64, 8, 1.0), (96, 64, 32, 1.0),
                                           (128, 128, 16, 2.0), (64, 128, 64, 1.0)])
def test_nw_wavefront_integer_scores_exact(n, m, block, gap):
    """DNA match / mismatch scores of +-1: every value is exact, so the
    wavefront equals the sequential matrix bit for bit."""
    rng = np.random.default_rng(n + m)
    a, b = rng.integers(0, 4, n), rng.integers(0, 4, m)
    scores = np.where(a[:, None] == b[None, :], 1.0, -1.0).astype(np.float32)
    got = ops.nw_wavefront(torch.from_numpy(scores), block=block, gap=gap).numpy()
    want = ref.nw_full_ref(scores, gap=gap)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, rref.nw_full_ref(scores, gap=gap))
    np.testing.assert_array_equal(
        nw_k.nw_wavefront_plain(torch.from_numpy(scores), block=block, gap=gap).numpy(), want)


def test_nw_tiles_ref_batch_equals_single_tiles():
    rng = np.random.default_rng(4)
    t, b = 5, 16
    north, west = rng.normal(size=(t, b)), rng.normal(size=(t, b))
    corner, sub = rng.normal(size=t), rng.normal(size=(t, b, b))
    got = ref.nw_tiles_ref(*(torch.from_numpy(a.astype(np.float32))
                             for a in (north, west, corner, sub)), gap=0.5).numpy()
    for i in range(t):
        want = rref.nw_ref(north[i].astype(np.float32), west[i].astype(np.float32),
                           np.float32(corner[i]), sub[i].astype(np.float32), gap=0.5)
        np.testing.assert_allclose(got[i], want, atol=1e-4)


def test_nw_rejects():
    with pytest.raises(ValueError):
        ops.nw_wavefront(torch.zeros(30, 32), block=16)
    with pytest.raises(ValueError):
        ops.nw_tile(torch.zeros(8), torch.zeros(4), 0.0, torch.zeros(8, 8))
    z = torch.zeros
    state = wavefront.WavefrontState.create(rows=2, cols=2, block=12, north_init=z(2, 12),
                                            west_init=z(2, 12), corner_init=z(3, 3))
    with pytest.raises(ValueError, match="power"):
        nw_k.nw_diagonal(state, z(24, 24), [(0, 0)])
    state = wavefront.WavefrontState.create(rows=2, cols=2, block=8, north_init=z(2, 8),
                                            west_init=z(2, 8), corner_init=z(3, 3))
    with pytest.raises(ValueError, match="float32"):
        nw_k.nw_diagonal(state, z(16, 16, dtype=torch.float64), [(0, 0)])


# -- the NW kernel's strip schedule (ref.nw_strips_plain) ---------------------------


def _nw_case(n, m, integer):
    rng = np.random.default_rng(n * 7 + m + integer)
    if integer:
        a, b = rng.integers(0, 4, n), rng.integers(0, 4, m)
        return np.where(a[:, None] == b[None, :], 1.0, -1.0).astype(np.float32), 1.0
    return rng.normal(size=(n, m)).astype(np.float32), 0.5


_JAX_NW: dict = {}


def _jax_nw(n, m, block, integer):
    key = (n, m, block, integer)
    if key not in _JAX_NW:
        scores, gap = _nw_case(n, m, integer)
        _JAX_NW[key] = np.asarray(rops.nw_wavefront(jnp.asarray(scores), block=block, gap=gap,
                                                    interpret=True))
    return _JAX_NW[key]


def _strip_runs(rows, cols, kind):
    """The runs [(d0, d1, i0, i1)] of one wavefront: the whole grid, one
    diagonal's tiles in two runs of rows, or a partial run of diagonals;
    the diagonals around them run the plain diagonal."""
    last = rows + cols - 1
    if kind == "full":
        return [(0, last, 0, rows)]
    if kind == "diagonal":
        d = min(rows, cols) - 1
        i_lo, i_hi = max(0, d - cols + 1), min(rows - 1, d)
        mid = (i_lo + i_hi + 1) // 2
        return [(d, d + 1, i_lo, mid), (d, d + 1, mid, i_hi + 1)]
    return [(1, last - 2, 0, rows)]


@pytest.mark.parametrize("blocks", ["plan", 1, 2])
@pytest.mark.parametrize("kind", ["full", "diagonal", "partial"])
@pytest.mark.parametrize("n,m,block,integer", [(64, 48, 16, True), (64, 48, 16, False),
                                               (32, 96, 8, True), (48, 32, 8, False)],
                         ids=str)
def test_nw_strip_schedule_matches_reference(n, m, block, integer, kind, blocks):
    """The plain rows in the kernel's order: blocks take strips (tile
    columns) from the ticket, and a row waits only for the left strip's
    same row when the run computes that tile; every input is ready when a
    row runs (asserted inside).  Bit-equal to the JAX package's wavefront
    (its Pallas tile in interpret mode) and, with integer scores, to
    nw_full_ref; one step per row of the run's tiles."""
    scores, gap = _nw_case(n, m, integer)
    rows, cols = n // block, m // block
    state, sc, out = nw_k.initial_state(torch.from_numpy(scores), block, gap=gap)
    runs = _strip_runs(rows, cols, kind)
    diags = wavefront.diagonal_tiles(rows, cols)
    for d in range(runs[0][0]):
        nw_k.nw_diagonal_plain(state, sc, diags[d], gap=gap)
    for d0, d1, i0, i1 in runs:
        plan = nw_k.plan_strips(rows, cols, d0, d1, i0, i1)
        order = ref.nw_strips_plain(state, sc, d0, d1, gap=gap, i0=i0, i1=i1,
                                    blocks=plan.n_strips if blocks == "plan" else blocks)
        tiles = {(i, j) for i in range(i0, i1) for j in range(cols) if d0 <= i + j < d1}
        assert len({(i, j, r) for _, i, j, r in order}) == len(order)  # each row once
        assert {(i, j) for _, i, j, _ in order} == tiles and len(order) == block * len(tiles)
        assert {j for _, _, j, _ in order} == set(range(plan.j_lo, plan.j_lo + plan.n_strips))
    for d in range(runs[-1][1], rows + cols - 1):
        nw_k.nw_diagonal_plain(state, sc, diags[d], gap=gap)
    np.testing.assert_array_equal(out.numpy(), _jax_nw(n, m, block, integer))
    if integer:
        np.testing.assert_array_equal(out.numpy(), rref.nw_full_ref(scores, gap=gap))


def test_nw_run_on_cpu_is_the_strip_schedule():
    """nw_run on CPU tensors runs the plain rows in the kernel's strip
    order; over [0, 3), [3, 9) and the rest it equals the whole wavefront."""
    scores, gap = _nw_case(64, 48, False)
    state, sc, out = nw_k.initial_state(torch.from_numpy(scores), 16, gap=gap)
    n0 = nw_k.KERNEL.launches
    for d0, d1 in ((0, 3), (3, 5), (5, 6)):
        nw_k.nw_run(state, sc, d0, d1, gap=gap)
    assert nw_k.KERNEL.launches == n0  # a CPU tensor never launches
    np.testing.assert_array_equal(out.numpy(), _jax_nw(64, 48, 16, False))
    np.testing.assert_array_equal(
        ops.nw_wavefront(torch.from_numpy(scores), block=16, gap=gap).numpy(), out.numpy())


@pytest.mark.parametrize("args", [(4, 3, 0, 7, 0, 4), (4, 3, 2, 4, 0, 4), (4, 3, 2, 3, 1, 5),
                                  (4, 3, 3, 4, 3, 4), (4, 3, 0, 0, 0, 4)], ids=str)
def test_plan_strips(args):
    rows, cols, d0, d1, i0, i1 = args
    if not (0 <= d0 < d1 <= rows + cols - 1 and 0 <= i0 < i1 <= rows
            and (d1 == d0 + 1 or (i0, i1) == (0, rows))):
        with pytest.raises(ValueError):
            nw_k.plan_strips(*args)
        return
    plan = nw_k.plan_strips(*args)
    js = {j for i in range(i0, i1) for j in range(cols) if d0 <= i + j < d1}
    assert (plan.j_lo, plan.n_strips) == (min(js), len(js))
    assert js == set(range(plan.j_lo, plan.j_lo + plan.n_strips))


# -- plain versions against the reference's oracles ------------------------------------


def test_plain_oracles_match_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_allclose(ref.fwt_ref(torch.from_numpy(x)).numpy(),
                               np.asarray(rref.fwt_ref(jnp.asarray(x))), atol=1e-5)
    a, b = rng.standard_normal((16, 8), np.float32), rng.standard_normal((8, 4), np.float32)
    np.testing.assert_allclose(ref.matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(rref.matmul_ref(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)
    s = rng.normal(size=(24, 16)).astype(np.float32)
    np.testing.assert_array_equal(ref.nw_full_ref(s, gap=0.5), rref.nw_full_ref(s, gap=0.5))


# -- the entry point -------------------------------------------------------------------


def test_launch_streams_slice_matches_reference():
    """The slice as a whole on the CPU: each category's streamed outputs
    against the JAX package's oracles on the same seeded tasks."""
    results = launch.run(device="cpu", n_tasks=2, streams=2, small=True, seed=0)
    assert [r["category"] for r in results] == ["independent", "false-dependent",
                                                "true-dependent"]
    for i, (case, res) in enumerate(zip(launch.CASES, results)):
        tasks = launch.make_tasks(case, n_tasks=2, size=launch.SIZES["small"][case.kernel],
                                  seed=i, pin=False)
        assert res["multi_equals_single"] and res["max_abs_err"] <= res["tol"]
        assert 0.0 <= res["R"] <= 1.0
        assert res["task_runs"] == 2 * (2 * launch.WARMUP + 1 + 2 * launch.REPEATS)
        for task, got in zip(tasks, res["outputs"]):
            if case.kernel == "matmul":
                want = np.asarray(rref.matmul_ref(jnp.asarray(task[0].numpy()),
                                                  jnp.asarray(task[1].numpy())))
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
            elif case.kernel == "fwt":
                want = np.asarray(rref.fwt_ref(jnp.asarray(task.numpy())))
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_array_equal(got.numpy(), rref.nw_full_ref(task.numpy()))


def test_launch_streams_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.streams", "--device", "cpu", "--small",
         "--tasks", "2"], cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    for cat in ("independent (sgemm", "false-dependent (FastWalshTransform",
                "true-dependent (nw"):
        assert any(line.startswith(f"[streams] {cat}") for line in lines), out.stdout
    assert any("lavaMD" in line and "halo rule blocks streaming: True" in line for line in lines)


def test_launch_streams_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--small", "--tasks", "1"])
