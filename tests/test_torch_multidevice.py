"""The port over a device mesh, on CPU gloo ranks (the twin of the
reference's 8 fake CPU devices, ``tests/test_multidevice.py``): two runs
under ``torch.distributed.run``, ``OMP_NUM_THREADS=1``, smoke widths.

* 8 ranks (``tests/_torch_mesh_worker.py a``): the sharded qwen3-4b step
  on 4 x 2 (batch 8 x 32, accum 2), plain and gather-once, from the
  bridged params of the reference's ``init_params(PRNGKey(0))``, held to
  the JAX package's single-device ``make_train_step`` with the reference
  test's tolerances (loss 1e-4, params 1e-3, ``test_multidevice.py:116-118``)
  -- the reference's own sharded-vs-local comparison fails on this
  machine; every grad within 1e-5 of its leaf's max of the port's
  single-device step; the same step without ``grad_placements`` (it must
  differ); mixtral on 2 x 2 x 2 and mamba2 on 4 x 2 against the JAX
  single-device step computed here while the ranks run (the same
  tolerances) and the port's (grads 1e-5); whisper's prefill and decode steps on 4 x 2 against
  one device (1e-5); the blocking and ring
  collective matmuls on an
  8-wide ``model`` axis (1e-4; the cost counter sees only all-gather /
  reduce-scatter or only collective-permute); a checkpoint saved on 8 x 1.
* 4 ranks (``... b``): that checkpoint restored onto 2 x 2, leaf for
  leaf; ``Trainer(mesh=)`` on 4 x 1 against the single-device Trainer
  (losses rtol 1e-5), its checkpoints (one step saved twice), and the run
  resumed on 2 x 2 from its step-1 checkpoint (losses rtol 1e-5).
* the launcher's mesh path (``--mesh-data 1 --mesh-model 1 --device cpu``)
  in this process.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as RC
from repro.launch import steps as RSTEPS
from repro.models import transformer as RT
from repro.optim import adamw as RA

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_mesh_worker.py"
TIMEOUT = 300


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _torchrun(n: int, *args, timeout: int = TIMEOUT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


#: The sharded steps held to the JAX package's single-device step: name ->
#: (arch, seed of the reference's params).
JAX_CASES = {"qwen3": "qwen3-4b", "mixtral-8x7b": "mixtral-8x7b", "mamba2-2.7b": "mamba2-2.7b"}


@pytest.fixture(scope="module")
def inputs(io):
    """The reference's smoke params (``init_params(PRNGKey(0))``) and a
    batch of 8 x 32 tokens per case, written where the workers read them."""
    out = {}
    for name, arch in JAX_CASES.items():
        cfg = RC.get_smoke_config(arch)
        params = RT.init_params(cfg, jax.random.PRNGKey(0))
        tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, cfg.vocab_size)
        np.savez(io / f"{name}_in.npz", tokens=np.asarray(tokens, np.int32),
                 **{"p/" + "/".join(p): np.asarray(v) for p, v in _paths(params)})
        out[name] = cfg, params, tokens
    return out


def _jax_step(cfg, params, tokens):
    """The reference's single-device step at accum 2: (loss, params after)."""
    fn = RSTEPS.make_train_step(cfg, RA.AdamWConfig(), accum=2)
    p1, _, m1 = jax.jit(fn)(params, RA.init_state(params), {"tokens": tokens})
    return float(m1["loss"]), {"/".join(p): np.asarray(v) for p, v in _paths(p1)}


@pytest.fixture(scope="module")
def run_a_and_jax(io, inputs):
    """The 8-rank run, with the JAX single-device steps computed in this
    process while it runs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=8",
         str(WORKER), "a", str(io)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jax_steps = {name: _jax_step(*inputs[name]) for name in JAX_CASES}
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return json.loads((io / "a.json").read_text()), jax_steps


@pytest.fixture(scope="module")
def run_a(run_a_and_jax):
    return run_a_and_jax[0]


@pytest.fixture(scope="module")
def jax_step(run_a_and_jax):
    return run_a_and_jax[1]


@pytest.fixture(scope="module")
def run_b(io, run_a):
    _torchrun(4, str(WORKER), "b", str(io))
    return json.loads((io / "b.json").read_text())


@pytest.mark.parametrize("name", ["qwen3", "qwen3_regather", "mixtral-8x7b", "mamba2-2.7b"])
def test_sharded_step_equals_the_jax_single_device_step(run_a, jax_step, io, name):
    """qwen3 on 4 x 2 (plain and gather-once), mixtral on 2 x 2 x 2 (routing
    over a micro-batch's gathered rows, the aux loss over the shards) and
    mamba2 on 4 x 2, at accum 2 (micro-batch-major rows), against the
    reference's single-device step on the same params and tokens."""
    loss, want = jax_step[name.removesuffix("_regather")]
    got = np.load(io / f"a_{name}.npz")
    assert abs(run_a[name]["loss"] - loss) < 1e-4, (run_a[name]["loss"], loss)
    assert set(got.files) == set(want)
    diff = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    assert max(diff.values()) < 1e-3, sorted(diff.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("name", ["qwen3", "qwen3_regather", "mixtral-8x7b", "mamba2-2.7b"])
def test_sharded_step_equals_the_single_device_step(run_a, name):
    r = run_a[name]
    assert r["loss"] == pytest.approx(r["local_loss"], rel=1e-5, abs=1e-6)
    assert r["aux"] == pytest.approx(r["local_aux"], rel=1e-5, abs=1e-7)
    assert r["grad_norm"] == pytest.approx(r["local_grad_norm"], rel=1e-5)
    assert r["grad_err"] < 1e-5, r
    assert r["param_diff"] < 1e-3, r
    if name.startswith("mixtral"):
        assert r["aux"] > 0  # routing over the whole batch, on every rank


def test_prefill_and_decode_steps_over_a_mesh(run_a):
    """make_prefill_step / make_decode_step of whisper on 4 x 2 (a rank's 2
    rows, its share of the self-attention heads in the encoder and the
    decoder, the cross-attention whole): each rank's logits equal one
    device's rows."""
    r = run_a["serve_whisper-medium"]
    assert r["local_rows"] == 2
    assert r["prefill_err"] < 1e-5 and r["decode_err"] < 1e-5, r


def test_without_grad_placements_the_step_is_wrong(run_a):
    """The guard for the trap: each rank's gradient of a leaf replicated
    over ``data`` covers its own rows only; DTensor takes it for the whole
    one and raises nothing.  The loss is right, the gradients are not."""
    good, bad = run_a["qwen3"], run_a["qwen3_no_grad_placements"]
    assert bad["loss"] == pytest.approx(good["loss"], rel=1e-6)
    assert good["grad_err"] < 1e-5
    assert bad["grad_err"] > 0.1, bad
    assert bad["grad_norm"] != pytest.approx(bad["local_grad_norm"], rel=1e-3)


@pytest.mark.parametrize("case", ["make_sharded_ag_matmul/blocking", "make_sharded_ag_matmul/ring",
                                  "make_sharded_rs_matmul/blocking", "make_sharded_rs_matmul/ring"])
def test_collective_matmuls(run_a, case):
    r = run_a["matmuls"][case]
    assert r["err"] < 1e-4, r
    if case.endswith("ring"):
        want = {"collective-permute"}
    else:
        want = {"all-gather"} if "_ag_" in case else {"reduce-scatter"}
    assert set(r["traffic"]) == want, r["traffic"]


def test_checkpoint_restores_onto_another_mesh(run_a, run_b):
    """Saved by 8 ranks on 8 x 1, restored by 4 on 2 x 2: every leaf equal,
    ``wq`` (r, D, H hd) placed (data, model) on either mesh."""
    cfg = RC.get_smoke_config("qwen3-4b")
    r, d, f = cfg.n_repeats, cfg.d_model, cfg.n_heads * cfg.head_dim
    assert run_a["saved_placements"] == "(Shard(dim=1), Shard(dim=2))"
    assert run_a["saved_local_shape"] == [r, d // 8, f]
    n_params = len(list(_paths(RT.init_params(cfg, jax.random.PRNGKey(0)))))
    # rank 0 holds every leaf of params, m, v and the count; the others none
    assert run_a["snapshot_arrays"] == [3 * n_params + 1, 0]
    assert run_b["restored_step"] == 0
    assert run_b["restore_leaves"] == len(list(_paths(RT.init_params(cfg, jax.random.PRNGKey(0)))))
    assert run_b["restore_diff"] == 0.0
    assert run_b["moments_zero"]
    assert run_b["restored_mesh"] == [2, 2]
    assert run_b["restored_placements"] == "(Shard(dim=1), Shard(dim=2))"
    assert run_b["restored_local_shape"] == [r, d // 2, f // 2]


def test_a_rank_waiting_for_rank_0s_checkpoint_times_out(tmp_path, monkeypatch):
    from repro_torch.checkpoint import checkpointer

    monkeypatch.setattr(checkpointer, "DONE_TIMEOUT_S", 0.05)
    with pytest.raises(TimeoutError, match="did not publish step 4"):
        checkpointer.Checkpointer(str(tmp_path))._await_done(4, "ok 1 2")


def test_trainer_on_a_mesh_equals_one_device_and_resumes_on_another(run_b):
    got, want = run_b["trainer_losses"], run_b["trainer_local_losses"]
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # step 3 saved twice (periodic, then final): every rank waits for the second
    assert run_b["trainer_steps_saved"] == [1, 3]
    assert run_b["resumed_log"] == ["[trainer] resumed from step 1"]
    np.testing.assert_allclose(run_b["resumed_losses"], got[2:], rtol=1e-5)


def test_launcher_over_a_mesh(capsys):
    """The launcher's mesh path in this process (a world of 1 over gloo;
    the 8- and 4-rank runs above hold the sharded step and Trainer): it
    trains, prints its line, and leaves no process group behind."""
    import torch.distributed as dist

    from repro_torch.launch import train as launcher

    out = launcher.main(["--mesh-data", "1", "--mesh-model", "1", "--device", "cpu",
                         "--steps", "3", "--batch", "4", "--seq", "16"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] qwen3-4b: loss ") and len(out["losses"]) == 3
    assert not dist.is_initialized()
