"""The training path's loop half against the JAX package, on the CPU: AdamW
(``apply_updates`` on identical inputs, from a fresh and a mid-run state,
f32 and bf16 moments; the update written into the given tensors), the schedules, the
synthetic data (bit-equal to the reference's) and the prefetch pipeline,
the checkpointer (bf16 bit-exact, retention, atomicity, errors, a
snapshot that later in-place changes do not reach), the step
supervisor (the reference's cases, and a retry after a step that raised
part way), ``Trainer`` (8 steps from bridged params, losses equal to the
reference ``Trainer``'s at accum 1 and 2; resume) and the launcher.

Tolerances: AdamW 1e-6 (a bf16-stored leaf of the bridged mid-run step:
1e-6 or one bf16 ulp, where the two packages' f32 values straddle a
rounding boundary); the Trainer's losses rtol 1e-4 (eight steps compound
the two packages' f32 rounding); resumed = uninterrupted bit-equal (the
same operations on the same state).
"""

import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import pipeline as RD
from repro.optim import adamw as RA
from repro.optim import schedule as RS
from repro.runtime import trainer as RTR
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.tree import tree_from_paths, tree_paths
from repro_torch.data.pipeline import PrefetchIterator, SyntheticLM
from repro_torch.launch import steps as PSTEPS
from repro_torch.launch import train as PLAUNCH
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from repro_torch.optim import schedule as PS
from repro_torch.runtime.fault_tolerance import StepSupervisor, plan_elastic_mesh
from repro_torch.runtime.trainer import TrainConfig, Trainer

OPT_TOL = dict(atol=1e-6, rtol=1e-6)
BF16_ULP = dict(atol=1e-6, rtol=2 ** -7)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread (the tier-1 run's workers
    share the machine's cores; the old count comes back after the file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- AdamW and the schedules ------------------------------------------------------


def _opt_inputs(seed, bf16_params=False):
    rng = np.random.default_rng(seed)
    pdt = ml_dtypes.bfloat16 if bf16_params else np.float32
    params = {"w": rng.standard_normal((4, 3)).astype(pdt),
              "blk": {"b": rng.standard_normal(5).astype(np.float32),
                      "m": rng.standard_normal((2, 3, 2)).astype(np.float32)}}
    grads = {"w": (3 * rng.standard_normal((4, 3))).astype(pdt),
             "blk": {"b": rng.standard_normal(5).astype(np.float32),
                     "m": rng.standard_normal((2, 3, 2)).astype(np.float32)}}
    return params, grads


def _mid_state(params, seed, mdt):
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape)).astype(mdt), params)
    v = jax.tree.map(lambda p: (0.01 * rng.random(p.shape)).astype(mdt), params)
    return {"m": m, "v": v, "count": np.int32(6)}


def _torch_tree(t):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            (torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
             if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(np.array(v)))
            for k, v in t.items()}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _port_opt_state(state):
    """A reference state of these small trees as the port's (the model
    trees go through ``bridge.opt_state_from_numpy``)."""
    return {"m": _torch_tree(state["m"]), "v": _torch_tree(state["v"]),
            "count": torch.tensor(int(state["count"]), dtype=torch.int32)}


@pytest.mark.parametrize("case", ["fresh", "mid_run", "bf16_moments", "bf16_params"])
def test_apply_updates_matches_reference(case):
    params, grads = _opt_inputs(3, bf16_params=case == "bf16_params")
    mdt = ml_dtypes.bfloat16 if case == "bf16_moments" else np.float32
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    if case == "fresh":
        rstate = RA.init_state(jax.tree.map(jnp.asarray, params))
        rstate = jax.tree.map(np.asarray, rstate)
    else:
        rstate = _mid_state(params, 4, mdt)
    rcfg = RA.AdamWConfig(schedule=RS.warmup_cosine(3, 10),
                          moment_dtype=jnp.bfloat16 if mdt != np.float32 else jnp.float32, **kw)
    pcfg = PA.AdamWConfig(schedule=PS.warmup_cosine(3, 10),
                          moment_dtype=torch.bfloat16 if mdt != np.float32 else torch.float32,
                          **kw)
    rp, rs, rm = RA.apply_updates(rcfg, jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, grads),
                                  jax.tree.map(jnp.asarray, rstate))
    pp, pstate = _torch_tree(params), _port_opt_state(rstate)
    ids = [id(t) for _, t in tree_paths(pp)] + [id(t) for _, t in tree_paths(pstate)]
    pp2, ps, pm = PA.apply_updates(pcfg, pp, _torch_tree(grads), pstate)
    # in place: the params and the state given, updated
    assert pp2 is pp and ps is pstate
    assert [id(t) for _, t in tree_paths(pp)] + [id(t) for _, t in tree_paths(ps)] == ids
    want = dict(tree_paths({"p": rp, "m": rs["m"], "v": rs["v"]}))
    got = dict(tree_paths({"p": pp, "m": ps["m"], "v": ps["v"]}))
    for path, w in want.items():
        w = np.asarray(w)
        assert got[path].dtype == {np.dtype(ml_dtypes.bfloat16): torch.bfloat16}.get(
            w.dtype, torch.float32), path
        np.testing.assert_allclose(_np(got[path]), w.astype(np.float32), **OPT_TOL,
                                   err_msg=str(path))
    assert int(ps["count"]) == int(rs["count"])
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), **OPT_TOL)
    np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), **OPT_TOL)


def test_opt_state_from_numpy_takes_the_reference_state():
    cfg = PC.get_smoke_config("mamba2-2.7b")
    params = PT.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    m = {p: rng.standard_normal(t.shape).astype(ml_dtypes.bfloat16) for p, t in tree_paths(params)}
    tree = {"m": tree_from_paths(m.items()),
            "v": tree_from_paths((p, np.abs(a.astype(np.float32))) for p, a in m.items()),
            "count": np.int32(11)}
    st = bridge.opt_state_from_numpy(tree, cfg, device="cpu")
    assert int(st["count"]) == 11 and st["count"].dtype == torch.int32
    for path, t in tree_paths(st["m"]):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), m[path].view(np.int16))
    assert dict(tree_paths(st["v"]))[("embed",)].dtype == torch.float32
    tree["m"]["embed"] = tree["m"]["embed"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        bridge.opt_state_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("mdt", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_apply_updates_from_a_bridged_mid_run_state(mdt):
    """Three reference AdamW steps on a smoke model, then its params and
    state carried across by the bridge: the fourth step on identical grads
    gives the reference's params and moments."""
    cfg = PC.get_smoke_config("qwen2-moe-a2.7b")
    params = tree_from_paths((p, t.numpy()) for p, t in
                             tree_paths(PT.init_params(cfg, 1, device="cpu")))
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(4)]
    rcfg = RA.AdamWConfig(lr=2e-3, moment_dtype=mdt, schedule=RS.warmup_cosine(2, 10))
    rp = jax.tree.map(jnp.asarray, params)
    rs = RA.init_state(rp, mdt)
    for g in grads[:3]:
        rp, rs, _ = RA.apply_updates(rcfg, rp, jax.tree.map(jnp.asarray, g), rs)
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, rp), cfg, device="cpu")
    ps = bridge.opt_state_from_numpy(jax.tree.map(np.asarray, rs), cfg, device="cpu")
    rp, rs, _ = RA.apply_updates(rcfg, rp, jax.tree.map(jnp.asarray, grads[3]), rs)
    pcfg = PA.AdamWConfig(lr=2e-3, moment_dtype=ps["m"]["embed"].dtype,
                          schedule=PS.warmup_cosine(2, 10))
    PA.apply_updates(pcfg, pp, bridge.params_from_numpy(grads[3], cfg, device="cpu"), ps)
    got = dict(tree_paths({"p": pp, "m": ps["m"], "v": ps["v"]}))
    for path, w in tree_paths({"p": rp, "m": rs["m"], "v": rs["v"]}):
        # a bf16 leaf: its f32 value one f32 ulp apart can round to
        # neighbouring bf16 values, one bf16 ulp (2^-7 relative) apart
        tol = BF16_ULP if got[path].dtype == torch.bfloat16 else OPT_TOL
        np.testing.assert_allclose(_np(got[path]), np.asarray(w).astype(np.float32),
                                   **tol, err_msg=str(path))
    assert int(ps["count"]) == int(rs["count"]) == 4


def test_apply_updates_commit_error_when_a_write_fails(monkeypatch):
    params, grads = _opt_inputs(5)
    cfg = PA.AdamWConfig()
    p, g = _torch_tree(params), _torch_tree(grads)
    st = PA.init_state(p)
    calls = {"n": 0}
    real = PA._update

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("out of memory")
        return real(*a, **k)

    monkeypatch.setattr(PA, "_update", flaky)
    with pytest.raises(PA.CommitError, match="1 leaves"):
        PA.apply_updates(cfg, p, g, st)
    calls["n"] = 1  # the first write fails: nothing was written, a plain error
    p2 = _torch_tree(params)
    with pytest.raises(RuntimeError, match="out of memory") as e:
        PA.apply_updates(cfg, p2, g, PA.init_state(p2))
    assert not isinstance(e.value, PA.CommitError)


def test_schedules_match_reference():
    for warm, total in ((0, 10), (3, 10), (10, 100)):
        r, p = RS.warmup_cosine(warm, total), PS.warmup_cosine(warm, total)
        for step in range(0, total + 3):
            np.testing.assert_allclose(float(p(step)), float(r(jnp.int32(step))), rtol=1e-6)
            np.testing.assert_allclose(float(p(torch.tensor(step, dtype=torch.int32))),
                                       float(r(jnp.int32(step))), rtol=1e-6)
    assert float(PS.constant()(torch.tensor(5))) == 1.0
    assert PS.warmup_cosine(3, 10)(torch.tensor(4)).dtype == torch.float32


# -- data ---------------------------------------------------------------------------


def test_synthetic_batches_bit_equal_to_reference():
    extra = {"enc_inputs": ((3, 4), np.float32)}
    r = RD.SyntheticLM(500, global_batch=3, seq_len=7, seed=5, extra=extra)
    p = SyntheticLM(500, global_batch=3, seq_len=7, seed=5, extra=extra)
    for step in (0, 1, 9):
        a, b = r.batch_at(step), p.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_matches_sync_and_resume_skips():
    mk = lambda: SyntheticLM(100, global_batch=2, seq_len=8, seed=1)  # noqa: E731
    it0 = PrefetchIterator(iter(mk()), depth=0, device="cpu")
    it3 = PrefetchIterator(iter(mk()), depth=3, device="cpu")
    for step in range(5):
        a, b = next(it0), next(it3)
        assert isinstance(b["tokens"], torch.Tensor) and b["tokens"].dtype == torch.int32
        torch.testing.assert_close(a["tokens"], b["tokens"], rtol=0, atol=0)
        np.testing.assert_array_equal(a["tokens"].numpy(), mk().batch_at(step)["tokens"])
    worker = it3._thread
    it3.close()
    assert not worker.is_alive()
    it = PrefetchIterator(iter(mk()), depth=2, start_step=3, device="cpu")
    np.testing.assert_array_equal(next(it)["tokens"].numpy(), mk().batch_at(3)["tokens"])
    it.close()


def test_make_batch_shapes_and_seed():
    cfg = PC.get_smoke_config("whisper-medium")
    a = PSTEPS.make_batch(cfg, 3, global_batch=2, seq_len=5, device="cpu")
    b = PSTEPS.make_batch(cfg, 3, global_batch=2, seq_len=5, device="cpu")
    assert a["tokens"].shape == (2, 5) and a["tokens"].dtype == torch.int32
    assert a["enc_inputs"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert int(a["tokens"].max()) < cfg.vocab_size
    for k in a:
        assert torch.equal(a[k], b[k])


# -- the checkpointer -----------------------------------------------------------------


def test_checkpoint_roundtrip_bf16_bit_exact(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    tree = {"p": {"w": x.to(torch.bfloat16), "b": x[0]},
            "opt": {"count": torch.tensor(4, dtype=torch.int32)}}
    ck.save(7, tree, meta={"note": "x"}, blocking=True)
    got, meta = ck.restore(device="cpu")
    assert meta == {"note": "x", "step": 7}
    assert got["p"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["p"]["w"].view(torch.int16), tree["p"]["w"].view(torch.int16))
    assert torch.equal(got["p"]["b"], x[0]) and int(got["opt"]["count"]) == 4
    assert got["opt"]["count"].dtype == torch.int32


def test_checkpoint_retention_and_atomicity(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.tensor([float(s)])})
    ck.wait()
    assert ck.latest_step() == 4 and ck.steps() == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    # a save that died mid-write leaves a .tmp (even with a marker) and a
    # directory without DONE: neither is listed
    os.makedirs(tmp_path / "step_0000000009.tmp")
    (tmp_path / "step_0000000009.tmp" / "DONE").write_text("ok")
    os.makedirs(tmp_path / "step_0000000008")
    assert ck.steps() == [3, 4]
    got, meta = ck.restore(device="cpu")
    assert meta["step"] == 4 and float(got["x"]) == 4.0


def test_checkpoint_write_error_surfaces_on_next_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    ck.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.steps() == []
    with pytest.raises(FileNotFoundError):
        ck.restore(device="cpu")


def test_checkpoint_snapshot_is_not_changed_by_later_in_place_updates(tmp_path, monkeypatch):
    """A non-blocking save of CPU tensors, then the tree changed in place
    (as the training step does) before the worker writes: the checkpoint
    holds the values of the save."""
    ck = Checkpointer(str(tmp_path))
    go = threading.Event()
    real = np.savez

    def held(*a, **k):
        assert go.wait(10)
        return real(*a, **k)

    monkeypatch.setattr(np, "savez", held)
    tree = {"p": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "m": torch.ones(4, dtype=torch.bfloat16),
            "count": torch.tensor(3, dtype=torch.int32)}
    want = {k: v.clone() for k, v in tree.items()}
    ck.save(3, tree)
    tree["p"].add_(100.0)
    tree["m"].mul_(2.0)
    tree["count"].add_(1)
    go.set()
    ck.wait()
    got, meta = ck.restore(device="cpu")
    assert meta["step"] == 3
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# -- the supervisor -------------------------------------------------------------------


def test_supervisor_retry_then_success():
    sup = StepSupervisor(max_retries=2)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("preempted")
        return "ok"

    assert sup.run_step(0, flaky) == "ok"
    assert sup.straggler_report()["failures"] == [0, 0]


def test_supervisor_exhausted_retries_raise():
    sup = StepSupervisor(max_retries=1)
    with pytest.raises(RuntimeError):
        sup.run_step(0, lambda: 1 / 0)


def test_supervisor_straggler_detection():
    import time
    sup = StepSupervisor(straggler_factor=3.0)
    for i in range(8):
        sup.run_step(i, lambda: time.sleep(0.005))
    sup.run_step(8, lambda: time.sleep(0.08))
    assert 8 in sup.straggler_report()["stragglers"]


def test_elastic_plan():
    plan = plan_elastic_mesh(230, model_parallel=16)
    assert (plan.model, plan.data) == (16, 8) and plan.n_devices <= 230
    with pytest.raises(ValueError):
        plan_elastic_mesh(8, model_parallel=16)


def _smoke_state(arch="qwen3-4b", seed=0):
    cfg = PC.get_smoke_config(arch)
    params = PT.init_params(cfg, seed, device="cpu")
    return cfg, params, PA.init_state(params)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone() for k, v in tree.items()}


def test_retry_after_a_step_that_raised_midway(monkeypatch):
    """The step raises after its forward: the supervisor's retry starts from
    the params and moments as they were, and ends where a clean step does."""
    cfg, params, opt = _smoke_state()
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, global_batch=2, seq_len=16).batch_at(0).items()}
    ocfg = PA.AdamWConfig(lr=1e-2)
    clean_p, clean_o = _clone(params), _clone(opt)
    PSTEPS.make_train_step(cfg, ocfg)(clean_p, clean_o, batch)

    real = PT.train_loss
    calls = {"n": 0}

    def flaky(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("link flap")
        return out

    monkeypatch.setattr(PT, "train_loss", flaky)
    step = PSTEPS.make_train_step(cfg, ocfg)
    sup = StepSupervisor(max_retries=2)
    sup.run_step(0, lambda: step(params, opt, batch))
    assert calls["n"] == 2 and sup.straggler_report()["failures"] == [0]
    for (path, a), (_, b) in zip(tree_paths({"p": params, "o": opt}),
                                 tree_paths({"p": clean_p, "o": clean_o})):
        assert torch.equal(a, b), path


# -- Trainer and the launcher -------------------------------------------------------------


class _RefTrainer(RTR.Trainer):
    def __init__(self, *a, tree, **k):
        super().__init__(*a, **k)
        self._tree = tree

    def init_state(self, key):
        params = jax.tree.map(jnp.asarray, self._tree)
        return params, RA.init_state(params, self.opt_cfg.moment_dtype)


class _PortTrainer(Trainer):
    def __init__(self, *a, tree, **k):
        super().__init__(*a, **k)
        self._tree = tree

    def init_state(self, seed):
        params = bridge.params_from_numpy(self._tree, self.cfg, device=self.device)
        return params, PA.init_state(params, self.opt_cfg.moment_dtype)


def _tree(cfg):
    return tree_from_paths([(path, t.numpy()) for path, t in
                            tree_paths(PT.init_params(cfg, 0, device="cpu"))])


TRAIN_KW = dict(global_batch=4, seq_len=32, steps=8, log_every=100, lr=3e-3, warmup=2)


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_losses_match_reference(accum):
    pcfg, rcfg = PC.get_smoke_config("qwen3-4b"), RC.get_smoke_config("qwen3-4b")
    tree = _tree(pcfg)
    want = _RefTrainer(rcfg, RTR.TrainConfig(accum=accum, prefetch_depth=0, **TRAIN_KW),
                       tree=tree, log=lambda *_: None).train()["losses"]
    got = _PortTrainer(pcfg, TrainConfig(accum=accum, **TRAIN_KW), tree=tree,
                       device="cpu", log=lambda *_: None).train()
    assert len(got["losses"]) == 8 and len(got["step_s"]) == 8
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]


def test_trainer_resume_equals_uninterrupted(tmp_path):
    cfg = PC.get_smoke_config("qwen3-4b")
    tree = _tree(cfg)
    kw = dict(TRAIN_KW, checkpoint_every=4, prefetch_depth=0)
    full = _PortTrainer(cfg, TrainConfig(**kw), tree=tree, device="cpu",
                        log=lambda *_: None).train()["losses"]
    d = str(tmp_path / "ck")
    logs = []
    _PortTrainer(cfg, TrainConfig(checkpoint_dir=d, **kw), tree=tree, device="cpu",
                 log=logs.append).train()
    ck = Checkpointer(d)
    assert ck.steps() == [3, 7]
    import shutil
    shutil.rmtree(ck._step_dir(7))  # the run died before its final save
    resumed = _PortTrainer(cfg, TrainConfig(checkpoint_dir=d, **kw), tree=tree, device="cpu",
                           log=logs.append).train()
    assert "[trainer] resumed from step 3" in logs
    assert resumed["losses"] == full[4:]


def test_trainer_refuses_a_mesh_and_a_torn_state(monkeypatch):
    cfg = PC.get_smoke_config("qwen3-4b")
    # a mesh needs its process group (training over a mesh:
    # tests/test_torch_multidevice.py)
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg, TrainConfig(), mesh=object(), device="cpu")

    def torn(*a, **k):
        raise PA.CommitError("half-updated")

    tr = Trainer(cfg, TrainConfig(global_batch=2, seq_len=8, steps=1), device="cpu",
                 log=lambda *_: None)
    monkeypatch.setattr(tr, "_step_fn", torn)
    with pytest.raises(RuntimeError, match="failed after 3 attempts"):
        tr.train()
    assert tr._torn
    assert [r.error.split(":")[0] for r in tr.supervisor.history] == [
        "CommitError", "RuntimeError", "RuntimeError"]


def test_launcher_runs_on_cpu(capsys):
    out = PLAUNCH.main(["--arch", "mamba2-2.7b", "--device", "cpu", "--steps", "3",
                        "--batch", "2", "--seq", "16"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] mamba2-2.7b: loss ") and "supervisor: {" in line
    assert len(out["losses"]) == 3
    mesh_args = PLAUNCH.parse_args(["--mesh-data", "2"])
    assert (mesh_args.mesh_data, mesh_args.mesh_model) == (2, 1)
    tc = PLAUNCH.train_config(PLAUNCH.parse_args(["--steps", "40"]))
    assert (tc.warmup, tc.checkpoint_every, tc.lr) == (4, 10, 1e-3)


def test_prefetch_worker_error_reaches_the_consumer():
    def broken():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise OSError("shard missing")

    it = PrefetchIterator(broken(), depth=2, device="cpu")
    next(it)
    with pytest.raises(OSError, match="shard missing"):
        next(it)
    it.close()
