"""One rank of the gloo runs of ``tests/test_torch_multidevice.py``:
``python -m torch.distributed.run --standalone --nproc-per-node N
tests/_torch_mesh_worker.py <a|b> <io dir>`` with ``PYTHONPATH=src``.
It imports the port only (no JAX); the test reads what rank 0 writes
into the io dir (``<task>.json``, ``<task>_*.npz``) and holds it to the
JAX package.

Task ``a`` (8 ranks): the sharded train step on 4 x 2 (qwen3-4b smoke
from the bridged params the test wrote, plain and gather-once; the same
step with ``grad_placements`` left out), mixtral on 2 x 2 x 2 and mamba2
on 4 x 2 (bridged params too) against the port's single-device step, the prefill and decode
steps of whisper on 4 x 2 against one device, the blocking and ring
collective matmuls on an 8-wide ``model`` axis with their cost-counter
traffic, and a checkpoint of qwen3's params and AdamW state saved on 8 x 1.
Task ``b`` (4 ranks): that checkpoint restored onto 2 x 2;
``Trainer(mesh=)`` on 4 x 1 against the single-device ``Trainer``, its
checkpoints, and a resume on 2 x 2.
"""

import copy
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge, configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import costanalysis, overlap
from repro_torch.core.tree import tree_paths
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.launch import steps
from repro_torch.models import meshutil
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import TrainConfig, Trainer

ACCUM = 2


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _grad_err(got: dict, want: dict | None) -> float | None:
    """Largest |got - want| of a leaf over that leaf's max |want| (every
    rank joins the gathers; ``want`` only on rank 0, which alone answers)."""
    full = [(path, _full(g)) for path, g in tree_paths(got)]
    if want is None:
        return None
    want = dict(tree_paths(want))
    worst = 0.0
    for path, g in full:
        w = want[path]
        scale = max(float(w.abs().max()), 1e-30)
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def _sharded_step(cfg, params, batch, mesh, *, regather=False):
    """One sharded step from copies of ``params`` (full tensors) and a
    global batch: (metrics, the params after it as full tensors)."""
    specs = S.param_specs(params, mesh)
    p = S.distribute(copy.deepcopy(params), specs, mesh)
    o = adamw.init_state(p)
    b = S.distribute_batch(batch, mesh, accum=ACCUM)
    rg = (S.drop_axis(specs), specs) if regather else None
    _, _, m = steps.make_train_step(cfg, adamw.AdamWConfig(), accum=ACCUM, regather_specs=rg,
                                    keep_grads=True)(p, o, b)
    return m, {path: _full(t).detach() for path, t in tree_paths(p)}


def _local_step(cfg, params, batch):
    p = copy.deepcopy(params)
    o = adamw.init_state(p)
    _, _, m = steps.make_train_step(cfg, adamw.AdamWConfig(), accum=ACCUM,
                                    keep_grads=True)(p, o, batch)
    return m, dict(tree_paths(p))


def _compare(cfg, params, batch, mesh, **kw) -> dict:
    """The sharded step on every rank; the single-device step and the
    comparison on rank 0 (what rank 0 writes is all the test reads)."""
    m2, p2 = _sharded_step(cfg, params, batch, mesh, **kw)
    if dist.get_rank() != 0:
        _grad_err(m2["grads"], None)
        return {}, p2
    m1, p1 = _local_step(cfg, params, batch)
    return {"loss": float(m2["loss"]), "local_loss": float(m1["loss"]),
            "aux": float(m2["aux"]), "local_aux": float(m1["aux"]),
            "grad_norm": float(m2["grad_norm"]), "local_grad_norm": float(m1["grad_norm"]),
            "grad_err": _grad_err(m2["grads"], m1["grads"]),
            "param_diff": max(float((p2[k] - p1[k]).abs().max()) for k in p1)}, p2


def _serve_steps(arch: str, mesh) -> dict:
    """make_prefill_step and make_decode_step over ``mesh`` against one
    device: the largest difference of this rank's rows of the logits,
    the most over the ranks."""
    cfg = configs.get_smoke_config(arch)
    params = T.init_params(cfg, 0, device="cpu")
    batch = steps.make_batch(cfg, 2, global_batch=8, seq_len=32, device="cpu")
    prefill, decode = steps.make_prefill_step(cfg, max_seq=48), steps.make_decode_step(cfg)
    want, want_caches = prefill(params, batch)
    tok = want.argmax(-1).to(torch.int32)  # (8, 1)
    cur = torch.full((8,), 32, dtype=torch.int32)
    want2, _ = decode(params, want_caches, tok, cur)
    p = S.distribute(params, S.param_specs(params, mesh), mesh)
    got, caches = prefill(p, S.distribute_batch(batch, mesh))
    tok_l = S.distribute_batch({"tokens": tok}, mesh)["tokens"]
    rows = S.local_batch({"i": torch.arange(8)}, mesh)["i"]
    got2, _ = decode(p, caches, tok_l, cur[rows])
    err = torch.tensor([float((got - want[rows]).abs().max()),
                        float((got2 - want2[rows]).abs().max())])
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return {"prefill_err": float(err[0]), "decode_err": float(err[1]),
            "local_rows": int(rows.numel())}


def _inputs(io: str, name: str, cfg) -> tuple[dict, dict]:
    """The bridged params and the batch the test wrote for ``name``."""
    z = np.load(os.path.join(io, f"{name}_in.npz"))
    tree = {}
    for key in z.files:
        if key.startswith("p/"):
            node = tree
            parts = key[2:].split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = z[key]
    return (bridge.params_from_numpy(tree, cfg, device="cpu"),
            {"tokens": torch.from_numpy(z["tokens"])})


def _save_params(io: str, name: str, p2: dict) -> None:
    if dist.get_rank() == 0:
        np.savez(os.path.join(io, f"a_{name}.npz"),
                 **{"/".join(k): v.float().numpy() for k, v in p2.items()})


def task_a(io: str) -> dict:
    out = {}
    cfg = configs.get_smoke_config("qwen3-4b")
    params, batch = _inputs(io, "qwen3", cfg)
    mesh42 = M.make_mesh((4, 2), ("data", "model"))
    for name, kw in (("qwen3", {}), ("qwen3_regather", {"regather": True})):
        out[name], p2 = _compare(cfg, params, batch, mesh42, **kw)
        _save_params(io, name, p2)
    keep = meshutil._grad_placements
    meshutil._grad_placements = lambda *a: None  # the trap: no grad_placements
    try:
        out["qwen3_no_grad_placements"], _ = _compare(cfg, params, batch, mesh42)
    finally:
        meshutil._grad_placements = keep

    for arch, dims, axes in (("mixtral-8x7b", (2, 2, 2), ("pod", "data", "model")),
                             ("mamba2-2.7b", (4, 2), ("data", "model"))):
        c = configs.get_smoke_config(arch)
        p, b = _inputs(io, arch, c)
        out[arch], p2 = _compare(c, p, b, M.make_mesh(dims, axes))
        _save_params(io, arch, p2)

    out["serve_whisper-medium"] = _serve_steps("whisper-medium", mesh42)

    mesh8 = M.make_mesh((8,), ("model",))
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(64, 32, generator=g), torch.randn(32, 48, generator=g)
    mm = {}
    for maker in (overlap.make_sharded_ag_matmul, overlap.make_sharded_rs_matmul):
        for ring in (False, True):
            with costanalysis.CostCounter() as counter:
                y = maker(mesh8, "model", ring=ring)(x, w)
            mm[f"{maker.__name__}/{'ring' if ring else 'blocking'}"] = {
                "err": float((y.full_tensor() - x @ w).abs().max()),
                "traffic": {k: v for k, v in counter.totals.collective_by_op.items() if v}}
    out["matmuls"] = mm

    mesh81 = M.make_mesh((8, 1), ("data", "model"))
    specs = S.param_specs(params, mesh81)
    p = S.distribute(params, specs, mesh81)
    state = {"params": p, "opt": adamw.init_state(p)}
    Checkpointer(os.path.join(io, "ck")).save(0, state, blocking=True)
    arrays, _ = Checkpointer._snapshot(state)  # rank 0 alone makes host copies
    n = torch.tensor([len(arrays) if dist.get_rank() else 0])
    dist.all_reduce(n)
    out["snapshot_arrays"] = [len(arrays), int(n)]
    wq = state["params"]["blocks"]["layer0"]["mixer"]["wq"]
    out["saved_placements"] = str(wq.placements)
    out["saved_local_shape"] = list(wq.to_local().shape)
    return out


def task_b(io: str) -> dict:
    out = {}
    z = np.load(os.path.join(io, "qwen3_in.npz"))
    cfg = configs.get_smoke_config("qwen3-4b")
    mesh = M.make_mesh((2, 2), ("data", "model"))
    shapes = T.param_shapes(cfg)
    want = {tuple(k[2:].split("/")): torch.from_numpy(z[k]) for k in z.files
            if k.startswith("p/")}
    pspecs = S.param_specs(_meta(shapes), mesh)
    specs = {"params": pspecs, "opt": S.opt_state_specs(pspecs)}
    tree, meta = Checkpointer(os.path.join(io, "ck")).restore(device="cpu",
                                                              shardings=(mesh, specs))
    out["restored_step"] = meta["step"]
    out["restore_diff"] = max(float((_full(t).float() - want[path].float()).abs().max())
                              for path, t in tree_paths(tree["params"]))
    out["restore_leaves"] = len(tree_paths(tree["params"]))
    wq = tree["params"]["blocks"]["layer0"]["mixer"]["wq"]
    out["restored_placements"] = str(wq.placements)
    out["restored_local_shape"] = list(wq.to_local().shape)
    out["restored_mesh"] = list(wq.device_mesh.shape)
    out["moments_zero"] = all(float(_full(t).abs().max()) == 0.0
                              for _, t in tree_paths(tree["opt"]["m"]))

    # Trainer(mesh=) on 4 x 1 with checkpoints at steps 1 and 3 (the final
    # save writes step 3 again); step 3's removed, as if the job died before
    # it; a job on 2 x 2 resumes from step 1.
    kw = dict(global_batch=8, seq_len=32, steps=4, accum=ACCUM, log_every=100, lr=1e-3,
              warmup=2)
    ck_dir = os.path.join(io, "trainer_ck")
    quiet = lambda *_: None  # noqa: E731
    first = Trainer(cfg, TrainConfig(checkpoint_dir=ck_dir, checkpoint_every=2, **kw),
                    mesh=M.make_mesh((4, 1), ("data", "model")), device="cpu",
                    log=quiet).train()
    out["trainer_losses"] = first["losses"]
    out["trainer_steps_saved"] = Checkpointer(ck_dir).steps()
    dist.barrier()
    if dist.get_rank() == 0:
        import shutil

        shutil.rmtree(Checkpointer(ck_dir)._step_dir(3))
        out["trainer_local_losses"] = Trainer(cfg, TrainConfig(**kw), device="cpu",
                                              log=quiet).train()["losses"]
    dist.barrier()
    logs: list[str] = []
    resumed = Trainer(cfg, TrainConfig(checkpoint_dir=ck_dir, checkpoint_every=2, **kw),
                      mesh=mesh, device="cpu", log=logs.append).train()
    out["resumed_losses"] = resumed["losses"]
    out["resumed_log"] = logs[:1]
    return out


def _meta(shapes: dict) -> dict:
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v, device="meta")
            for k, v in shapes.items()}


def main() -> None:
    task, io = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    M.init_distributed("cpu")
    try:
        out = {"a": task_a, "b": task_b}[task](io)
        if dist.get_rank() == 0:
            with open(os.path.join(io, f"{task}.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
