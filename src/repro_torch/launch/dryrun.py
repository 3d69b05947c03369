"""Dry run over the production meshes (reference ``launch/dryrun.py``):
trace one step of every (arch x shape) cell as rank 0 of a 256- or
512-rank world, and extract the roofline terms.

The reference lowers and compiles each cell on 512 placeholder devices.
The port compiles nothing: it runs the step eagerly as rank 0 of a
``"fake"`` process group (``launch.mesh.init_fake``: collectives return
without moving data) under ``FakeTensorMode`` (tensors carry shapes and
types, no data), on the CPU -- the kernels' plain versions run there, so
no card is needed.  For each cell this shows:
  * the sharding is coherent (every placement and collective of the step
    resolves on the production mesh),
  * the memory a rank holds (its shards of the arguments, the outputs, and
    the most bytes that the step's own tensors hold at once),
  * and the step's flops / bytes / collective bytes for the roofline
    (``core.costanalysis``: the ops rank 0 dispatches, counted on its
    local shards).

Every repeat of the layer unit, and every micro-batch, dispatches the same
ops, so a cell is traced at 1 and 2 repeats (and, for training, at 2 and 3
micro-batches) and its counts are extended linearly to the config's depth
and accumulation -- the twin of the reference walker's trip counts
(``run_cell(exact=True)`` traces the whole step instead, the tests'
yardstick for the extension: a fake-tensor op costs about a tenth of a
millisecond on the host, and a full qwen3-4b train_4k step dispatches
millions).  The arguments and outputs are the full config's,
counted without tracing; the temporaries' peak is extended linearly in
depth and in a micro-batch's rows (1 / the micro-batch count) -- exact
while one phase of the step holds the peak in every traced variant (the
activations at these shapes); where another phase (AdamW's slices) holds
it in some, the extension misses (by 12% on a 16-token smoke step).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun.json

What is counted is the path the card runs: the prefill and SSD kernels
count as the kernels (``costanalysis.as_kernel``: the visible score
pairs only, no score matrix in memory), not as the plain versions that
compute them here; every other op is an eager op on the card too, counted
unfused, as the card runs it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch.configs as configs
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.core import costanalysis, rmetric
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import (PRODUCTION, axis_sizes, init_fake, make_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

#: grad-accumulation (microbatch stream count) per arch for train_4k --
#: larger models need more microbatches to fit activations in HBM.  Max is
#: 16 (global batch 256 / data axis 16 must leave >= 1 row per device).
TRAIN_ACCUM: dict[str, int] = {
    "jamba-1.5-large-398b": 16,
    "internlm2-20b": 16,
    "gemma2-27b": 16,
    "mixtral-8x7b": 16,
    "qwen2-moe-a2.7b": 8,
    "qwen3-4b": 8,
    "phi4-mini-3.8b": 8,
    "mamba2-2.7b": 8,
    "paligemma-3b": 8,
    "whisper-medium": 4,
}

#: bf16 Adam moments where f32 state cannot fit (the reference's choice).
MOMENT_DTYPE: dict[str, Any] = {
    "jamba-1.5-large-398b": torch.bfloat16,
}

#: gather-once (ZeRO-2) weights: all archs but jamba, whose full weights a
#: device cannot hold beside the activations (the reference's choice).
WEIGHT_GATHER_ONCE = frozenset(configs.list_archs()) - {"jamba-1.5-large-398b"}

def _fake_world(n: int) -> None:
    """A fake process group of at least ``n`` ranks (this process is rank
    0): one of 512 (the multi-pod world) holds every mesh of a sweep."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() >= n:
            return
        raise RuntimeError(f"the dry run needs a fake world of {n} ranks; this process "
                           f"has a {dist.get_backend()} group of {dist.get_world_size()}")
    init_fake(max(n, 512))


def _nbytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    return sum(costanalysis._nbytes(t) for t in costanalysis._tensors(tree))


def _fake_tree(shapes: dict, dtype_of) -> dict:
    """Empty tensors of ``shapes`` (under the caller's FakeTensorMode)."""
    return {k: _fake_tree(v, dtype_of) if isinstance(v, dict)
            else torch.empty(v, dtype=dtype_of(k)) for k, v in shapes.items()}


def _as_fake(tree: dict) -> dict:
    return {k: _as_fake(v) if isinstance(v, dict) else torch.empty(v.shape, dtype=v.dtype)
            for k, v in tree.items()}


def with_repeats(cfg, repeats: int):
    """``cfg`` cut to ``repeats`` repeats of its layer unit (whisper's
    encoder cut in proportion)."""
    over = {"n_layers": repeats * len(cfg.layer_unit)}
    if cfg.is_encoder_decoder:
        if cfg.n_encoder_layers % cfg.n_repeats:
            raise ValueError(f"{cfg.name}: encoder depth does not follow the decoder's")
        over["n_encoder_layers"] = repeats * (cfg.n_encoder_layers // cfg.n_repeats)
    return dataclasses.replace(cfg, **over)


def train_accum(arch: str, shape: ShapeSpec, sizes: dict[str, int]) -> int:
    """The cell's micro-batch count: ``TRAIN_ACCUM``, bounded so that each
    micro-batch still gives every batch shard a row."""
    batch_ways = sizes.get("pod", 1) * sizes.get("data", 1)
    return max(1, min(TRAIN_ACCUM.get(arch, 1), shape.global_batch // batch_ways))


def lower_cell(arch: str, shape: str | ShapeSpec, *, multi_pod: bool, cfg=None,
               mesh_shape: tuple[tuple[int, ...], tuple[str, ...]] | None = None,
               accum: int | None = None):
    """Build one cell's step and its (fake) inputs on the mesh.  Returns
    (run: a callable that runs the step, meta).  ``cfg`` / ``mesh_shape``
    override the arch's full config and the production mesh; ``accum``
    the micro-batch count."""
    cfg = cfg if cfg is not None else configs.get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    dims, axes = mesh_shape if mesh_shape is not None else PRODUCTION[multi_pod]
    n_chips = 1
    for d in dims:
        n_chips *= d
    _fake_world(n_chips)
    mesh = (make_mesh(dims, axes) if mesh_shape is not None
            else make_production_mesh(multi_pod=multi_pod))
    sizes = axis_sizes(mesh)
    t0 = time.time()
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    with mode:
        params = _fake_tree(T.param_shapes(cfg), lambda k: T.leaf_dtype(cfg, k))
        pspecs = sharding.param_specs(params, mesh)
        params_in = sharding.shaped(params, pspecs, mesh)
        del params
        if shape.kind == "train":
            accum = accum if accum is not None else train_accum(arch, shape, sizes)
            opt_cfg = adamw.AdamWConfig(moment_dtype=MOMENT_DTYPE.get(arch, torch.float32))
            opt_in = adamw.init_state(params_in, opt_cfg.moment_dtype)
            batch = _as_fake(steps.batch_shapes(cfg, global_batch=shape.global_batch,
                                                seq_len=shape.seq_len))
            batch_in = sharding.distribute_batch(batch, mesh, accum=accum)
            regather = None
            if arch in WEIGHT_GATHER_ONCE and accum > 1:
                regather = (sharding.drop_axis(pspecs), pspecs)
            fn = steps.make_train_step(cfg, opt_cfg, accum=accum, regather_specs=regather)
            args = (params_in, opt_in, batch_in)
            out_bytes = _nbytes((params_in, opt_in))  # updated in place and returned
            model_flops = rmetric.model_flops(T.active_param_count(cfg),
                                              shape.global_batch * shape.seq_len, backward=True)
        elif shape.kind == "prefill":
            batch = _as_fake(steps.batch_shapes(cfg, global_batch=shape.global_batch,
                                                seq_len=shape.seq_len))
            batch_in = sharding.distribute_batch(batch, mesh)
            fn = steps.make_prefill_step(cfg, max_seq=shape.seq_len)
            args = (params_in, batch_in)
            local_b = batch_in["tokens"].to_local().shape[0]
            out_bytes = _nbytes(steps.local_cache(cfg, sizes.get("model", 1), local_b,
                                                  shape.seq_len, device="cpu"))
            out_bytes += local_b * cfg.padded_vocab * 4  # the last position's f32 logits
            model_flops = rmetric.model_flops(T.active_param_count(cfg),
                                              shape.global_batch * shape.seq_len, backward=False)
        else:  # decode: this rank's rows (and heads) of the caches
            tok = sharding.distribute_batch(
                {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32)}, mesh)
            local_b = tok["tokens"].to_local().shape[0]
            fn = steps.make_decode_step(cfg)
            caches = steps.local_cache(cfg, sizes.get("model", 1), local_b, shape.seq_len,
                                       device="cpu")
            cur = torch.empty((local_b,), dtype=torch.int32)
            args = (params_in, caches, tok["tokens"], cur)
            out_bytes = _nbytes(caches) + local_b * cfg.padded_vocab * 4
            model_flops = rmetric.model_flops(T.active_param_count(cfg), shape.global_batch,
                                              backward=False)
    meta = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(map(str, dims)),
        "n_chips": n_chips,
        "repeats": cfg.n_repeats,
        "accum": accum if shape.kind == "train" else None,
        "model_flops": model_flops,
        "lower_s": round(time.time() - t0, 2),
        "mem_argument_bytes": _nbytes(args),
        "mem_output_bytes": out_bytes,
        "batch_ways": sizes.get("pod", 1) * sizes.get("data", 1),
    }

    def run():
        with mode:
            return fn(*args)

    return run, meta


def analyse(run, meta: dict[str, Any]) -> dict[str, Any]:
    """Run the step under the cost counter: memory, cost and collective
    numbers, every field of the reference's ``analyse`` (a null one with
    its reason in ``null_reasons``)."""
    t0 = time.time()
    with costanalysis.CostCounter() as counter:
        out = run()
    trace_s = time.time() - t0
    cost = counter.totals
    res = dict(meta)
    res.update({
        "compile_s": None,
        "trace_s": round(trace_s, 2),
        "ops": counter.ops,
        "hlo_flops": cost.flops,
        "hlo_bytes": cost.bytes,
        "collective_bytes": cost.collective_bytes,
        "collective_breakdown": {k: v for k, v in cost.collective_by_op.items() if v},
        "mem_temp_bytes": counter.peak_live_bytes,
        "mem_generated_code_bytes": None,
        "null_reasons": {
            "compile_s": "the port compiles nothing: the step runs eagerly (trace_s)",
            "mem_generated_code_bytes": "no compiled program: the kernels are built "
                                        "once per process, not per step",
        },
    })
    del out
    _roofline(res)
    return res


_EXTENDED = ("hlo_flops", "hlo_bytes", "collective_bytes", "ops")


def _extend(f11, f21, f12, f22, a0, a1, repeats, accum):
    """f(repeats, accum) of f = A + D r + B a + C a r, from its values at
    r in (1, 2) and a in (a0, a1) (or at r in (1, 2) alone: f12 = None)."""
    if f12 is None:
        return f11 + (repeats - 1) * (f21 - f11)
    s0, s1 = f21 - f11, f22 - f12
    return (f11 + (repeats - 1) * s0
            + (accum - a0) / (a1 - a0) * ((f12 - f11) + (repeats - 1) * (s1 - s0)))


def extended(arch: str, shape: str | ShapeSpec, *, multi_pod: bool, cfg=None,
             mesh_shape=None) -> dict[str, Any]:
    """The cell's :func:`analyse` fields, traced at 1 and 2 repeats (and 2
    and 3 micro-batches) and extended linearly to the full depth and
    micro-batch count; the arguments and outputs counted at full size."""
    cfg = cfg if cfg is not None else configs.get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    _, full = lower_cell(arch, shape, multi_pod=multi_pod, cfg=cfg, mesh_shape=mesh_shape)
    train = shape.kind == "train"
    accums: tuple = (full["accum"],)
    if train and full["accum"] > 1:
        fit = [a for a in (2, 3, 4) if shape.global_batch % (a * full["batch_ways"]) == 0]
        accums = tuple(fit[:2]) if len(fit) >= 2 else accums
    runs = {}
    for a in accums:
        for r in (1, 2):
            run, meta = lower_cell(arch, shape, multi_pod=multi_pod, mesh_shape=mesh_shape,
                                   cfg=with_repeats(cfg, r), accum=a)
            runs[r, a] = analyse(run, meta)
    a0, a1 = accums[0], accums[-1]
    two = len(accums) == 2

    def ext(get):
        return _extend(get(runs[1, a0]), get(runs[2, a0]),
                       get(runs[1, a1]) if two else None, get(runs[2, a1]) if two else None,
                       a0, a1, cfg.n_repeats, full["accum"] or 1)

    res = dict(runs[1, a1])
    res.update(full)
    for k in _EXTENDED:
        res[k] = ext(lambda r, k=k: r[k])
    res["collective_breakdown"] = {
        op: ext(lambda r, op=op: r["collective_breakdown"].get(op, 0.0))
        for op in costanalysis.COLLECTIVES}
    res["collective_breakdown"] = {k: v for k, v in res["collective_breakdown"].items() if v}
    # the peak holds a micro-batch's activations: linear in its rows, 1 / accum
    t = {k: r["mem_temp_bytes"] for k, r in runs.items()}
    res["mem_temp_bytes"] = (
        _extend(t[1, a0], t[2, a0], t[1, a1], t[2, a1], 1 / a0, 1 / a1, cfg.n_repeats,
                1 / full["accum"]) if two
        else _extend(t[1, a0], t[2, a0], None, None, 0, 0, cfg.n_repeats, 0))
    res["trace_s"] = round(sum(r["trace_s"] for r in runs.values()), 2)
    res["traced"] = {"repeats": [1, 2], "accum": list(accums)}
    _roofline(res)
    return res


def _roofline(res: dict) -> None:
    terms = rmetric.roofline_from_cost(hlo_flops=res["hlo_flops"], hlo_bytes=res["hlo_bytes"],
                                       collective_bytes=res["collective_bytes"],
                                       n_chips=res["n_chips"])
    res.update({
        "t_compute_s": terms.compute,
        "t_memory_s": terms.memory,
        "t_collective_s": terms.collective,
        "bottleneck": terms.bottleneck,
        "t_serial_s": terms.total_serial,
        "t_overlapped_s": terms.total_overlapped,
        "roofline_fraction": terms.roofline_fraction(),
        "useful_flops_ratio": (res["model_flops"] / (res["hlo_flops"] * res["n_chips"])
                               if res["hlo_flops"] else None),
        "paper_R": terms.as_stage_times().ratio(),
    })


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, verbose: bool = False,
             exact: bool = False, **over) -> dict[str, Any]:
    if exact:
        run, meta = lower_cell(arch, shape_name, multi_pod=multi_pod, **over)
        result = analyse(run, meta)
    else:
        result = extended(arch, shape_name, multi_pod=multi_pod, **over)
    if verbose:
        print(f"[dryrun] memory: arguments {result['mem_argument_bytes']:.4g} B, outputs "
              f"{result['mem_output_bytes']:.4g} B, temporaries {result['mem_temp_bytes']:.4g} B")
        xla_flops, xla_bytes = costanalysis.cost_analysis_scalars(
            costanalysis.CostTotals(result["hlo_flops"], result["hlo_bytes"]))
        print(f"[dryrun] cost: flops={xla_flops:.3e} bytes={xla_bytes:.3e} collective "
              f"{result['collective_breakdown']}")
    print(f"[dryrun] {arch} x {result['shape']} x {result['mesh']}: trace={result['trace_s']:.1f}s "
          f"bottleneck={result['bottleneck']} frac={result['roofline_fraction']:.3f}")
    return result


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="a JSON file (e.g. build/dryrun.json)")
    args = ap.parse_args(argv)

    if args.all:
        cell_list = configs.cells()
        verbose = False
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cell_list = [(args.arch, args.shape)]
        verbose = True

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    results: list[dict[str, Any]] = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if "error" not in r}

    try:
        for arch, shape_name in cell_list:
            for multi_pod in meshes:
                mesh_name = "x".join(map(str, PRODUCTION[multi_pod][0]))
                if (arch, shape_name, mesh_name) in done:
                    continue
                try:
                    results.append(run_cell(arch, shape_name, multi_pod=multi_pod,
                                            verbose=verbose))
                except Exception as e:  # record the failure, keep sweeping
                    traceback.print_exc()
                    results.append({"arch": arch, "shape": shape_name, "mesh": mesh_name,
                                    "error": f"{type(e).__name__}: {e}"})
                if args.out:
                    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    n_err = sum("error" in r for r in results)
    print(f"[dryrun] {len(results) - n_err} ok, {n_err} failed")
    if n_err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
