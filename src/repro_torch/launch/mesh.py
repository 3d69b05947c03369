"""Device meshes over ``torch.distributed`` (reference ``launch/mesh.py``).

Single pod: (data=16, model=16) over 256 ranks.  Multi-pod: (pod=2,
data=16, model=16) over 512 ranks; the ``pod`` axis is the slow
inter-node dimension -- the batch (and the gradient all-reduce) shards over
it, while parameters stay within a pod (FSDP over ``data``, tensor
parallelism over ``model``).

torch has one process per rank (the reference has one controller over
all devices), so a mesh needs a process group first: :func:`init_distributed`
makes it from the environment ``torch.distributed.run`` sets -- NCCL for
the card (after binding the rank to its card), gloo for the CPU -- or, for
the dry run, a ``"fake"`` group of any size in one process, whose
collectives move nothing (``torch.testing``'s ``FakeStore``).  Nothing
falls back from one backend to another.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device=None) -> torch.device:
    """The default process group for this process, on ``device`` (the card
    unless ``"cpu"``): NCCL on the card, gloo on the CPU.  Rank, world
    size and rendezvous come from ``torch.distributed.run``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); without it, a world of 1 on a free localhost port.
    On the card the rank is bound to card ``LOCAL_RANK`` before the first
    collective.  Returns the rank's device; a no-op when a group exists."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, device_id=dev if dev.type == "cuda" else None)
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                                rank=0, world_size=1,
                                device_id=dev if dev.type == "cuda" else None)
    return dev


def init_fake(world_size: int, rank: int = 0) -> None:
    """A ``"fake"`` process group of ``world_size`` ranks in this process
    (the dry run: its collectives return without moving data)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: needs a world of at least 256 or 512 ranks."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes)


def make_host_mesh(*, data: int | None = None, model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the current world (``data``
    defaults to world // model)."""
    n = dist.get_world_size()
    data = data if data is not None else max(1, n // model)
    if data * model != n:
        raise ValueError(f"mesh {data} x {model} != world size {n}")
    return make_mesh((data, model), ("data", "model"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of any shape over ranks 0 .. prod(shape) - 1 of the current
    world (every rank of the world calls it; tests: 2 x 2 x 2).  One fake
    world can then hold every mesh of a dry run: DTensor caches placements
    by mesh, so a world torn down and made again would leave it meshes
    whose groups are gone."""
    n = 1
    for d in shape:
        n *= d
    if n > dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    ranks = torch.arange(n, dtype=torch.int).reshape(tuple(shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
