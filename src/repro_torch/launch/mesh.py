"""Process groups and device meshes, ported from `repro/launch/mesh.py`.

JAX runs one controller over many devices; the port runs one process a
device.  `torchrun` sets each process's RANK, WORLD_SIZE and LOCAL_RANK
(the device is `cuda:LOCAL_RANK`), and `init_group` joins them in one
process group: NCCL on the card, gloo on the CPU.  Where no torchrun
environment is set, it makes a group of one rank on a free local port, the
counterpart of JAX's one-device mesh, so the collective path runs at world
size 1 too.  A mesh is a `DeviceMesh` whose `mesh_dim_names` are JAX's
axis names: ("data",), ("data", "model") or ("pod", "data", "model").

The data axes ("pod", "data") carry data parallelism: `data_index` gives a
rank's block of the global batch (what `NamedSharding(P('data'))` puts on
device r) and `data_mean` is JAX's `pmean` over them; `barrier` holds
every rank of a mesh until all have reached it.

    # two ranks on the CPU
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --reduced \\
        --device cpu --compress-grads --steps 4
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import quantize as Q
from repro_torch.kernels import dispatch

DATA_AXES = ("pod", "data")


def torchrun_env() -> bool:
    """True in a process that `torchrun` started."""
    return "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


def world_size() -> int:
    """The ranks of the job: the process group's, else torchrun's, else
    1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if torchrun_env() else 1


def rank() -> int:
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ["RANK"]) if torchrun_env() else 0


def local_device(device: Optional[str | torch.device] = None
                 ) -> torch.device:
    """The device this process trains on: `dispatch.resolve_device`'s,
    and under torchrun on the card `cuda:LOCAL_RANK`."""
    device = dispatch.resolve_device(device)
    if device.type == "cuda" and device.index is None and torchrun_env():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def init_group(device: torch.device) -> bool:
    """Join torchrun's process group, or make a group of one rank on a free
    local port; NCCL for a card, gloo for the CPU.  Returns True when this
    call made the group (its caller then destroys it); False when one
    exists."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    if torchrun_env():
        dist.init_process_group(backend, **kw)
    else:
        # port 0: the OS picks a free port as the store binds it
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                              wait_for_workers=False)
        dist.init_process_group(backend, store=store, world_size=1, rank=0,
                                **kw)
    return True


def first_ranks_mesh(device_type: str, shape: tuple,
                     axes: tuple) -> DeviceMesh:
    """A mesh over the first prod(shape) ranks (every rank must call)."""
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str | torch.device] = None
                         ) -> DeviceMesh:
    """Single pod (16, 16) = 256 ranks, axes (data, model); multi-pod (2,
    16, 16) = 512, axes (pod, data, model), 'pod' an outer data axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    device = local_device(device)
    init_group(device)
    if world_size() < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {world_size()} — run "
            f"one process a device (torchrun) on the pod")
    return first_ranks_mesh(device.type, shape, axes)


def make_host_mesh(model: int = 1,
                   device: Optional[str | torch.device] = None) -> DeviceMesh:
    """Mesh over every rank of the job (tests, one card, the CPU).

    `model` must divide the rank count: it raises, naming the shape the
    old silent gcd fallback would have built, where JAX's does."""
    device = local_device(device)
    init_group(device)
    n = world_size()
    if model < 1:
        raise ValueError(f"model={model} must be >= 1")
    if n % model:
        g = math.gcd(model, n)
        raise ValueError(
            f"model={model} does not divide the {n} local devices; the old "
            f"silent fallback would have built a data={n // g},model={g} "
            f"mesh — pass model={g} explicitly if that is what you want")
    if model > 1:
        return first_ranks_mesh(device.type, (n // model, model),
                                ("data", "model"))
    return first_ranks_mesh(device.type, (n,), ("data",))


def parse_mesh_spec(spec: str) -> dict:
    """``"data=4,model=2"`` → ``{"data": 4, "model": 2}`` (absent axes = 1)."""
    sizes = {"data": 1, "model": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad mesh spec part {part!r} (want axis=N)")
        axis, _, num = part.partition("=")
        axis = axis.strip()
        if axis not in sizes:
            raise ValueError(
                f"unknown mesh axis {axis!r} (serving meshes have data, model)")
        sizes[axis] = int(num)
        if sizes[axis] < 1:
            raise ValueError(f"mesh axis {axis}={sizes[axis]} must be >= 1")
    return sizes


def make_serve_mesh(spec: str,
                    device: Optional[str | torch.device] = None) -> DeviceMesh:
    """Serving mesh for ``--mesh data=D,model=M`` over the first D*M ranks,
    both axes always present: the mesh `ServeEngine` shards its slot pool
    over 'data' and its weights over 'model'."""
    sizes = parse_mesh_spec(spec)
    d, m = sizes["data"], sizes["model"]
    device = local_device(device)
    init_group(device)
    if d * m > world_size():
        raise ValueError(
            f"mesh data={d},model={m} needs {d * m} devices, have "
            f"{world_size()} — on the CPU run under torchrun "
            f"--nproc-per-node {d * m}")
    return first_ranks_mesh(device.type, (d, m), ("data", "model"))


# ---------------------------------------------------------------------------
# the data axes
# ---------------------------------------------------------------------------


def data_dims(mesh: DeviceMesh) -> tuple:
    return tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)


def data_index(mesh: DeviceMesh) -> tuple[int, int]:
    """(this rank's data replica, the replica count): its coordinates on
    the data axes, pod outermost."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, count = 0, 1
    for a in data_dims(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(a))
        index, count = index * size + coord[a], count * size
    return index, count


def data_mean(mesh: DeviceMesh, tensors: list) -> list:
    """JAX's `pmean` over the data axes: the tensors as one fp32 buffer,
    summed by one all-reduce a data axis, divided by the replica count
    (a same-device tensor: `Q.divide`), and split back into views of
    their shapes and dtypes."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    for a in data_dims(mesh):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
    flat = Q.divide(flat, float(data_index(mesh)[1]))
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, tensors)]


def any_rank(flag: bool, mesh: DeviceMesh) -> bool:
    """True on every rank of the mesh when `flag` is True on any: a MAX
    all-reduce along each mesh axis in turn, which leaves every rank the
    maximum over all of them."""
    got = torch.tensor([float(flag)], device=mesh.device_type)
    for a in mesh.mesh_dim_names:
        dist.all_reduce(got, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return bool(got.item())


def barrier(mesh: DeviceMesh) -> None:
    """Hold every rank of the mesh until all have reached this call."""
    any_rank(False, mesh)
