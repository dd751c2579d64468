"""Elastic scaling, ported from `repro/train/elastic.py`: recompute the best
mesh from the surviving ranks.

When hosts are evicted (failure, straggler), the job restarts on the
survivors.  `best_mesh_shape` picks the largest usable (pod, data, model)
factorization that (a) keeps the model axis where it can, since parameter
shards must still fit, and (b) keeps the global batch divisible so the
optimizer's semantics do not change (the per-replica batch is rescaled
instead).  It is JAX's, line for line.  `make_mesh_from_plan` builds the
plan's `DeviceMesh` over the first prod(shape) ranks; a rank the plan
drops gets None and leaves before any collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch import mesh as M


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    per_replica_batch: int
    dropped_devices: int


def _divisors_desc(n: int):
    return [d for d in range(n, 0, -1) if n % d == 0]


def best_mesh_shape(n_devices: int, *, want_model: int, global_batch: int,
                    pods: int = 1, min_util: float = 0.9) -> MeshPlan:
    """Largest feasible (pod, data, model) using <= n_devices.

    The first pass keeps the global batch exactly divisible (the same
    optimizer semantics).  If that wastes more than (1 - min_util) of the
    fleet, a second pass takes the largest mesh and rescales the
    per-replica batch to the nearest value (the global batch changes by
    less than one replica batch; the caller logs it)."""
    def plan(data, model):
        used = pods * data * model
        shape = (pods, data, model) if pods > 1 else (data, model)
        axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
        prb = max(1, round(global_batch / (pods * data)))
        return MeshPlan(shape=shape, axes=axes, per_replica_batch=prb,
                        dropped_devices=n_devices - used)

    best_exact = None
    for model in [want_model] + _divisors_desc(want_model)[1:]:
        data = (n_devices // pods) // model
        while data > 0:
            if global_batch % (pods * data) == 0:
                p = plan(data, model)
                if (best_exact is None
                        or p.dropped_devices < best_exact.dropped_devices):
                    best_exact = p
                break
            data -= 1
    if best_exact is not None and \
            best_exact.dropped_devices <= (1 - min_util) * n_devices:
        return best_exact
    # utilization-first fallback: largest mesh, batch rescaled
    for model in [want_model] + _divisors_desc(want_model)[1:]:
        data = (n_devices // pods) // model
        if data > 0:
            return plan(data, model)
    if best_exact is not None:
        return best_exact
    raise ValueError(f"no feasible mesh for {n_devices} devices, "
                     f"batch {global_batch}")


def make_mesh_from_plan(plan: MeshPlan,
                        device: Optional[str | torch.device] = None
                        ) -> Optional[DeviceMesh]:
    """The plan's mesh over the job's first prod(plan.shape) ranks (every
    rank calls this); None on a rank the plan drops."""
    device = M.local_device(device)
    M.init_group(device)
    n = math.prod(plan.shape)
    if n > M.world_size():
        raise ValueError(f"plan {plan.shape} needs {n} ranks, the job has "
                         f"{M.world_size()}")
    mesh = M.first_ranks_mesh(device.type, plan.shape, plan.axes)
    return mesh if mesh.get_coordinate() is not None else None
