"""Device feeding, ported from `repro/data/loader.py`.

`Prefetcher` assembles the batches of steps k+1 .. k+depth on a worker
thread and puts them on the training device while step k runs.  The data
pipeline is step-indexed (a batch is a pure function of its step), so
dropping the queue on a restart loses nothing.  Given a mesh, each rank
takes its contiguous block [r*B/D, (r+1)*B/D) of the global batch, what
`NamedSharding(P('data'))` puts on device r in JAX (`data_block`).
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.launch import mesh as M
from repro_torch.runtime import axis_sizes


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on `device`, token ids as int64."""
    return {k: torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
            for k, v in batch.items()}


def batch_sharding(mesh) -> Optional[tuple]:
    """The layout of a batch's leading axis on `mesh` (JAX's
    `NamedSharding` spec of it): None without a mesh, else the
    (pod, data) axes a batch leaf shards over
    (`sharding.batch_shardings`' rule)."""
    if mesh is None:
        return None
    from repro_torch.launch import sharding as S
    n = math.prod(axis_sizes(mesh).get(a, 1) for a in S.DATA_AXES)
    return S.batch_shardings(torch.empty(n, device="meta"), mesh)


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's block of a batch as DTensors sharded over the data axes
    (`train_step.shard_batch`); the batch as it is without a mesh."""
    if mesh is None:
        return batch
    from repro_torch.train.train_step import shard_batch as shard
    return shard(batch, mesh)


def data_block(batch: dict, mesh) -> dict:
    """Data replica r's rows [r*B/D, (r+1)*B/D) of every array of a global
    batch of B rows over D replicas."""
    r, d = M.data_index(mesh)
    out = {}
    for k, v in batch.items():
        if len(v) % d:
            raise ValueError(f"global batch {len(v)} ({k}) does not divide "
                             f"over {d} data replicas")
        n = len(v) // d
        out[k] = v[r * n:(r + 1) * n]
    return out


class Prefetcher:
    """Pulls batches from `make_batch(step)` on a worker thread, `depth`
    steps ahead, placing them (this rank's block of them, given a `mesh`)
    on `device`.  Iterating yields (step, batch); an error in the worker is
    raised on the consumer's side."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int,
                 device: torch.device, depth: int = 2, mesh=None):
        self.make_batch = make_batch
        self.device = device
        self.mesh = mesh
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                b = self.make_batch(step)
                if self.mesh is not None:
                    b = data_block(b, self.mesh)
                b = to_device(b, self.device)
            except Exception as e:  # surfaced on the consumer side
                self.q.put(e)
                return
            self.q.put((step, b))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the worker: drain the queue so a blocked put returns, then
        join it."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
