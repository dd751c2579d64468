"""Device feeding, ported from `repro/data/loader.py` without the mesh.

`Prefetcher` assembles the batches of steps k+1 .. k+depth on a worker
thread and puts them on the training device while step k runs.  The data
pipeline is step-indexed (a batch is a pure function of its step), so
dropping the queue on a restart loses nothing.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on `device`, token ids as int64."""
    return {k: torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    """Pulls batches from `make_batch(step)` on a worker thread, `depth`
    steps ahead, placing them on `device`.  Iterating yields (step, batch);
    an error in the worker is raised on the consumer's side."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int,
                 device: torch.device, depth: int = 2):
        self.make_batch = make_batch
        self.device = device
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                b = to_device(self.make_batch(step), self.device)
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
