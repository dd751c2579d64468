"""Atomic, optionally asynchronous checkpoints in the JAX package's layout
(`repro/train/checkpoint.py`), so each package reads what the other wrote:

    <dir>/step_<n:08d>/manifest.json          step, leaf shapes and dtypes
    <dir>/step_<n:08d>/shard_00000/<key>.npy  one file per leaf

A key is the leaf's dotted path in the JAX package's flatten order:
`params.layers.0.wx`, `opt.step`, `opt.m.layers.0.wx`,
`bn_state.layers.0.bn_x.mean`, ...  The port's `TrainState` has the JAX
state's leaves except its `rng` key, in whose place it keeps
`noise_seed`.  Restoring a JAX checkpoint therefore ignores `rng` and keeps
the template's `noise_seed`; every other template leaf must be in the
checkpoint.

Atomicity: everything is written into `step_<n>.tmp-<nonce>` and renamed
into place last, so a preemption mid-write never corrupts the latest
checkpoint; `latest_step` only believes directories holding a manifest, and
each save removes orphaned partial writes and all but the newest `keep`.

`AsyncCheckpointer.save_async` copies the tree to host memory at once and
writes the files on a worker thread; `wait()` joins it and re-raises its
error.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.qtensor import tree_map, tree_map_with_path, tree_paths

SEP = "."
SHARD = "shard_00000"  # the JAX layout's shard of process 0: the port runs one
OWN_LEAVES = ("noise_seed",)  # the port's own: a JAX checkpoint lacks them


def _flatten(tree: Any) -> dict:
    """{dotted path: leaf} in the JAX package's flatten order."""
    return {SEP.join(path): leaf for path, leaf in tree_paths(tree)}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def save(tree: Any, directory: str | Path, step: int, *,
         keep: int = 3) -> Path:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
    shard_dir = tmp / SHARD
    shard_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    manifest = {"step": step, "leaves": {}, "treedef_keys": sorted(flat),
                "qtensors": {}}
    for key, leaf in flat.items():
        arr = _host(leaf)
        np.save(shard_dir / f"{key}.npy", arr)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: Path, keep: int) -> None:
    done = sorted(p for p in directory.glob("step_*")
                  if (p / "manifest.json").exists())
    for p in done[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
    for p in directory.glob("step_*.tmp-*"):  # orphaned partial writes
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore(template: Any, directory: str | Path,
            step: Optional[int] = None) -> Any:
    """Restore into the structure of `template`: each leaf takes the
    checkpoint's array (shapes must match) as a tensor on the template
    leaf's device."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    ckpt = directory / f"step_{step:08d}"
    saved = json.loads((ckpt / "manifest.json").read_text())["leaves"]
    shard_dir = ckpt / SHARD

    def load(path, leaf):
        key = SEP.join(path)
        if key not in saved:
            if key in OWN_LEAVES:
                return leaf
            raise KeyError(f"{key}: not in checkpoint {ckpt}")
        arr = np.load(shard_dir / f"{key}.npy")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"template {tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(leaf.device)

    return tree_map_with_path(load, template)


class AsyncCheckpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, tree: Any, step: int) -> None:
        self.wait()
        host_tree = tree_map(_host, tree)

        def work():
            try:
                save(host_tree, self.directory, step, keep=self.keep)
            except BaseException as e:  # re-raised on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
