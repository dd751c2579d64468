"""Carry weights and training states across from the JAX package.

`from_numpy(tree)` turns the JAX serving variables, given as numpy arrays,
into the port's: nested dicts and lists keep their shape, a packed leaf
arrives as `{"codes": uint32 ndarray, "k", "mode", "alpha", "scale"}` and
becomes a `QTensor` whose int32 codes hold the same words, and a
NamedTuple with the fields of `BNParams` or `BNState` (or a dict with those
keys) becomes the port's.  Fed the same weights, both packages compute the
same function.

A JAX `TrainState` (params, opt, rng, bn_state, residual) becomes the
port's `TrainState`: params, `opt.step`/`m`/`v` and `bn_state` carry
across.  The JAX PRNG key cannot: `jax.random` and torch generators draw
different numbers, so the port's `noise_seed` is the caller's
(`noise_seed=`), and the two runs sample different weights from there on.
Gradient compression is not ported, so a state with a `residual` is
refused.

`to_numpy` goes the other way; a port `TrainState` becomes a dict of the
JAX state's fields without `rng` (`opt` an `OptState` of numpy), which
the caller completes with a key of its own.  A port checkpoint needs no
conversion: it has the JAX layout, and JAX's `checkpoint.restore` reads it
into a template whose `rng` is None.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor, tree_to
from repro_torch.core.recurrent_bn import BNParams, BNState
from repro_torch.kernels import dispatch
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState

_QT_KEYS = {"codes", "k", "mode", "alpha", "scale"}
_JAX_TRAIN_STATE = frozenset(("params", "opt", "rng", "bn_state", "residual"))
_NAMED = {frozenset(BNParams._fields): BNParams,
          frozenset(BNState._fields): BNState}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def from_numpy(tree: Any, device: Optional[str | torch.device] = None, *,
               noise_seed: int = 0) -> Any:
    """JAX variables or a JAX `TrainState`, as numpy -> the port's, on
    `device` (the card unless the caller asks for the CPU).  `noise_seed`
    seeds a converted train state's noise."""
    def conv(x):
        fields = getattr(x, "_fields", None)
        if fields is not None and frozenset(fields) == _JAX_TRAIN_STATE:
            if x.residual is not None:
                raise ValueError("gradient compression is not ported: the "
                                 "state carries a `residual`")
            opt = OptState(step=_tensor(np.asarray(x.opt.step, np.int32)),
                           m=conv(x.opt.m),
                           v=None if x.opt.v is None else conv(x.opt.v))
            return TrainState(params=conv(x.params), opt=opt,
                              noise_seed=torch.tensor(noise_seed,
                                                      dtype=torch.int64),
                              bn_state=conv(x.bn_state))
        if fields is not None and frozenset(fields) in _NAMED:
            cls = _NAMED[frozenset(fields)]
            return cls(*(conv(getattr(x, f)) for f in cls._fields))
        if isinstance(x, dict):
            if set(x) == _QT_KEYS:
                codes = np.asarray(x["codes"])
                if codes.dtype != np.uint32:
                    raise TypeError(f"packed codes must be uint32, got {codes.dtype}")
                scale = None if x["scale"] is None else _tensor(x["scale"])
                return QTensor(codes=_tensor(codes), scale=scale,
                               k=int(x["k"]), mode=str(x["mode"]),
                               alpha=float(x["alpha"]))
            if frozenset(x) in _NAMED:
                cls = _NAMED[frozenset(x)]
                return cls(*(conv(x[f]) for f in cls._fields))
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _tensor(x)

    return tree_to(conv(tree), dispatch.resolve_device(device))


def to_numpy(tree: Any) -> Any:
    """The port's tree -> numpy, with packed leaves as dicts of uint32
    codes (the inverse of `from_numpy`)."""
    if tree is None:
        return None
    if isinstance(tree, TrainState):  # the JAX state's fields but `rng`
        return {"params": to_numpy(tree.params), "opt": to_numpy(tree.opt),
                "bn_state": to_numpy(tree.bn_state), "residual": None}
    if isinstance(tree, QTensor):
        return {"codes": tree.codes.cpu().numpy().view(np.uint32),
                "k": tree.k, "mode": tree.mode, "alpha": tree.alpha,
                "scale": None if tree.scale is None
                else tree.scale.cpu().numpy()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
