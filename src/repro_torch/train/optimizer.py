"""Functional optimizers, ported from `repro/train/optimizer.py`.

AdamW (the paper trains the char-LM with Adam) and SGD with momentum, global
gradient-norm clipping, warmup/cosine `schedule`, and the host-side
/4-on-plateau `PlateauLR` the paper uses for word-PTB.  These are plain
functions over trees of tensors, not `torch.optim`, so that an update
matches the JAX one term for term: every scalar of the update (learning
rate, bias corrections) is a float32 tensor, as JAX computes it, every
division divides by a tensor (PyTorch turns a CUDA tensor divided by a
Python number into a multiply by the reciprocal), and the update runs on
the device without a host round trip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.qtensor import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | sgd
    lr: float = 2e-3             # paper: 0.002 for char-LM
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.0        # SGD momentum buffer coefficient (0 = plain)
    clip_norm: float = 0.0       # 0 = off; paper word-PTB: 0.25
    warmup_steps: int = 0
    decay_steps: int = 0         # cosine horizon; 0 = constant
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # () int32: updates applied so far
    m: Any
    v: Any              # None for SGD


def opt_init(params: Any, cfg: OptConfig) -> OptState:
    zeros = lambda: tree_map(torch.zeros_like, params)
    leaf = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    return OptState(step=step, m=zeros(),
                    v=zeros() if cfg.kind == "adamw" else None)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at `step` (a () int tensor), in float32."""
    lr = _f32(cfg.lr, step.device)
    s = step.to(torch.float32)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp((s + 1.0) / _f32(cfg.warmup_steps, s.device),
                              max=1.0)
    if cfg.decay_steps > 0:
        span = _f32(max(cfg.decay_steps - cfg.warmup_steps, 1), s.device)
        t = torch.clamp((s - cfg.warmup_steps) / span, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        lr = lr * (cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos)
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads: Any, max_norm: float):
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, gnorm.device) / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def opt_update(grads: Any, state: OptState, params: Any, cfg: OptConfig,
               lr_scale=1.0):
    """Returns (new_params, new_state, metrics)."""
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = schedule(state.step, cfg) * _f32(lr_scale, step.device)
    metrics = {"grad_norm": gnorm, "lr": lr}

    if cfg.kind == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g.square(),
                     state.v, grads)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, sf.device), sf)
        bc2 = 1 - torch.pow(_f32(b2, sf.device), sf)

        def upd(p, mm, vv):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
            if cfg.weight_decay > 0:
                u = u + cfg.weight_decay * p
            return p - lr * u

        return (tree_map(upd, params, m, v), OptState(step=step, m=m, v=v),
                metrics)

    # SGD with its momentum buffer in m (momentum 0 is plain SGD)
    mom = cfg.momentum
    m = tree_map(lambda mm, g: mom * mm + g, state.m, grads)
    return (tree_map(lambda p, mm: p - lr * mm, params, m),
            OptState(step=step, m=m, v=None), metrics)


class PlateauLR:
    """Host-side plateau schedule (paper word-PTB: divide the LR by 4
    whenever the validation metric rises against the previous evaluation,
    not the all-time best, so a noisy recovery does not keep cutting).
    Produces the `lr_scale` fed to `opt_update`; `best` is kept for
    reporting only."""

    def __init__(self, factor: float = 0.25):
        self.factor = factor
        self.prev: Optional[float] = None
        self.best: Optional[float] = None
        self.scale = 1.0

    def update(self, val_metric: float) -> float:
        if self.prev is not None and val_metric > self.prev:
            self.scale *= self.factor
        self.prev = val_metric
        if self.best is None or val_metric < self.best:
            self.best = val_metric
        return self.scale

    def replay(self, val_metrics) -> float:
        """Rebuild the state from a recorded metric history (the restart
        path replays the journaled evals)."""
        for v in val_metrics:
            self.update(float(v))
        return self.scale
