"""Batch normalization for recurrent networks (paper Eq. 3), ported from
`repro/core/recurrent_bn.py`.

  BN(x; phi, gamma) = gamma + phi * (x - E[x]) / sqrt(V[x] + eps)

Training normalizes with the current minibatch's statistics and folds them
into running averages; inference uses the running averages.  The variance
is the population variance (`correction=0`), as `jnp.var` computes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BNParams(NamedTuple):
    phi: torch.Tensor    # multiplicative (paper's phi)
    gamma: torch.Tensor  # additive (paper's gamma; fixed 0 for gate preacts)


class BNState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # number of updates folded into the running stats


def bn_init(features: int, *, phi_init: float = 0.1, gamma_init: float = 0.0,
            dtype=torch.float32, device=None) -> tuple[BNParams, BNState]:
    full = lambda v: torch.full((features,), v, dtype=dtype, device=device)
    p = BNParams(phi=full(phi_init), gamma=full(gamma_init))
    s = BNState(mean=full(0.0), var=full(1.0),
                count=torch.zeros((), dtype=dtype, device=device))
    return p, s


def bn_apply(x: torch.Tensor, p: BNParams, s: BNState, *, training: bool,
             trainable_gamma: bool = True, eps: float = 1e-5,
             momentum: float = 0.99) -> tuple[torch.Tensor, BNState]:
    """x: (batch, features).  Returns normalized x and the updated stats."""
    if training:
        mean = x.mean(dim=0)
        var = x.var(dim=0, correction=0)
        new_s = BNState(
            mean=momentum * s.mean + (1.0 - momentum) * mean.detach(),
            var=momentum * s.var + (1.0 - momentum) * var.detach(),
            count=s.count + 1.0,
        )
    else:
        mean, var = s.mean, s.var
        new_s = s
    gamma = p.gamma if trainable_gamma else p.gamma.detach()
    y = gamma + p.phi * (x - mean) * torch.rsqrt(var + eps)
    return y, new_s
