"""The paper's BN-LSTM/GRU train step, ported from the RNN path of
`repro/train/train_step.py` (no mesh, no gradient compression):

    grads -> clip -> AdamW/SGD -> master-weight clip to [-alpha, alpha]

The final clip is the paper's algorithm (it keeps the Bernoulli
probabilities in [0, 1]).  BN running statistics thread through the state.

Randomness.  JAX's `TrainState.rng` key becomes `noise_seed`: the noise of
step s (the state's `opt.step`) is drawn from a generator on the training
device seeded from (noise_seed, s) alone, so a resumed run draws the same
noise as an uninterrupted one without saving generator state.  A caller may
inject the noise instead (`step(..., noise=...)`), which is how the tests
feed the port the very arrays the JAX step draws.

Gradients.  `torch.autograd.grad` returns None for a leaf the loss does not
reach (the gate BNs' additive terms, fixed at 0, and the unused cell-norm
BN of a GRU); `jax.grad` returns zeros there, and so does the step, so the
global norm and the Adam moments see the same tree.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import bnlstm as BL
from repro_torch.core.qtensor import tree_leaves, tree_map
from repro_torch.train.optimizer import OptConfig, OptState, opt_init, opt_update

_MASK64 = (1 << 64) - 1


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    noise_seed: torch.Tensor  # () int64; replaces JAX's `rng` key
    bn_state: Any = None


def train_state_init(params: Any, opt_cfg: OptConfig, noise_seed: int,
                     bn_state: Any = None) -> TrainState:
    return TrainState(params=params, opt=opt_init(params, opt_cfg),
                      noise_seed=torch.tensor(noise_seed, dtype=torch.int64),
                      bn_state=bn_state)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _step_generator(noise_seed: int, step: int,
                    device: torch.device) -> torch.Generator:
    """The generator of step `step`'s noise: a pure function of
    (noise_seed, step), on `device`."""
    seed = _splitmix64(((int(noise_seed) & 0xFFFFFFFF) << 32)
                       | (int(step) & 0xFFFFFFFF))
    return torch.Generator(device=device).manual_seed(seed & ((1 << 63) - 1))


def step_noise(state: TrainState) -> list:
    """The uniform noise the step at `state` trains on: `(ux, uh)` per
    layer, drawn on the parameters' device."""
    dev = state.params["layers"][0]["wh"].device
    gen = _step_generator(int(state.noise_seed), int(state.opt.step), dev)
    return BL.draw_noise(state.params, gen)


def loss_and_grads(params: Any, bn_state: Any, batch: dict,
                   cfg: BL.RNNConfig, noise: list):
    """(loss, new BN state, grads) of the training loss at `params`, with a
    zero gradient for every leaf the loss does not reach."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, new_bn = BL.lm_loss({"params": leaves, "state": bn_state},
                              batch["tokens"], batch["targets"], cfg,
                              training=True, noise=noise)
    flat = tree_leaves(leaves)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, got)}
    grads = tree_map(lambda p: by_id[id(p)], leaves)
    return loss.detach(), new_bn, grads


def make_rnn_train_step(cfg: BL.RNNConfig, opt_cfg: OptConfig) -> Callable:
    """step(state, batch, lr_scale=1.0, noise=None) -> (state, metrics).
    `lr_scale` is the plateau schedule's hook; `noise` overrides the
    step's own draw (`step_noise`)."""

    def step(state: TrainState, batch: dict, lr_scale=1.0,
             noise: Optional[list] = None):
        if noise is None:
            noise = step_noise(state)
        loss, new_bn, grads = loss_and_grads(state.params, state.bn_state,
                                             batch, cfg, noise)
        params, opt, m2 = opt_update(grads, state.opt, state.params, opt_cfg,
                                     lr_scale)
        metrics = {"loss": loss, "bpc": loss / math.log(2.0), **m2}
        return state._replace(params=BL.clip_masters(params, cfg), opt=opt,
                              bn_state=new_bn), metrics

    return step


def make_rnn_eval(cfg: BL.RNNConfig) -> Callable:
    """evaluate(state, batch) -> {'loss', 'bpc'} with the deterministic
    (inference) weights and the running BN statistics."""

    @torch.no_grad()
    def evaluate(state: TrainState, batch: dict) -> dict:
        loss, _ = BL.lm_loss({"params": state.params, "state": state.bn_state},
                             batch["tokens"], batch["targets"], cfg,
                             training=False)
        return {"loss": loss, "bpc": loss / math.log(2.0)}

    return evaluate

