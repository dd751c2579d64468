"""Train steps for the transformer pool and the paper's BN-LSTM/GRU,
ported from `repro/train/train_step.py`:

    grads -> [ternary compression + the data-parallel mean]
          -> clip -> AdamW/SGD -> master-weight clip to [-alpha, alpha]

The final clip is the paper's algorithm (it keeps the Bernoulli
probabilities in [0, 1]); it applies to the quantizable 'W*' leaves
(`qlinear.clip_tree`) or the RNN's recurrent and input matrices.  BN
running statistics thread through the RNN's state.

Randomness.  JAX's `TrainState.rng` key becomes `noise_seed`: the noise of
step s (the state's `opt.step`) is drawn from generators on the training
device seeded from (noise_seed, s) alone (the transformer's one a leaf,
salted with the leaf's crc32 as JAX folds it, `qlinear.step_noise`), so a
resumed run draws the same noise as an uninterrupted one without saving
generator state.  A caller may inject the noise instead (`step(...,
noise=...)`), which is how the tests feed the port the very arrays the JAX
step draws.

Gradients.  `torch.autograd.grad` returns None for a leaf the loss does not
reach (the gate BNs' additive terms, fixed at 0, and the unused cell-norm
BN of a GRU); `jax.grad` returns zeros there, and so does the step, so the
global norm and the Adam moments see the same tree.

Data parallelism.  JAX's `shard_map` over the mesh's data axes becomes one
process a rank: each step is given its rank's block of the global batch
(`data.loader.Prefetcher`), computes its local loss and gradients, and
averages over the data axes with one all-reduce (`launch.mesh.data_mean`,
JAX's `pmean`), so every rank holds the same state after the update.  With
`compress_grads` the local gradients are first ternarized with error
feedback (`train.compress`), and the mean takes the compressed gradients,
the new residual, the loss and the pool's `nll` or the RNN's new BN
running statistics; the RNN's batch statistics are then its local batch's,
as in JAX.  The compression noise of step s is the port's own
(`compress.step_noise`: noise_seed, s, the data rank, the leaf) or
injected (`comp_noise=`).  The pool's uncompressed step on a mesh averages
its gradients, loss, `nll` and `moe_aux` likewise, which is the
global-batch gradient JAX's SPMD step computes (the MoE's load-balancing
term is then the mean of the local batches' terms).  The RNN's
uncompressed step ignores the mesh, as JAX's does: it keeps exact
global-batch statistics, so its caller feeds it the whole batch.

Tensor parallelism.  On a mesh with a 'model' axis above 1 the pool's
uncompressed step is JAX's SPMD step on `DTensor`s: before the first step
the state becomes DTensors in `sharding.state_shardings`' layouts
(`shard_state`), the rank's block of the batch a DTensor sharded over the
data axes, and the step runs inside `use_mesh(mesh, param_rules=
param_pspec)`, where the model's `constrain` calls redistribute the
activations as JAX's `with_sharding_constraint` does and eager DTensor
ops issue the collectives XLA would (FSDP gathers, the row-parallel
all-reduces).  After the backward each gradient is redistributed to its
parameter's placements (DTensor may hand back a `Partial` or `Replicate`
one), so AdamW runs shard-local and the clip reads the global norm.  With
`compress_grads` the step is JAX's shard_map branch: every model rank
holds the whole parameters, computes the same local gradient, and the
mean runs over the data axes only, so the state stays plain tensors.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.core.qlinear import clip_tree, step_noise as leaf_noise
from repro_torch.core.qtensor import (tree_leaves, tree_map,
                                       tree_map_with_path, tree_paths)
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.models import transformer as T
from repro_torch.runtime import axis_sizes, placements, use_mesh
from repro_torch.train import compress as C
from repro_torch.train.optimizer import OptConfig, OptState, opt_init, opt_update


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    noise_seed: torch.Tensor  # () int64; replaces JAX's `rng` key
    bn_state: Any = None
    # gradient-compression error-feedback residual (None = compression off)
    residual: Any = None


def train_state_init(params: Any, opt_cfg: OptConfig, noise_seed: int,
                     bn_state: Any = None, compress: bool = False
                     ) -> TrainState:
    return TrainState(params=params, opt=opt_init(params, opt_cfg),
                      noise_seed=torch.tensor(noise_seed, dtype=torch.int64),
                      bn_state=bn_state,
                      residual=(tree_map(torch.zeros_like, params)
                                if compress else None))


def _step_generator(noise_seed: int, step: int,
                    device: torch.device) -> torch.Generator:
    """The generator of step `step`'s noise: a pure function of
    (noise_seed, step), on `device`."""
    seed = Q.step_seed(noise_seed, step) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)


def step_noise(state: TrainState) -> list:
    """The uniform noise the step at `state` trains on: `(ux, uh)` per
    layer, drawn on the parameters' device."""
    dev = state.params["layers"][0]["wh"].device
    gen = _step_generator(int(state.noise_seed), int(state.opt.step), dev)
    return BL.draw_noise(state.params, gen)


def value_and_grad(loss_fn: Callable, params: Any):
    """`loss_fn(leaves) -> (loss, aux)` and the gradient of the loss with
    respect to every leaf of `params`, zero for a leaf it does not reach:
    (loss, aux, grads)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = loss_fn(leaves)
    flat = tree_leaves(leaves)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, got)}
    return loss.detach(), aux, tree_map(lambda p: by_id[id(p)], leaves)


def loss_and_grads(params: Any, bn_state: Any, batch: dict,
                   cfg: BL.RNNConfig, noise: list):
    """(loss, new BN state, grads) of the training loss at `params`, with a
    zero gradient for every leaf the loss does not reach."""
    return value_and_grad(
        lambda leaves: BL.lm_loss({"params": leaves, "state": bn_state},
                                  batch["tokens"], batch["targets"], cfg,
                                  training=True, noise=noise), params)


def _compressed(state: TrainState, grads: Any, mesh, comp_noise, at):
    """The local gradients compressed with error feedback: (grads, new
    residual), drawing the step's own noise unless it is given.  `at` is
    (noise_seed, step), read before the step's work was queued: reading
    the device's step counter later would wait for that work."""
    if comp_noise is None:
        comp_noise = C.step_noise(grads, *at, M.data_index(mesh)[0])
    return C.compress_tree(grads, comp_noise, state.residual)


def mean_trees(mesh, *trees):
    """`data_mean` of every leaf of `trees` in one all-reduce; the trees
    back, in their structures."""
    paths = [tree_paths(t) for t in trees]
    flat = iter(M.data_mean(mesh, [x for ps in paths for _, x in ps]))
    out = []
    for t, ps in zip(trees, paths):
        got = {p: next(flat) for p, _ in ps}
        out.append(tree_map_with_path(lambda p, _: got[p], t))
    return out


def tensor_parallel(mesh) -> bool:
    """True for a mesh whose 'model' axis is above 1."""
    return mesh is not None and axis_sizes(mesh).get("model", 1) > 1


def shard_state(state: TrainState, mesh) -> TrainState:
    """The params, moments and residual as DTensors in
    `state_shardings`' layouts (each rank keeps its shard, no collective);
    the step counter and the noise seed stay plain, replicated."""
    lay = S.state_shardings(state, mesh)
    put = lambda t, l: None if t is None else S.distribute(t, l, mesh)
    return state._replace(
        params=put(state.params, lay.params),
        opt=state.opt._replace(m=put(state.opt.m, lay.opt.m),
                               v=put(state.opt.v, lay.opt.v)),
        residual=put(state.residual, lay.residual))


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's block of the batch as DTensors sharded over the data
    axes (`sharding.batch_shardings`' layout of the global batch, which
    the blocks divide)."""
    pl = placements((S._data_entry(mesh),), mesh)
    return {k: DTensor.from_local(v, mesh, pl, run_check=False)
            for k, v in batch.items()}


def _tp_step(cfg, opt_cfg: OptConfig, mesh) -> Callable:
    """The pool's uncompressed step on DTensors (the module docstring)."""

    def step(state: TrainState, batch: dict, noise=None, comp_noise=None):
        if not isinstance(tree_leaves(state.params)[0], DTensor):
            state = shard_state(state, mesh)
        at = (int(state.noise_seed), int(state.opt.step))
        if noise is None:
            noise = leaf_noise(*at)
        batch = shard_batch(batch, mesh)
        with use_mesh(mesh, param_rules=S.param_pspec), \
                implicit_replication():
            loss, aux, grads = value_and_grad(
                lambda leaves: T.lm_loss(leaves, batch, cfg, training=True,
                                         noise=noise), state.params)
            grads = tree_map(lambda g, p: g.redistribute(p.device_mesh,
                                                         p.placements),
                             grads, state.params)
            params, opt, m2 = opt_update(grads, state.opt, state.params,
                                         opt_cfg)
            params = clip_tree(params, cfg.quant)
        metrics = {"loss": loss, "nll": aux["nll"].detach(),
                   "moe_aux": aux["moe_aux"].detach(), **m2}
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return state._replace(params=params, opt=opt), metrics

    return step


def make_train_step(cfg, opt_cfg: OptConfig, mesh=None,
                    compress_grads: bool = False) -> Callable:
    """The transformer pool's step(state, batch, noise=None,
    comp_noise=None) -> (state, metrics): `transformer.lm_loss`
    (stochastic quantization with straight-through gradients) and its
    gradients, then `opt_update` (clip, AdamW/SGD, the schedule), then
    `clip_tree`.  `noise` overrides the step's own draw
    (`qlinear.step_noise(noise_seed, step)`): a {path: u} mapping of every
    quantizable leaf.  With a `mesh` the batch is this rank's block and the
    gradients are averaged over the data axes, compressed first with
    `compress_grads` (the module docstring); `comp_noise` overrides the
    compression's draw (one u a leaf, in flatten order).  On a mesh with
    a model axis above 1 and no compression the step is tensor-parallel
    over DTensors (the module docstring)."""
    compress = compress_grads and mesh is not None
    if tensor_parallel(mesh) and not compress:
        return _tp_step(cfg, opt_cfg, mesh)

    def step(state: TrainState, batch: dict, noise=None, comp_noise=None):
        at = (int(state.noise_seed), int(state.opt.step))
        if noise is None:
            noise = leaf_noise(*at)
        loss, aux, grads = value_and_grad(
            lambda leaves: T.lm_loss(leaves, batch, cfg, training=True,
                                     noise=noise), state.params)
        nll, residual = aux["nll"].detach(), state.residual
        if compress:
            grads, residual = _compressed(state, grads, mesh, comp_noise, at)
            grads, residual, (loss, nll) = mean_trees(
                mesh, grads, residual, [loss, nll])
            metrics = {"loss": loss, "nll": nll}
        else:
            moe_aux = aux["moe_aux"].detach()
            if mesh is not None:
                grads, (loss, nll, moe_aux) = mean_trees(
                    mesh, grads, [loss, nll, moe_aux])
            metrics = {"loss": loss, "nll": nll, "moe_aux": moe_aux}
        params, opt, m2 = opt_update(grads, state.opt, state.params, opt_cfg)
        metrics.update(m2)
        return state._replace(params=clip_tree(params, cfg.quant), opt=opt,
                              residual=residual), metrics

    return step


def make_rnn_train_step(cfg: BL.RNNConfig, opt_cfg: OptConfig, mesh=None,
                        compress_grads: bool = False) -> Callable:
    """step(state, batch, lr_scale=1.0, noise=None, comp_noise=None) ->
    (state, metrics).  `lr_scale` is the plateau schedule's hook; `noise`
    overrides the step's own draw (`step_noise`).  With `compress_grads`
    and a `mesh`, the batch is this rank's block: the local gradients are
    compressed with error feedback and averaged over the data axes with
    the new residual, the loss and the new BN running statistics
    (local-batch BN, as in JAX); `comp_noise` overrides the compression's
    draw."""
    compress = compress_grads and mesh is not None

    def step(state: TrainState, batch: dict, lr_scale=1.0,
             noise: Optional[list] = None, comp_noise=None):
        at = (int(state.noise_seed), int(state.opt.step))
        if noise is None:
            noise = step_noise(state)
        loss, new_bn, grads = loss_and_grads(state.params, state.bn_state,
                                             batch, cfg, noise)
        residual = state.residual
        if compress:
            grads, residual = _compressed(state, grads, mesh, comp_noise, at)
            grads, residual, new_bn, (loss,) = mean_trees(
                mesh, grads, residual, new_bn, [loss])
        params, opt, m2 = opt_update(grads, state.opt, state.params, opt_cfg,
                                     lr_scale)
        metrics = {"loss": loss, "bpc": loss / math.log(2.0), **m2}
        return state._replace(params=BL.clip_masters(params, cfg), opt=opt,
                              bn_state=new_bn, residual=residual), metrics

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

