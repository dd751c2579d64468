"""The paper's technique as a layer for the transformer pool's matmul
stacks, ported from `repro/core/qlinear.py`.

Which leaves quantize is the spec's `QuantPolicy` (core/quantize.py):
capital-'W' matmul weights by default; embeddings, norms, biases and the
channel-scale companions stay full precision.

`quantize_tree(params, spec, compute_dtype=..., noise=...)` quantizes every
policy-matching leaf once per forward (paper Algorithm 1, lines 2-6) and
casts it to the compute dtype; exported `QTensor` leaves pass through, so
the same model code serves packed weights.  Stacked per-layer weights (a
leading layer axis) quantize in one shot, outside any per-layer loop or
recomputed region, as JAX samples outside its scan.  A stochastic
binary/ternary spec samples with uniform noise `u` per leaf and returns
the sample with a straight-through gradient to the fp32 master
(`Q.quantize`, then `Q.ste`, then the cast).  With `spec.packed_comms` the
sample goes through its packed codes and back (quantize, pack, unpack,
times alpha, then the STE): the same values, in the form a sharded run
would gather.  A leaf whose K is no multiple of the packing group takes
the plain cast, as in JAX.

The noise.  JAX draws leaf `path` from `fold_in(rng, crc32(path) &
0x7FFFFFFF)`, one draw for a whole stacked leaf.  Here `noise` is either a
mapping {path: u} (the tests feed the port JAX's own draws so) or a
function of (path, leaf): `step_noise(noise_seed, step)` draws each leaf
from a `torch.Generator` on the leaf's device seeded from (noise_seed,
step, that crc32), so a step's sample is a pure function of the step.  A
path is JAX's `Q.path_str`, tuple indices included (`stack/0/attn/Wq`).

`clip_tree` clips the quantizable masters to [-alpha, alpha] after an
optimizer step, which keeps the Bernoulli probabilities valid.

For the transformer pool the BN of Eq. (7) becomes a learnable
per-output-channel scale (`norm='channel'`): companion leaves 's<name>'
made at init by `maybe_scale` and applied by `scaled` at the call site.

On a mesh (tensor-parallel training, `runtime.use_mesh(param_rules=)`),
`runtime.constrain_param` pins each sample and cast to its master's
storage layout, and with `packed_comms` the codes to it and the unpacked
copy to the compute layout, as JAX's; elsewhere it does nothing.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Mapping, Optional, Union

import torch

from repro_torch import runtime as R
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import is_qtensor, tree_map_with_path
from repro_torch.runtime import constrain_param

Noise = Union[Mapping[str, torch.Tensor],
              Callable[[str, torch.Tensor], torch.Tensor]]


def leaf_crc(name: str) -> int:
    """The per-leaf salt JAX folds into its key: crc32 of the path."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def step_noise(noise_seed: int, step: int) -> Callable:
    """`noise` for `quantize_tree`: leaf `name` gets U(0, 1) noise of its
    shape from a generator on its device seeded from (noise_seed, step,
    crc32(name))."""
    base = Q.step_seed(noise_seed, step)

    def draw(name: str, leaf: torch.Tensor) -> torch.Tensor:
        seed = Q.splitmix64(base ^ leaf_crc(name)) & ((1 << 63) - 1)
        gen = torch.Generator(device=leaf.device).manual_seed(seed)
        return torch.rand(leaf.shape, generator=gen, dtype=leaf.dtype,
                          device=leaf.device)
    return draw


def is_quantizable(path_key: str, spec: Optional[Q.QuantSpec] = None) -> bool:
    """Whether a leaf named `path_key` quantizes under `spec`'s policy (the
    default spec's when None); JAX's thin wrapper, for callers that only
    have a leaf name."""
    spec = spec if spec is not None else Q.QuantSpec()
    return spec.policy().matches_name(path_key)


def _policy_leaves(params: Any, spec: Q.QuantSpec, fn) -> Any:
    """Map `fn(name, leaf)` over the policy-matching tensor leaves; the
    rest (packed `QTensor`s included) pass through."""
    policy = spec.policy()

    def f(path, leaf):
        if is_qtensor(leaf) or not isinstance(leaf, torch.Tensor):
            return leaf
        name = Q.path_str(path)
        if not policy.matches_name(path[-1] if path else "", name,
                                   leaf.dim()):
            return leaf
        return fn(name, leaf)

    return tree_map_with_path(f, params)


def _packed_roundtrip(q: torch.Tensor, master: torch.Tensor, alpha,
                      mode: str, compute_dtype, cast,
                      path: tuple) -> torch.Tensor:
    """quantize -> pack -> unpack -> times alpha -> STE: the value of `q`
    through its codes.  K not a multiple of the group takes the plain
    `cast`.  On a mesh the codes take the master's storage layout and the
    unpacked copy the compute layout (JAX's `constrain_param` calls)."""
    group = Q.pack_group(mode)
    K, N = q.shape[-2], q.shape[-1]
    if K % group:
        return cast(q)
    pack = Q.pack_ternary if mode == "ternary" else Q.pack_binary
    unpack = Q.unpack_ternary if mode == "ternary" else Q.unpack_binary
    qs = Q.divide(q.detach().reshape(-1, K, N), alpha)
    codes = torch.stack([pack(m) for m in qs]).reshape(
        *q.shape[:-2], K // group, N)
    codes = constrain_param(path, master, codes)
    wq = torch.stack([unpack(c, K, dtype=q.dtype)
                      for c in codes.reshape(-1, K // group, N)])
    wq = alpha * wq.reshape(q.shape)
    if compute_dtype is not None:
        wq = wq.to(compute_dtype)
    wq = constrain_param(path, master, wq, drop_axes=("data", "pod"),
                         kind="compute")
    return Q.ste(master, wq)


def quantize_tree(params: Any, spec: Q.QuantSpec,
                  compute_dtype: Optional[torch.dtype] = None,
                  noise: Optional[Noise] = None) -> Any:
    """Quantize every policy-matching leaf and cast it to `compute_dtype`
    after quantization (the masters stay fp32); everything else, packed
    `QTensor` leaves included, passes through.  A stochastic binary or
    ternary spec needs `noise` (a {path: u} mapping or a function of
    (path, leaf)); its samples carry straight-through gradients."""

    def f(name, leaf):
        path = tuple(name.split("/"))

        def cast(w):
            w = w.to(compute_dtype) if compute_dtype is not None else w
            return constrain_param(path, leaf, w)

        def finish(q, master, alpha):
            if spec.packed_comms:
                return _packed_roundtrip(q, master, alpha, spec.mode,
                                         compute_dtype, cast, path)
            return cast(q)

        if not spec.enabled:
            return cast(leaf)
        alpha = Q.leaf_alpha(leaf.shape)
        if spec.mode in ("binary", "ternary") and spec.stochastic:
            if noise is None:
                raise ValueError("stochastic quantization requires noise")
            u = (noise[name] if isinstance(noise, Mapping)
                 else noise(name, leaf)).to(leaf.device)
            return finish(Q.quantize(leaf, spec.mode, alpha, u,
                                     stochastic=True), leaf, alpha)
        if spec.mode in ("binary", "ternary"):
            return finish(Q.quantize(leaf, spec.mode, alpha, stochastic=False,
                                     with_ste=leaf.requires_grad),
                          leaf, alpha)
        return cast(Q.apply_quant(leaf, spec, alpha, None))

    return _policy_leaves(params, spec, f)


def clip_tree(params: Any, spec: Q.QuantSpec) -> Any:
    """Clip the quantizable masters to [-alpha, alpha] after an optimizer
    step (keeps the Bernoulli probabilities valid)."""
    if not spec.enabled or spec.mode not in ("binary", "ternary"):
        return params
    return _policy_leaves(
        params, spec,
        lambda name, leaf: Q.clip_master(leaf, Q.leaf_alpha(leaf.shape)))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def winit(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Glorot-uniform init at the scale the quantizer expects, drawn on the
    generator's device."""
    a = Q.leaf_alpha(shape)
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return u * (2 * a) - a


def maybe_scale(params: dict, wname: str, spec: Q.QuantSpec, d_out: int,
                device=None) -> None:
    """Attach the per-output-channel scale companion for norm='channel'."""
    if spec.enabled and spec.norm == "channel":
        params["s" + wname[1:]] = torch.ones((d_out,), device=device)


def scaled(y: torch.Tensor, params: dict, wname: str,
           spec: Q.QuantSpec) -> torch.Tensor:
    """Apply the channel-scale companion if configured."""
    s = params.get("s" + wname[1:])
    if spec.enabled and spec.norm == "channel" and s is not None:
        return y * s.to(y.dtype)
    return y


def scaled_sum(y: torch.Tensor, params: dict, wname: str,
               spec: Q.QuantSpec) -> torch.Tensor:
    """`reduced(scaled(y, ...))` for a row-parallel product's partial sums
    `y`: scaled, then summed over the mesh, the scale's gradient taken on
    each rank's partial sums (`runtime.scaled_sum`)."""
    s = params.get("s" + wname[1:])
    if spec.enabled and spec.norm == "channel" and s is not None:
        return R.scaled_sum(y, s.to(y.dtype))
    return R.reduced(y)
