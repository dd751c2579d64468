"""The paper's technique as a layer for the transformer pool's matmul
stacks, ported from `repro/core/qlinear.py` (its serving half).

Which leaves quantize is the spec's `QuantPolicy` (core/quantize.py):
capital-'W' matmul weights by default; embeddings, norms, biases and the
channel-scale companions stay full precision.

`quantize_tree(params, spec, compute_dtype=...)` quantizes every
policy-matching leaf deterministically (the paper's inference variant) and
casts it to the compute dtype; exported `QTensor` leaves pass through, so
the same model code serves packed weights.  Stacked per-layer weights
(a leading layer axis) quantize in one shot.  The stochastic training
branch (Bernoulli sampling with straight-through gradients) and
`clip_tree` come with transformer training.

For the transformer pool the BN of Eq. (7) becomes a learnable
per-output-channel scale (`norm='channel'`): companion leaves 's<name>'
made at init by `maybe_scale` and applied by `scaled` at the call site.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import is_qtensor, tree_map_with_path


def quantize_tree(params: Any, spec: Q.QuantSpec,
                  compute_dtype: Optional[torch.dtype] = None) -> Any:
    """Quantize every policy-matching leaf deterministically and cast it to
    `compute_dtype` after quantization (the masters stay fp32); everything
    else, packed `QTensor` leaves included, passes through.  JAX's `rng`
    argument feeds the stochastic training branch, which is not ported: a
    stochastic binary/ternary spec is refused."""
    if spec.stochastic and spec.mode in ("binary", "ternary"):
        raise NotImplementedError(
            "stochastic quantize_tree (transformer training) is not ported: "
            "pass a deterministic spec")
    policy = spec.policy()

    def cast(w):
        return w.to(compute_dtype) if compute_dtype is not None else w

    def f(path, leaf):
        if is_qtensor(leaf) or not isinstance(leaf, torch.Tensor):
            return leaf
        name = path[-1] if path else ""
        if not policy.matches_name(name, "/".join(path), leaf.dim()):
            return leaf
        if not spec.enabled:
            return cast(leaf)
        alpha = Q.leaf_alpha(leaf.shape)
        if spec.mode in ("binary", "ternary"):
            return cast(Q.quantize(leaf, spec.mode, alpha, stochastic=False,
                                   with_ste=False))
        return cast(Q.apply_quant(leaf, spec, alpha, None))

    return tree_map_with_path(f, params)


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
