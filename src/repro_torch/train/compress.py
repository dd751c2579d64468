"""Unbiased stochastic ternary gradient compression, ported from
`repro/train/compress.py`: the paper's own Eq. (5)/(6) sampling run a
second time, on each data-parallel replica's gradient before the
cross-replica mean.

  t = s * Tern(g / s),  s = max|g| + 1e-12  (per tensor)   =>   E[t] = g

Error feedback keeps the quantization residual and adds it to the next
step's gradient: corrected = g + r, new residual = corrected - t.

The uniform draw `u` is explicit, as in the quantizers: `compress_tree`
takes one `u` a leaf in the JAX package's flatten order, so the tests can
feed it JAX's draws.  The port's own draw (`step_noise`) is a pure function
of (noise_seed, step, data rank, leaf): a resumed run draws what an
uninterrupted one draws, every data rank draws its own stream, and the
stream is not the model noise's (the two hazards JAX's `_dp_step_keys`
names).

The wire format is JAX's: the mean moves the fp32 values t, and
`compressed_bytes` only reports what 2-bit codes would move.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional, Tuple

import torch

from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import tree_map_with_path, tree_paths

# salts the compression stream away from the model noise's, which mixes
# (noise_seed, step) and a leaf's crc32 (`qlinear.step_noise`)
STREAM = 0xC0DE7E57


def ternary_compress(g: torch.Tensor, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (t, scale) with t in {-1, 0, +1} * scale and E[t] = g over u ~
    U(0, 1).  `p` divides by `scale` as a tensor on g's device (one IEEE
    division, `Q.divide`'s reason); `u < p` is strict and sign(0) = 0."""
    a = torch.abs(g)
    scale = torch.max(a) + 1e-12
    p = a / scale
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    t = torch.where(u < p, torch.sign(g), zero)
    return t * scale, scale


def compress_tree(grads: Any, noise: Iterable[torch.Tensor],
                  residual: Optional[Any] = None) -> Tuple[Any, Any]:
    """Ternarize every leaf of `grads` with error feedback: (compressed
    grads, new residual), trees of `grads`' structure.  `noise` yields one
    `u` a leaf in flatten order (a list, or `step_noise`'s lazy draw); a
    missing `residual` is zeros, added as JAX adds them."""
    paths = tree_paths(grads)
    res = ([leaf for _, leaf in tree_paths(residual)] if residual is not None
           else [torch.zeros_like(g) for _, g in paths])
    out, new_res = {}, {}
    us = iter(noise)
    for (path, g), r in zip(paths, res):
        corrected = g + r
        t, _ = ternary_compress(corrected, next(us))
        out[path], new_res[path] = t, corrected - t
    return (tree_map_with_path(lambda p, _: out[p], grads),
            tree_map_with_path(lambda p, _: new_res[p], grads))


def leaf_seed(noise_seed: int, step: int, rank: int, leaf: int) -> int:
    """The seed of leaf `leaf`'s compression draw at `step` on data rank
    `rank`."""
    x = Q.step_seed(noise_seed, step)
    for salt in (STREAM, rank, leaf):
        x = Q.splitmix64(x ^ salt)
    return x & ((1 << 63) - 1)


def step_noise(grads: Any, noise_seed: int, step: int,
               rank: int) -> Iterator[torch.Tensor]:
    """One U(0, 1) draw a leaf of `grads`, in flatten order, each drawn
    when it is asked for (a generator a leaf on the leaf's device)."""
    for i, (_, g) in enumerate(tree_paths(grads)):
        gen = torch.Generator(device=g.device).manual_seed(
            leaf_seed(noise_seed, step, rank, i))
        yield torch.rand(g.shape, generator=gen, dtype=torch.float32,
                         device=g.device)


def compressed_bytes(grads: Any) -> tuple[int, int]:
    """(fp32 all-reduce bytes, 2-bit-code all-reduce bytes) for
    reporting."""
    leaves = [leaf for _, leaf in tree_paths(grads)]
    n = sum(x.numel() for x in leaves)
    return 4 * n, (2 * n) // 8 + 4 * len(leaves)
