"""`QTensor`: the packed binary/ternary weight, ported from
`repro/core/qtensor.py`.

  * `codes` — int32 words holding the JAX package's uint32 bit patterns,
              packed along the contraction axis (see core/quantize.py).
              Leading axes (layer stacks) are kept: (R, K, N) packs to
              (R, ceil(K/G), N).
  * `scale` — optional per-output-channel fp companion.
  * `k`/`mode`/`alpha` — true contraction length, 'binary' or 'ternary',
              and the fixed Glorot alpha.

K that is not a multiple of the pack group is zero-padded at pack time; the
matmul wrappers zero-pad activations to the same boundary, so pad lanes
contribute exactly 0 whatever their codes decode to.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import quantize as Q


@dataclasses.dataclass(frozen=True)
class QTensor:
    codes: torch.Tensor                 # int32 (..., ceil(K/G), N)
    scale: Optional[torch.Tensor] = None
    k: int = 0
    mode: str = "ternary"
    alpha: float = 1.0

    @property
    def group(self) -> int:
        return Q.pack_group(self.mode)

    @property
    def shape(self) -> tuple:
        """Logical (unpacked) weight shape."""
        return tuple(self.codes.shape[:-2]) + (self.k, self.codes.shape[-1])

    @property
    def nbytes(self) -> int:
        """Bytes stored and streamed for this weight."""
        n = self.codes.numel() * self.codes.element_size()
        if self.scale is not None:
            n += self.scale.numel() * self.scale.element_size()
        return n

    def to(self, device) -> "QTensor":
        scale = self.scale.to(device) if self.scale is not None else None
        return dataclasses.replace(self, codes=self.codes.to(device),
                                   scale=scale)

    @classmethod
    def from_master(cls, w: torch.Tensor, mode: str,
                    alpha: Optional[float] = None,
                    scale: Optional[torch.Tensor] = None) -> "QTensor":
        """Deterministically quantize and pack a trained fp master weight
        (..., K, N)."""
        if w.dim() < 2:
            raise ValueError(f"QTensor needs a matmul weight, got shape {tuple(w.shape)}")
        group = Q.pack_group(mode)
        alpha = float(alpha) if alpha is not None else Q.leaf_alpha(w.shape)
        *lead, K, N = w.shape
        wn = torch.clamp(Q.divide(w.float(), alpha), -1.0, 1.0)
        qv = (torch.round(wn) if mode == "ternary"
              else torch.where(wn >= 0, 1.0, -1.0))
        pad = (-K) % group
        qv = torch.nn.functional.pad(qv, (0, 0, 0, pad))
        pack = Q.pack_ternary if mode == "ternary" else Q.pack_binary
        flat = qv.reshape(-1, K + pad, N)
        codes = torch.stack([pack(m) for m in flat])
        codes = codes.reshape(*lead, (K + pad) // group, N)
        return cls(codes=codes, scale=scale, k=K, mode=mode, alpha=alpha)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """The effective fp weight alpha * values (* scale)."""
        codes = Q.decode_codes(self.codes, self.mode)[..., : self.k, :]
        if self.mode == "ternary":
            vals = (codes == 1).to(dtype) - (codes == 3).to(dtype)
        else:
            vals = codes.to(dtype) * 2.0 - 1.0
        w = (self.alpha * vals).to(dtype)
        if self.scale is not None:
            w = w * self.scale.to(dtype)
        return w


def is_qtensor(x: Any) -> bool:
    return isinstance(x, QTensor)


def analytic_nbytes(shape, mode: str) -> int:
    """Serialized size of a QTensor of logical `shape` (each leading-axis
    matrix pads its own K groups)."""
    group = Q.pack_group(mode)
    *lead, K, N = shape
    return int(math.prod(lead)) * math.ceil(K / group) * N * 4


def tree_map_with_path(f, tree, *rest, path: tuple = ()):
    """Map `f(path, leaf, *leaves of rest)` over nested dicts, lists,
    tuples and NamedTuples of one structure; a path is a tuple of key
    strings (NamedTuple field names, list indices), and None stays None
    (an empty node, as in a JAX pytree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(f, v, *(r[k] for r in rest),
                                      path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        items = [tree_map_with_path(f, v, *(r[i] for r in rest),
                                    path=path + (str(n),))
                 for i, (n, v) in enumerate(zip(names, tree))]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return f(path, tree, *rest)


def tree_map(f, tree, *rest):
    """`tree_map_with_path` without the path: `f(leaf, *leaves of rest)`."""
    return tree_map_with_path(lambda _, *leaves: f(*leaves), tree, *rest)


def tree_paths(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in the JAX package's flatten order: dict keys sorted,
    NamedTuple fields and list items in order, None holding no leaf.  A
    path is a tuple of key strings (NamedTuple field names, list
    indices)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [pl for name, v in zip(names, tree)
                for pl in tree_paths(v, prefix + (str(name),))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    """Tensors and QTensors of a nested dict/list/NamedTuple tree, in the
    JAX package's flatten order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_to(tree, device):
    """Move every tensor of a nested dict/list/NamedTuple tree to `device`."""
    return tree_map(lambda t: t.to(device), tree)


def export_packed(params: Any, spec: Q.QuantSpec, *,
                  policy: Optional[Q.QuantPolicy] = None) -> Any:
    """Deterministically quantize every policy-matching leaf into a
    QTensor; everything else passes through untouched."""
    if spec.mode not in ("binary", "ternary"):
        raise ValueError(
            f"export_packed needs a binary/ternary spec, got mode={spec.mode!r}")
    policy = policy if policy is not None else spec.policy()

    def f(path, leaf):
        if is_qtensor(leaf) or not isinstance(leaf, torch.Tensor):
            return leaf
        name = path[-1] if path else ""
        if not policy.matches_name(name, "/".join(path), leaf.dim()):
            return leaf
        if name == "embed":  # consumed by row gather, not matmul
            return leaf
        return QTensor.from_master(leaf, spec.mode, Q.leaf_alpha(leaf.shape))

    return tree_map_with_path(f, params)


def tree_nbytes(tree: Any) -> tuple[int, int]:
    """(fp32-equivalent bytes, actual bytes) over a (possibly packed) tree."""
    fp = real = 0
    for leaf in tree_leaves(tree):
        if is_qtensor(leaf):
            fp += int(math.prod(leaf.shape)) * 4
            real += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            fp += leaf.numel() * 4
            real += leaf.numel() * leaf.element_size()
    return fp, real
