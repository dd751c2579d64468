"""Learning recurrent binary/ternary weights (Ardakani et al., ICLR 2019) —
the quantization core, ported from `repro/core/quantize.py`.

Implements the paper's Eqs. (1), (4), (5), (6): master weights normalized by
a fixed Glorot scale alpha, stochastic binary/ternary sampling from an
explicit uniform-noise operand `u`, the straight-through estimator, the
deterministic inference variants, the post-update master clip, the
literature baselines the paper compares against (BinaryConnect, TWN, TTQ,
DoReFa), and the 1-bit/2-bit packing the serving kernels read.

`w / alpha` divides by alpha as a float32 tensor on w's device: PyTorch
turns a CUDA tensor divided by a Python number into a multiply by its
reciprocal, which can round differently, and the quantize-pack kernel and
the JAX package both divide.

Codes are carried as int32 tensors holding the bit pattern of the JAX
package's uint32 words (PyTorch on the CPU has no shifts on uint32).  Decode
is `(c >> s) & mask`, which the mask makes safe under an arithmetic shift;
packing ORs the shifted codes together, since `sum` over int32 would
promote to int64.
"""
from __future__ import annotations

import dataclasses
import math
from fnmatch import fnmatchcase
from typing import Optional

import torch

TERNARY_GROUP = 16  # weights per 32-bit word (2 bits each)
BINARY_GROUP = 32   # weights per 32-bit word (1 bit each)


def pack_group(mode: str) -> int:
    """Weights per packed 32-bit word for a packed `mode`."""
    if mode not in ("ternary", "binary"):
        raise ValueError(f"mode must be 'ternary'|'binary', got {mode!r}")
    return TERNARY_GROUP if mode == "ternary" else BINARY_GROUP


def glorot_alpha(fan_in: int, fan_out: int) -> float:
    """Fixed per-matrix scale: the Glorot-uniform limit sqrt(6/(fan_in+fan_out))."""
    return math.sqrt(6.0 / float(fan_in + fan_out))


_MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """SplitMix64's finalizer: a 64-bit integer mixed into a seed."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_seed(noise_seed: int, step: int) -> int:
    """The seed of a training step's noise: a pure function of (noise_seed,
    step), so a resumed run draws an uninterrupted one's samples."""
    return splitmix64(((int(noise_seed) & 0xFFFFFFFF) << 32)
                      | (int(step) & 0xFFFFFFFF))


def leaf_alpha(shape) -> float:
    """Glorot alpha from the matmul dims (the last two axes)."""
    if len(shape) < 2:
        return 1.0
    return glorot_alpha(int(shape[-2]), int(shape[-1]))


# ---------------------------------------------------------------------------
# Straight-through estimator (Eq. 1)
# ---------------------------------------------------------------------------


class STE(torch.autograd.Function):
    """Forward returns the quantized tensor; the gradient flows unchanged to
    the master weights and the quantized branch gets none."""

    @staticmethod
    def forward(ctx, master, quantized):
        del ctx, master
        return quantized.clone()

    @staticmethod
    def backward(ctx, grad):
        del ctx
        return grad, None


def ste(master: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    return STE.apply(master, quantized.detach())


# ---------------------------------------------------------------------------
# Stochastic and deterministic binary / ternary quantization (Eqs. 4-6)
# ---------------------------------------------------------------------------


def divide(w: torch.Tensor, alpha) -> torch.Tensor:
    """w / alpha rounded as one IEEE division, on every device."""
    return w / torch.as_tensor(alpha, dtype=w.dtype, device=w.device)


def _normalize(w: torch.Tensor, alpha) -> torch.Tensor:
    return torch.clamp(divide(w, alpha), -1.0, 1.0)


def binarize_stochastic(w: torch.Tensor, u: torch.Tensor, alpha) -> torch.Tensor:
    """Eq. (4)+(6): P(w=+1) = (w^N + 1)/2, sampled through `u` ~ U(0, 1)."""
    p_one = (_normalize(w, alpha) + 1.0) * 0.5
    one = torch.ones((), dtype=w.dtype, device=w.device)
    return alpha * torch.where(u < p_one, one, -one)


def ternarize_stochastic(w: torch.Tensor, u: torch.Tensor, alpha) -> torch.Tensor:
    """Eq. (5)+(6): P(w=±1) = |w^N| with the sign of w, else 0."""
    wn = _normalize(w, alpha)
    nonzero = (u < torch.abs(wn)).to(w.dtype)
    return alpha * (nonzero * torch.sign(wn))


def binarize_deterministic(w: torch.Tensor, alpha) -> torch.Tensor:
    """sign(w^N) in {-1, +1}, with sign(0) = +1."""
    one = torch.ones((), dtype=w.dtype, device=w.device)
    return alpha * torch.where(_normalize(w, alpha) >= 0, one, -one)


def ternarize_deterministic(w: torch.Tensor, alpha) -> torch.Tensor:
    """round(w^N) in {-1, 0, +1}; `torch.round` rounds half to even like
    `jnp.round`."""
    return alpha * torch.round(_normalize(w, alpha))


def quantize(w: torch.Tensor, mode: str, alpha, u: Optional[torch.Tensor] = None,
             *, stochastic: bool = True, with_ste: bool = True) -> torch.Tensor:
    """The paper's quantizer as one entry point (mode 'binary' | 'ternary' |
    'none')."""
    if mode == "none":
        return w
    if stochastic:
        if u is None:
            raise ValueError("stochastic quantization requires uniform noise u")
        fn = binarize_stochastic if mode == "binary" else ternarize_stochastic
        q = fn(w, u, alpha)
    else:
        fn = binarize_deterministic if mode == "binary" else ternarize_deterministic
        q = fn(w, alpha)
    return ste(w, q) if with_ste else q


def clip_master(w: torch.Tensor, alpha) -> torch.Tensor:
    """Keep master weights inside [-alpha, alpha] after an optimizer step,
    so the Bernoulli probabilities stay in [0, 1]."""
    return torch.clamp(w, -alpha, alpha)


# ---------------------------------------------------------------------------
# Literature baselines the paper compares against (Tables 1-4)
# ---------------------------------------------------------------------------


def binaryconnect(w: torch.Tensor) -> torch.Tensor:
    """BinaryConnect, deterministic: E|w| * sign(w), sign(0) = +1."""
    alpha = w.abs().mean()
    one = torch.ones((), dtype=w.dtype, device=w.device)
    return ste(w, alpha * torch.where(w >= 0, one, -one))


def twn(w: torch.Tensor) -> torch.Tensor:
    """Ternary Weight Networks: threshold 0.7 * E|w|, scale E[|w| : |w| >
    threshold]."""
    delta = 0.7 * w.abs().mean()
    mask = (w.abs() > delta).to(w.dtype)
    alpha = (w.abs() * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ste(w, alpha * mask * torch.sign(w))


def ttq(w: torch.Tensor, alpha_pos: torch.Tensor,
        alpha_neg: torch.Tensor) -> torch.Tensor:
    """Trained Ternary Quantization: learned scales for the positive and
    negative supports, threshold 0.05 * max|w|.  The master gets the STE
    gradient; the scales get their real gradients through q."""
    delta = 0.05 * w.abs().max()
    pos = (w > delta).to(w.dtype)
    neg = (w < -delta).to(w.dtype)
    q = alpha_pos * pos - alpha_neg * neg
    return ste(w, q) + (q - q.detach())


def dorefa(w: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa-Net weight quantization to `bits` bits."""
    if bits == 1:
        return binaryconnect(w)
    t = torch.tanh(w)
    wn = t / (2.0 * t.abs().max()) + 0.5
    n = float(2 ** bits - 1)
    q = 2.0 * (torch.round(wn * n) / n) - 1.0
    return ste(w, q * w.abs().max())


# ---------------------------------------------------------------------------
# Bit packing.  Ternary: 2-bit codes {0b00: 0, 0b01: +1, 0b11: -1}, 16 a word.
# Binary: 1-bit codes {0: -1, 1: +1}, 32 a word.  Packed along the leading
# (contraction) axis: (K, N) -> (K/G, N).
# ---------------------------------------------------------------------------


def or_pack(codes: torch.Tensor, group: int, bits: int) -> torch.Tensor:
    k, n = codes.shape
    codes = codes.reshape(k // group, group, n)
    out = torch.zeros((k // group, n), dtype=torch.int32, device=codes.device)
    for j in range(group):
        out |= codes[:, j] << (bits * j)
    return out


def pack_ternary(q: torch.Tensor) -> torch.Tensor:
    """{-1, 0, +1} values (K, N), K % 16 == 0 -> int32 words (K/16, N)."""
    k, _ = q.shape
    if k % TERNARY_GROUP:
        raise ValueError(f"K={k} not a multiple of {TERNARY_GROUP}")
    one = torch.ones((), dtype=torch.int32, device=q.device)
    codes = torch.where(q > 0, one, torch.where(q < 0, 3 * one, 0 * one))
    return or_pack(codes, TERNARY_GROUP, 2)


def pack_binary(q: torch.Tensor) -> torch.Tensor:
    """{-1, +1} values (K, N), K % 32 == 0 -> int32 words (K/32, N)."""
    k, _ = q.shape
    if k % BINARY_GROUP:
        raise ValueError(f"K={k} not a multiple of {BINARY_GROUP}")
    return or_pack((q > 0).to(torch.int32), BINARY_GROUP, 1)


def decode_codes(packed: torch.Tensor, mode: str) -> torch.Tensor:
    """int32 words (..., K/G, N) -> per-weight codes (..., K, N), int32:
    2-bit codes for ternary, bits for binary."""
    group, bits, mask = ((TERNARY_GROUP, 2, 3) if mode == "ternary"
                         else (BINARY_GROUP, 1, 1))
    shifts = bits * torch.arange(group, dtype=torch.int32, device=packed.device)
    codes = (packed.unsqueeze(-2) >> shifts[:, None]) & mask
    *lead, kg, _, n = codes.shape
    return codes.reshape(*lead, kg * group, n)


def unpack_ternary(packed: torch.Tensor, k: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Inverse of pack_ternary -> (k, N) of {-1, 0, +1}; code 2 decodes to 0."""
    if packed.shape[0] * TERNARY_GROUP != k:
        raise ValueError(f"packed K {packed.shape[0]}*16 != {k}")
    codes = decode_codes(packed, "ternary")
    return ((codes == 1).to(dtype) - (codes == 3).to(dtype))


def unpack_binary(packed: torch.Tensor, k: int,
                  dtype=torch.float32) -> torch.Tensor:
    if packed.shape[0] * BINARY_GROUP != k:
        raise ValueError(f"packed K {packed.shape[0]}*32 != {k}")
    return decode_codes(packed, "binary").to(dtype) * 2.0 - 1.0


def packed_nbytes(shape: tuple, mode: str) -> int:
    """Analytic serialized size of a packed weight."""
    k = int(math.prod(shape[:-1]))
    n = shape[-1]
    if mode == "binary":
        return math.ceil(k / BINARY_GROUP) * n * 4
    if mode == "ternary":
        return math.ceil(k / TERNARY_GROUP) * n * 4
    return k * n * 4


# ---------------------------------------------------------------------------
# Quantization spec and the per-leaf policy resolved from it
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which parameter leaves are quantizable matmul weights.  Patterns are
    `fnmatch` globs against the leaf's own key or, when a pattern holds '/',
    against the '/'-joined path.  Precedence: exclude > extra > include;
    leaves below `min_ndim` never quantize."""

    include: tuple = ()
    exclude: tuple = ()
    extra: tuple = ()
    min_ndim: int = 2

    def _hit(self, patterns, name: str, path: str) -> bool:
        return any(fnmatchcase(path if "/" in pat else name, pat)
                   for pat in patterns)

    def matches_name(self, name: str, path: Optional[str] = None,
                     ndim: Optional[int] = None) -> bool:
        path = path if path is not None else name
        if ndim is not None and ndim < self.min_ndim:
            return False
        if self._hit(self.exclude, name, path):
            return False
        if name in self.extra:
            return True
        return self._hit(self.include, name, path)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How the paper's technique is applied to a model's matmuls."""

    mode: str = "none"  # none | binary | ternary | binaryconnect | twn | dorefa2..4
    stochastic: bool = True
    norm: str = "batch"
    quantize_embeddings: bool = False
    # route the training weights through their packed codes (quantize,
    # pack, unpack; `qlinear.quantize_tree`): the same values, the form a
    # sharded run would move between devices
    packed_comms: bool = False
    include: tuple = ("W*",)
    exclude: tuple = ()

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def weight_bits(self) -> float:
        return {"binary": 1, "binaryconnect": 1, "ternary": 2, "twn": 2,
                "dorefa2": 2, "dorefa3": 3, "dorefa4": 4}.get(self.mode, 32)

    def policy(self) -> QuantPolicy:
        extra = ("embed", "head") if self.quantize_embeddings else ()
        return QuantPolicy(include=tuple(self.include),
                           exclude=tuple(self.exclude), extra=extra)


def apply_quant(w: torch.Tensor, spec: QuantSpec, alpha,
                u: Optional[torch.Tensor]) -> torch.Tensor:
    """Send a weight matrix through the configured quantizer (training
    path)."""
    m = spec.mode
    if m == "none":
        return w
    if m in ("binary", "ternary"):
        return quantize(w, m, alpha, u, stochastic=spec.stochastic)
    if m == "binaryconnect":
        return binaryconnect(w)
    if m == "twn":
        return twn(w)
    if m.startswith("dorefa"):
        return dorefa(w, int(m[len("dorefa"):]))
    raise ValueError(f"unknown quant mode {m!r}")
