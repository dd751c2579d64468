"""Plain oracles for every kernel of the port, ported from
`repro/kernels/ref.py`: the packed matmuls unpack to -1/0/+1 floats and run
an fp32 matmul; quantize-pack samples with the dense quantizers, then packs.
They define the semantics the kernels' plain versions must match."""
from __future__ import annotations

import torch

from repro_torch.core.quantize import (binarize_stochastic, pack_binary,
                                       pack_ternary, ternarize_stochastic,
                                       unpack_binary, unpack_ternary)


def ternary_matmul_ref(x: torch.Tensor, wp: torch.Tensor, k: int,
                       alpha: float = 1.0) -> torch.Tensor:
    """x (M, K) @ alpha * unpack(wp (K/16, N)) -> (M, N) fp32."""
    return alpha * (x.float() @ unpack_ternary(wp, k))


def binary_matmul_ref(x: torch.Tensor, wp: torch.Tensor, k: int,
                      alpha: float = 1.0) -> torch.Tensor:
    return alpha * (x.float() @ unpack_binary(wp, k))



def quantize_pack_ternary_ref(w: torch.Tensor, u: torch.Tensor,
                              alpha: float) -> torch.Tensor:
    """Stochastic ternarize (paper Eq. 5/6), then 2-bit pack."""
    return pack_ternary(torch.sign(ternarize_stochastic(w, u, alpha)))


def quantize_pack_binary_ref(w: torch.Tensor, u: torch.Tensor,
                             alpha: float) -> torch.Tensor:
    """Stochastic binarize (paper Eq. 4/6), then 1-bit pack."""
    return pack_binary(binarize_stochastic(w, u, alpha))
