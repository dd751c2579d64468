"""Plain oracles for the packed matmuls, ported from `repro/kernels/ref.py`:
unpack to -1/0/+1 floats and run an fp32 matmul.  (The quantize-pack
oracles come with the quantize-pack kernel.)"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import unpack_binary, unpack_ternary


def ternary_matmul_ref(x: torch.Tensor, wp: torch.Tensor, k: int,
                       alpha: float = 1.0) -> torch.Tensor:
    """x (M, K) @ alpha * unpack(wp (K/16, N)) -> (M, N) fp32."""
    return alpha * (x.float() @ unpack_ternary(wp, k))


def binary_matmul_ref(x: torch.Tensor, wp: torch.Tensor, k: int,
                      alpha: float = 1.0) -> torch.Tensor:
    return alpha * (x.float() @ unpack_binary(wp, k))

