"""Unified model configuration of the transformer pool, ported from
`repro/configs/base.py` (which imports no JAX but belongs to the JAX
package, so the port keeps its own copy), with its training fields
(`remat`, `remat_policy`, `parallel_block`).  JAX's `unroll` (its scan over
the repeats or a Python loop) has no counterpart: the port always loops.

One frozen dataclass covers the whole pool; family-specific fields are
ignored by families that do not use them.  `reduced()` gives the small
smoke-test variant of the same family (same code paths, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.quantize import QuantSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500000.0
    causal: bool = True
    mlp: str = "swiglu"  # swiglu | gelu
    attn_softcap: float = 0.0
    tie_embeddings: bool = False

    # heterogeneous layer stacks: repeating pattern of layer kinds
    # kinds: full | local | global | self | cross | mamba | rwkv
    block_pattern: Tuple[str, ...] = ("full",)
    window: int = 0  # sliding window for 'local' kind / swa_all
    swa_all: bool = False  # mixtral: SWA on every layer

    # moe
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25

    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0  # zamba2: shared attn block period

    # enc-dec (whisper): n_layers = decoder depth
    n_enc_layers: int = 0
    max_target_len: int = 448

    # vlm
    n_img_tokens: int = 0

    # quantization (the paper's technique)
    quant: QuantSpec = QuantSpec(mode="none")

    # numerics / structure
    dtype: str = "bfloat16"
    # recompute each repeat of the pattern in the backward pass instead of
    # keeping its activations; "dots" keeps the weight products' outputs
    remat: bool = True
    remat_policy: str = "full"  # full | dots
    attn_chunk: int = 1024
    ssm_chunk: int = 64
    vocab_pad_to: int = 128
    # PaLM-style parallel block: attention and MLP read one shared pre-norm
    # and both add to the residual (a training-time architecture choice)
    parallel_block: bool = False

    # capability flags
    sub_quadratic: bool = False  # eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    def with_quant(self, spec: QuantSpec) -> "ModelConfig":
        return dataclasses.replace(self, quant=spec)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = self.block_pattern
        n_layers = (max(len(pat), 2) if self.family != "hybrid"
                    else max(self.attn_every + 1, 4))
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            topk=min(self.topk, 2) if self.topk else 0,
            window=min(self.window, 16) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_img_tokens=min(self.n_img_tokens, 16) if self.n_img_tokens else 0,
            attn_chunk=32,
            ssm_chunk=8,
            dtype="float32",
        )


# `head_dim` note: configs specify d_model and n_heads; where the public model
# card gives an explicit head_dim != d_model/n_heads (gemma3, qwen3) we set it.
