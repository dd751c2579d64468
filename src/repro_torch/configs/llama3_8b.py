"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        head_dim=128,
        d_ff=14336,
        vocab=128256,
        rope_theta=500000.0,
        block_pattern=("full",),
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
