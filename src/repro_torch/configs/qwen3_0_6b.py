"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-0.6B]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv=8,
        head_dim=128,
        d_ff=3072,
        vocab=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        block_pattern=("full",),
        tie_embeddings=True,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
