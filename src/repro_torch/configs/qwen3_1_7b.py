"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-1.7B]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv=8,
        head_dim=128,
        d_ff=6144,
        vocab=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        block_pattern=("full",),
        tie_embeddings=True,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
