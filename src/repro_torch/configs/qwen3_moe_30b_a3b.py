"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8, d_ff=768 per expert
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv=4,
        head_dim=128,
        d_ff=768,
        vocab=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        block_pattern=("full",),
        n_experts=128,
        topk=8,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
