"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention on every
layer (ring KV makes it long_500k-eligible) [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        head_dim=128,
        d_ff=14336,
        vocab=32000,
        rope_theta=1000000.0,
        block_pattern=("full",),
        n_experts=8,
        topk=2,
        window=4096,
        swa_all=True,
        sub_quadratic=True,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
