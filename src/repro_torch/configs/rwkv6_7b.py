"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay
[arXiv:2404.05892].  head size 64 -> 64 heads at d_model 4096."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,
        n_kv=64,
        head_dim=64,
        d_ff=14336,
        vocab=65536,
        block_pattern=("rwkv",),
        ssm_chunk=64,
        sub_quadratic=True,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
