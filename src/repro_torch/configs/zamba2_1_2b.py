"""zamba2-1.2b [hybrid] — 38 Mamba2 layers + a SHARED full-attention block
applied every 6 layers (weight reuse is the Zamba2 signature)
[arXiv:2411.15242].  SSM state 64, headdim 64 -> 64 SSD heads."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv=32,
        head_dim=64,
        d_ff=8192,
        vocab=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        attn_every=6,
        ssm_chunk=64,
        sub_quadratic=True,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
