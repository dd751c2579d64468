"""gemma3-27b [dense] — 5:1 local:global attention, 1024-token window, 256k
vocab [hf:google/gemma-3-27b-pt].  Local ring-KV makes it long_500k-eligible
(the ~10 global layers hold the full context, head/length-sharded)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv=16,
        head_dim=128,
        d_ff=21504,
        vocab=262144,
        qk_norm=True,
        rope_theta=1000000.0,
        block_pattern=("local", "local", "local", "local", "local", "global"),
        window=1024,
        sub_quadratic=True,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
