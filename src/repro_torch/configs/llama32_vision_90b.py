"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th block;
vision tower is a STUB (input_specs supplies (B, 1600, 8192) patch embeddings)
[hf:meta-llama/Llama-3.2-90B-Vision]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv=8,
        head_dim=128,
        d_ff=28672,
        vocab=128256,
        rope_theta=500000.0,
        block_pattern=("self", "self", "self", "self", "cross"),
        n_img_tokens=1600,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
