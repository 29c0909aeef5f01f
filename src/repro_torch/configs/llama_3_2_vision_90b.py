"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Backbone only: the ViT tower is a STUB — ``input_specs()`` provides
precomputed vision-patch embeddings (n_enc_tokens x d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("dense", "dense", "dense", "dense", "cross"),
    cross_attn_every=5,
    n_enc_tokens=1024,
    rope_theta=5e5,
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        block_pattern=("dense", "dense", "dense", "dense", "cross"),
        cross_attn_every=5,
        n_enc_tokens=16,
        family="vlm",
    )
