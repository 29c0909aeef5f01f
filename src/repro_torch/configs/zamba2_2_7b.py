"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

54 Mamba2 layers with one weight-shared attention block invoked every 6
layers (the public model interleaves two shared blocks; the reference
simplifies to one, and so does this copy).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("mamba2",),
    shared_attn_every=6,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    head_dim=80,
    family="hybrid",
    source="arXiv:2411.15242; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        block_pattern=("mamba2",),
        shared_attn_every=2,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        head_dim=16,
        family="hybrid",
    )
