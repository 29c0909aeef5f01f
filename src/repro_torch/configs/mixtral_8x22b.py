"""mixtral-8x22b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    block_pattern=("moe",),
    n_experts=8,
    moe_top_k=2,
    sliding_window=4096,
    rope_theta=1e6,
    family="moe",
    source="arXiv:2401.04088; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        block_pattern=("moe",),
        n_experts=4,
        moe_top_k=2,
        sliding_window=32,
        capacity_factor=8.0,  # drop-free for exact-match smoke tests
        family="moe",
    )
