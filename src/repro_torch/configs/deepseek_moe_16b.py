"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert fine-grained ff
    vocab_size=102400,
    block_pattern=("moe",),
    first_k_dense=1,  # layer 0 dense, layers 1..27 moe (deepseek-moe)
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    family="moe",
    source="arXiv:2401.06066; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        block_pattern=("moe",),
        first_k_dense=1,
        n_experts=8,
        n_shared_experts=2,
        moe_top_k=3,
        moe_d_ff=96,
        capacity_factor=8.0,  # drop-free for exact-match smoke tests
        family="moe",
    )
