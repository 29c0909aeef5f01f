"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free.
[arXiv:2404.05892; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    attn_kind="none",
    ssm_head_dim=64,  # wkv head size
    family="ssm",
    source="arXiv:2404.05892; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=128,
        vocab_size=256,
        block_pattern=("rwkv6",),
        attn_kind="none",
        ssm_head_dim=16,
        family="ssm",
    )
