"""qwen2.5-14b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        family="dense",
    )
