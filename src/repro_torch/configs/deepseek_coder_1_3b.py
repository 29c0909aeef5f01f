"""deepseek-coder-1.3b — the paper's draft model for deepseek-coder-33b."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-1.3b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5504,
    vocab_size=32256,
    rope_theta=1e5,
    family="dense",
    source="arXiv:2401.14196; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-1.3b-smoke",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab_size=256,
        family="dense",
    )
