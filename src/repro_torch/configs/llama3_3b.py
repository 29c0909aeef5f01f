"""llama3.2-3b — the paper's draft model for Llama3-70B."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    family="dense",
    source="llama3.2; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-3b-smoke",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        family="dense",
    )
