"""llama3.2-1b — paper Table 1 draft-scaling subject."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-1b",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    family="dense",
    source="llama3.2; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-1b-smoke",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab_size=256,
        family="dense",
    )
