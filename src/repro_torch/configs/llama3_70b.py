"""llama3-70b — the paper's headline target model (348 tok/s highlight)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    family="dense",
    source="llama3 tech report; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-70b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        family="dense",
    )
