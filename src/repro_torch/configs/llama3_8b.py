"""llama3-8b — paper Table 1 TP-scaling subject / R1-distill draft analogue."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    family="dense",
    source="llama3 tech report; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        family="dense",
    )
