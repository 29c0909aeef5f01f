"""granite-20b [dense] — llama-arch, code, MQA (kv=1). [arXiv:2405.04324; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    family="dense",
    source="arXiv:2405.04324; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        family="dense",
    )
