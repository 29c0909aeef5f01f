"""deepseek-coder-33b [dense] — llama-arch. Paper target model (§5, Table 4).
[arXiv:2401.14196; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=1e5,
    family="dense",
    source="arXiv:2401.14196; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        family="dense",
    )
