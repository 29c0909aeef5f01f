"""musicgen-large [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB — ``input_specs()`` provides
precomputed frame embeddings for train/prefill; decode consumes EnCodec token
ids through the decoder's own embedding table (vocab 2048).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    embed_inputs=False,  # stub frontend feeds frame embeddings
    family="audio",
    source="arXiv:2306.05284; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        embed_inputs=False,
        family="audio",
    )
