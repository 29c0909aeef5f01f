"""minicpm3-4b [dense] — MLA attention. [hf:openbmb/MiniCPM3-4B; hf]

MLA inner dims follow the public MiniCPM3 config (q_lora 768, kv_lora 256,
rope 32, nope 64, v 64); the assignment line pins only the outer shape.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    rope_head_dim=32,
    nope_head_dim=64,
    v_head_dim=64,
    head_dim=96,  # nope + rope
    family="dense",
    source="hf:openbmb/MiniCPM3-4B; hf",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        attn_kind="mla",
        q_lora_rank=32,
        kv_lora_rank=16,
        rope_head_dim=8,
        nope_head_dim=16,
        v_head_dim=16,
        head_dim=24,
        family="dense",
    )
