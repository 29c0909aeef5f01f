"""Model configurations: a copy of ``repro.configs.base.ModelConfig`` and a
registry of the architectures this port runs.

Each architecture lives in ``repro_torch/configs/<id>.py`` exposing
``CONFIG`` (full published shape) and ``smoke_config()`` (reduced same-family
shape for CPU tests), as in the reference package: all fifteen of its
configs — dense (GQA and MLA), MoE, the zamba2 hybrid, rwkv6, audio
(embedding inputs) and vision (cross-attention).
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int  # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # block pattern: layer kind cycled over layers. kinds:
    #   dense  = attn + swiglu-mlp
    #   moe    = attn + mixture-of-experts
    #   mamba2 = mamba2 ssd block
    #   rwkv6  = rwkv time-mix + channel-mix
    #   cross  = cross-attention (to stub encoder states) + swiglu-mlp
    block_pattern: tuple = ("dense",)

    # attention
    attn_kind: str = "gqa"  # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0  # per-expert ff (deepseek fine-grained); 0 -> d_ff

    # MLA (minicpm3 / deepseek-v2 style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_groups: int = 1

    # hybrid / modality wiring
    first_k_dense: int = 0  # deepseek-moe: dense prologue layers
    shared_attn_every: int = 0  # zamba2: shared attn block every k layers
    cross_attn_every: int = 0  # vlm: cross block every k layers (pattern helper)
    n_enc_tokens: int = 0  # stub encoder sequence length (vlm/audio cond)
    embed_inputs: bool = True  # False: train/prefill consume embeddings (stub frontend)

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "float32"  # compute dtype
    param_dtype: str = "float32"

    # annotations
    family: str = "dense"  # dense|moe|ssm|hybrid|audio|vlm
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived -------------------------------------------------------
    @property
    def layer_kinds(self) -> tuple:
        kinds = ["dense"] * self.first_k_dense
        for i in range(self.n_layers - self.first_k_dense):
            kinds.append(self.block_pattern[i % len(self.block_pattern)])
        return tuple(kinds)

    @property
    def attention_free(self) -> bool:
        return all(k in ("mamba2", "rwkv6") for k in self.layer_kinds) and not self.shared_attn_every

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state does not grow quadratically (SSM / hybrid)."""
        return any(k in ("mamba2", "rwkv6") for k in self.layer_kinds)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d  # lm head
        for kind in self.layer_kinds:
            total += self._block_params(kind)
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        d, V = self.d_model, self.vocab_size
        total = V * d + (0 if self.tie_embeddings else V * d) + d
        for kind in self.layer_kinds:
            total += self._block_params(kind, active=True)
        return total

    def _block_params(self, kind: str, active: bool = False) -> int:
        d, ff = self.d_model, self.d_ff
        hd = self.head_dim
        if kind == "dense":
            return self._attn_params() + 3 * d * ff + 2 * d
        if kind == "cross":
            return self._attn_params() + 3 * d * ff + 2 * d
        if kind == "moe":
            eff = self.moe_d_ff or ff
            n_routed = self.moe_top_k if active else self.n_experts
            gate = d * self.n_experts
            shared = self.n_shared_experts * 3 * d * eff
            return self._attn_params() + gate + shared + n_routed * 3 * d * eff + 2 * d
        if kind == "mamba2":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_groups * self.ssm_state
            return (
                d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + nheads)
                + conv_dim * self.ssm_conv
                + d_in * d
                + 2 * nheads
                + d
            )
        if kind == "rwkv6":
            # time-mix: r,k,v,g,o projections + decay/bonus; channel-mix: 2 mats
            return 5 * d * d + 2 * d + d * ff + ff * d + 2 * d
        raise ValueError(kind)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.attn_kind == "mla":
            qk = self.nope_head_dim + self.rope_head_dim
            return (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * qk
                + d * (self.kv_lora_rank + self.rope_head_dim)
                + self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        if self.attn_kind == "none" or self.n_heads == 0:
            return 0
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d


# -----------------------------------------------------------------------------
# Arbitrary-TP padding (paper §4 "Enabling arbitrary tensor parallelism").
# -----------------------------------------------------------------------------


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else x


def resolve_for_tp(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Zero-pad head counts and ff widths so that every product splits over
    ``tp`` ranks (``repro.configs.base.resolve_for_tp``, field for field).

    Padded heads and ff columns are zero (``models/padding.py``), so the
    padded model computes the unpadded one's function.  For GQA the padded
    query-head count stays a multiple of the KV-head count: either each KV
    group widens (heads -> a multiple of lcm(tp, kv)) or the KV heads widen
    at a fixed group size; the one with fewer query heads is taken, and a
    tie keeps the KV heads (and so the cache) as they are."""
    if tp <= 1:
        return cfg
    changes = {}
    if cfg.n_heads and cfg.n_heads % tp:
        if cfg.attn_kind == "mla" or cfg.n_kv_heads in (0, cfg.n_heads):
            # no grouping reshape (MLA / MHA): pad both together
            hq = _pad_to(cfg.n_heads, tp)
            changes["n_heads"] = hq
            if cfg.n_kv_heads == cfg.n_heads:
                changes["n_kv_heads"] = hq
        else:
            g = cfg.n_heads // cfg.n_kv_heads
            cand_a = _pad_to(cfg.n_heads, math.lcm(tp, cfg.n_kv_heads))
            hkv_b = _pad_to(cfg.n_kv_heads, tp)
            cand_b = g * hkv_b
            if cand_b < cand_a:
                changes["n_heads"], changes["n_kv_heads"] = cand_b, hkv_b
            else:
                changes["n_heads"] = cand_a
    if cfg.d_ff % tp:
        changes["d_ff"] = _pad_to(cfg.d_ff, tp)
    if cfg.moe_d_ff and cfg.moe_d_ff % tp:
        changes["moe_d_ff"] = _pad_to(cfg.moe_d_ff, tp)
    if not changes:
        return cfg
    if "n_heads" in changes and cfg.head_dim:
        changes["head_dim"] = cfg.head_dim  # keep head_dim; widen the head count only
    return replace(cfg, **changes)


PORTED = ["llama3-8b", "llama3-1b", "qwen2.5-14b", "zamba2-2.7b", "llama3-3b", "llama3-70b",
          "deepseek-coder-1.3b", "deepseek-coder-33b", "granite-20b", "rwkv6-7b",
          "mixtral-8x22b", "deepseek-moe-16b", "minicpm3-4b", "musicgen-large",
          "llama-3.2-vision-90b"]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in PORTED:
        raise KeyError(f"unknown architecture {name!r}; known: {', '.join(PORTED)}")
    mod_name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.CONFIG
