"""Decoder assembly (``repro.models.transformer``), dense plan only.

The plan, the cache layout and the block math follow the reference.  The
cache is ``{"len", "groups": [({"k", "v"},)]}`` with stacked leaves
``[U, B, S, Hkv, hd]`` (U = layers of the group), so one ``kv_move_rows``
launch moves the rows of every layer, as the Pallas grid (U, B) does.
``"len"`` is a host int here: the engine keeps per-row lengths in the tree,
and decode reads it as its start row.  Other block kinds (moe, mla,
mamba2, rwkv6, cross, shared) raise NotImplementedError: they are ROADMAP
queue 1, item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.attention import attention_cached, attention_full
from repro_torch.models.common import dense_init, rms_norm

# -----------------------------------------------------------------------------
# Plans
# -----------------------------------------------------------------------------


def build_plan(cfg):
    """Returns list of (unit_def: tuple[str], n_reps: int)."""
    plan = []
    first_k = getattr(cfg, "first_k_dense", 0)
    n_main = cfg.n_layers - first_k
    if first_k:
        plan.append((("dense",), first_k))
    if cfg.shared_attn_every:
        k = cfg.shared_attn_every
        assert n_main % k == 0, (cfg.name, n_main, k)
        plan.append((tuple(cfg.block_pattern) * k + ("shared",), n_main // k))
    else:
        pat = tuple(cfg.block_pattern)
        assert n_main % len(pat) == 0, (cfg.name, n_main, pat)
        plan.append((pat, n_main // len(pat)))
    return plan


def check_dense(cfg) -> int:
    """The number of layers of a dense-only plan; raises for any other."""
    plan = build_plan(cfg)
    if (cfg.attn_kind != "gqa" or len(plan) != 1 or plan[0][0] != ("dense",)):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA plan is ported (got {plan}, attn "
            f"{cfg.attn_kind!r}); moe/mla/mamba2/rwkv6/cross/shared blocks are "
            "ROADMAP queue 1, item 9")
    return plan[0][1]


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded to every block."""

    mode: str  # "full" | "cached"
    make_cache: int = 0  # S_max when prefill should emit a cache
    positions: Any = None  # [B, n] absolute rope positions
    row_idx: Any = None  # [B, n] cache rows for new K/V (-1 = skip)
    attn_mask: Any = None  # [B, n, S_max] non-square mask (cached mode)
    row_start: Any = None  # int: rows are [start, start+n) for every batch row


# -----------------------------------------------------------------------------
# Parameters
# -----------------------------------------------------------------------------


def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


class DenseBlock(nn.Module):
    """Weights of one dense block: attention + SwiGLU MLP."""

    def __init__(self, ln1, attn: dict, ln2, mlp: dict):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.attn = _frozen(attn)  # wq [d,Hq,hd], wk/wv [d,Hkv,hd], wo [Hq,hd,d] (+ bq/bk/bv)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.mlp = _frozen(mlp)  # wg/wu [d,ff], wd [ff,d]


class DenseLM(nn.Module):
    """Weights of a dense decoder: embedding, blocks, final norm, lm_head."""

    def __init__(self, embed, final_norm, lm_head, layers):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)  # [V, d]
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)  # [d, V]
        self.layers = nn.ModuleList(layers)


def init_model(cfg, seed: int, device) -> DenseLM:
    """Seeded truncated-normal weights drawn directly on ``device`` (the
    reference's init scales; torch's generator gives other numbers than
    ``jax.random``, so parity tests convert JAX weights instead)."""
    n_layers = check_dense(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d, hq, hkv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def init(shape, scale=None):
        return dense_init(gen, shape, dt, device, scale)

    def const(shape, val):
        return torch.full(shape, val, dtype=dt, device=device)

    layers = []
    for _ in range(n_layers):
        attn = {"wq": init((d, hq, hd)), "wk": init((d, hkv, hd)), "wv": init((d, hkv, hd)),
                "wo": init((hq, hd, d), scale=(hq * hd) ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=const((hq, hd), 0.0), bk=const((hkv, hd), 0.0),
                        bv=const((hkv, hd), 0.0))
        mlp = {"wg": init((d, ff)), "wu": init((d, ff)), "wd": init((ff, d))}
        layers.append(DenseBlock(const((d,), 1.0), attn, const((d,), 1.0), mlp))
    return DenseLM(init((cfg.vocab_size, d), scale=1.0), const((d,), 1.0),
                   init((d, cfg.vocab_size)), layers)


def init_cache(cfg, B, S_max, dtype, device):
    U = check_dense(cfg)
    shape = (U, B, S_max, cfg.n_kv_heads, cfg.head_dim)
    leaves = {"k": torch.zeros(shape, dtype=dtype, device=device),
              "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"len": 0, "groups": [(leaves,)]}


# -----------------------------------------------------------------------------
# Apply
# -----------------------------------------------------------------------------


def _mlp_apply(cfg, p, x):
    B, S, d = x.shape
    h = ops.fused_swiglu(x.reshape(B * S, d), p["wg"], p["wu"])
    return (h @ p["wd"]).reshape(B, S, d)


def apply_model(cfg, params: DenseLM, h, ctx: Ctx, cache=None):
    """h: [B, n, d] embedded inputs.  Returns (hidden [B, n, d], cache):
    in "cached" mode ``cache`` is updated in place; a prefill with
    ``make_cache`` returns a new one."""
    check_dense(cfg)
    B, n, _ = h.shape
    if ctx.mode == "cached":
        leaves = cache["groups"][0][0]
    elif ctx.make_cache:
        leaves = init_cache(cfg, B, ctx.make_cache, h.dtype, h.device)["groups"][0][0]
    for u, p in enumerate(params.layers):
        hn = rms_norm(h, p.ln1, cfg.norm_eps)
        if ctx.mode == "cached":
            a, _, _ = attention_cached(cfg, p.attn, hn, leaves["k"][u], leaves["v"][u],
                                       ctx.row_idx, ctx.positions, ctx.attn_mask,
                                       row_start=ctx.row_start)
        else:
            a, (k, v) = attention_full(cfg, p.attn, hn, ctx.positions)
            if ctx.make_cache:
                leaves["k"][u, :, :n] = k
                leaves["v"][u, :, :n] = v
        h = h + a
        h = h + _mlp_apply(cfg, p.mlp, rms_norm(h, p.ln2, cfg.norm_eps))
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    if ctx.mode == "cached" or ctx.make_cache:
        return h, {"len": None, "groups": [(leaves,)]}  # len managed by the caller
    return h, None


def logits_from_hidden(cfg, params: DenseLM, h):
    return h @ params.lm_head


def embed_tokens(cfg, params: DenseLM, tokens):
    return params.embed[tokens.long()]
