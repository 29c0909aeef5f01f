"""Decoder assembly (``repro.models.transformer``): the dense plan, the
zamba2 hybrid plan and the rwkv6 plan.

The plan, the cache layout and the block math follow the reference.  A plan
is one group: a unit of block kinds repeated U times — ``("dense",)`` for a
dense decoder, ``("mamba2",) * k + ("shared",)`` for zamba2 (a
weight-shared attention block after every k mamba2 layers), ``("rwkv6",)``
for rwkv6 (attention-free: time-mix + channel-mix).  The cache is
``{"len", "groups": [unit]}``, ``unit`` one dict per block of the unit whose
leaves stack the U repeats first: ``{"k", "v"}`` [U, B, S, Hkv, hd] for an
attention block (dense or a shared invocation, each invocation its own
rows), ``{"conv", "ssm"}`` [U, B, K-1, conv_dim] / [U, B, H, hd, N] for a
mamba2 block, ``{"sx_tm", "wkv", "sx_cm"}`` [U, B, d] / [U, B, H, hd, hd] /
[U, B, d] for an rwkv6 block.  One ``kv_move_leaves`` launch moves the rows
of every layer of every row leaf, where the Pallas grid (U, B) runs once
per leaf.  ``"len"`` is a host int: decode reads it as its start row.

Cached forwards write K/V rows into the cache in place (rows past the
committed length are dead and may be shared), but return new mamba2 and
rwkv6 state tensors and leave the input's as they were, so a caller may
keep a cache as a snapshot of its recurrent state (the chain engine does).
Other block kinds (moe, mla, cross) raise NotImplementedError: ROADMAP
queue 1, item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models.attention import attention_cached, attention_full, plan_row_writes
from repro_torch.models.common import dense_init, rms_norm

# -----------------------------------------------------------------------------
# Plans
# -----------------------------------------------------------------------------

PORTED_KINDS = ("dense", "mamba2", "shared", "rwkv6")
ATTENTION_KINDS = ("dense", "shared")  # blocks that hold K/V rows
STATE_LEAVES = {"mamba2": ("conv", "ssm"), "rwkv6": ("sx_tm", "wkv", "sx_cm")}


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


def check_plan(cfg) -> tuple:
    """(unit_def, U) of a ported plan — one group of dense, mamba2, shared
    and rwkv6 blocks, with GQA attention (or none, where the unit holds no
    attention block); raises for any other."""
    plan = build_plan(cfg)
    has_attn = any(kind in ATTENTION_KINDS for kind in plan[0][0])
    if (cfg.attn_kind not in ("gqa", "none") or (cfg.attn_kind == "none" and has_attn)
            or len(plan) != 1 or any(kind not in PORTED_KINDS for kind in plan[0][0])):
        raise NotImplementedError(
            f"{cfg.name}: only the dense, the zamba2 hybrid and the rwkv6 plans are ported, "
            f"with GQA attention (got {plan}, attn {cfg.attn_kind!r}); moe/mla/cross "
            "blocks are ROADMAP queue 1, item 9")
    return plan[0]


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded to every block."""

    mode: str  # "full" | "cached"
    make_cache: int = 0  # S_max when prefill should emit a cache
    positions: Any = None  # [B, n] absolute rope positions
    row_idx: Any = None  # [B, n] cache rows for new K/V (-1 = skip)
    row_plan: Any = None  # plan_row_writes(row_idx, S): shared by every attention layer
    attn_mask: Any = None  # [B, n, S_max] non-square mask (cached mode)
    row_start: Any = None  # int: rows are [start, start+n) for every batch row
    n_commit: Any = None  # int: chain mode, state blocks commit the first n_commit steps


# -----------------------------------------------------------------------------
# Parameters
# -----------------------------------------------------------------------------


def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


class DenseBlock(nn.Module):
    """Weights of one dense block: attention + SwiGLU MLP (also the zamba2
    model's shared attention block)."""

    def __init__(self, ln1, attn: dict, ln2, mlp: dict):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.attn = _frozen(attn)  # wq [d,Hq,hd], wk/wv [d,Hkv,hd], wo [Hq,hd,d] (+ bq/bk/bv)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.mlp = _frozen(mlp)  # wg/wu [d,ff], wd [ff,d]


class Mamba2Block(nn.Module):
    """Weights of one mamba2 block: its pre-norm and the SSD layer
    (``models/mamba2.py`` layout)."""

    def __init__(self, ln, mamba: dict):
        super().__init__()
        self.ln = nn.Parameter(ln, requires_grad=False)
        self.mamba = _frozen(mamba)


class RWKV6Block(nn.Module):
    """Weights of one rwkv6 block: the pre-norms of its time-mix and
    channel-mix, and both sub-blocks' parameters in one dict (the
    reference's ``tm``; ``models/rwkv6.py`` layout)."""

    def __init__(self, ln1, tm: dict, ln2):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.tm = _frozen(tm)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)


class SharedBlock(nn.Module):
    """One invocation of zamba2's shared block: its own input projection
    [2d, d] over concat(h, x0); the attention + MLP weights are the model's
    ``shared_attn``."""

    def __init__(self, in_w):
        super().__init__()
        self.in_w = nn.Parameter(in_w, requires_grad=False)


class DecoderLM(nn.Module):
    """Weights of a decoder: embedding, the blocks of the plan in order (U
    repeats of the unit, flattened), final norm, lm_head, and zamba2's
    shared attention block (None otherwise)."""

    def __init__(self, embed, final_norm, lm_head, layers, shared_attn=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)  # [V, d]
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)  # [d, V]
        self.layers = nn.ModuleList(layers)
        self.shared_attn = shared_attn


def init_model(cfg, seed: int, device) -> DecoderLM:
    """Seeded truncated-normal weights drawn directly on ``device`` (the
    reference's init scales; torch's generator gives other numbers than
    ``jax.random``, so parity tests convert JAX weights instead)."""
    unit_def, U = check_plan(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d, hq, hkv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def init(shape, scale=None):
        return dense_init(gen, shape, dt, device, scale)

    def const(shape, val):
        return torch.full(shape, val, dtype=dt, device=device)

    def dense_block():
        attn = {"wq": init((d, hq, hd)), "wk": init((d, hkv, hd)), "wv": init((d, hkv, hd)),
                "wo": init((hq, hd, d), scale=(hq * hd) ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=const((hq, hd), 0.0), bk=const((hkv, hd), 0.0),
                        bv=const((hkv, hd), 0.0))
        mlp = {"wg": init((d, ff)), "wu": init((d, ff)), "wd": init((ff, d))}
        return DenseBlock(const((d,), 1.0), attn, const((d,), 1.0), mlp)

    layers = []
    for _ in range(U):
        for kind in unit_def:
            if kind == "dense":
                layers.append(dense_block())
            elif kind == "mamba2":
                layers.append(Mamba2Block(const((d,), 1.0), m2.init_mamba2(cfg, gen, device)))
            elif kind == "rwkv6":
                layers.append(RWKV6Block(const((d,), 1.0), rk.init_rwkv6(cfg, gen, device),
                                         const((d,), 1.0)))
            else:
                layers.append(SharedBlock(init((2 * d, d))))
    shared = dense_block() if "shared" in unit_def else None
    return DecoderLM(init((cfg.vocab_size, d), scale=1.0), const((d,), 1.0),
                     init((d, cfg.vocab_size)), layers, shared)


def init_cache(cfg, B, S_max, dtype, device):
    unit_def, U = check_plan(cfg)

    def zeros(shape, dt=dtype):
        return torch.zeros((U,) + tuple(shape), dtype=dt, device=device)

    unit = []
    for kind in unit_def:
        if kind in STATE_LEAVES:
            init_state = m2.init_mamba_cache if kind == "mamba2" else rk.init_rwkv_cache
            one = init_state(cfg, B, dtype, device)
            unit.append({k: zeros(v.shape, v.dtype) for k, v in one.items()})
        else:  # dense or a shared invocation: K/V rows
            shape = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
            unit.append({"k": zeros(shape), "v": zeros(shape)})
    return {"len": 0, "groups": [tuple(unit)]}


# -----------------------------------------------------------------------------
# Apply
# -----------------------------------------------------------------------------


def _mlp_apply(cfg, p, x):
    B, S, d = x.shape
    h = ops.fused_swiglu(x.reshape(B * S, d), p["wg"], p["wu"])
    return (h @ p["wd"]).reshape(B, S, d)


def _attn_mlp(cfg, p: DenseBlock, h, ctx: Ctx, leaves, r: int):
    """Attention + SwiGLU sub-blocks with pre-norms, on the K/V rows of
    repeat ``r`` of ``leaves``; a prefill with ``make_cache`` fills them."""
    hn = rms_norm(h, p.ln1, cfg.norm_eps)
    if ctx.mode == "cached":
        a, _, _ = attention_cached(cfg, p.attn, hn, leaves["k"][r], leaves["v"][r],
                                   ctx.row_idx, ctx.positions, ctx.attn_mask,
                                   row_start=ctx.row_start, row_plan=ctx.row_plan)
    else:
        a, (k, v) = attention_full(cfg, p.attn, hn, ctx.positions)
        if ctx.make_cache:
            n = h.shape[1]
            leaves["k"][r, :, :n] = k
            leaves["v"][r, :, :n] = v
    h = h + a
    return h + _mlp_apply(cfg, p.mlp, rms_norm(h, p.ln2, cfg.norm_eps))


def apply_model(cfg, params: DecoderLM, h, ctx: Ctx, cache=None):
    """h: [B, n, d] embedded inputs.  Returns (hidden [B, n, d], cache):
    in "cached" mode the K/V leaves of ``cache`` are written in place and
    the returned cache holds them and new mamba2 and rwkv6 state leaves; a
    prefill with ``make_cache`` returns a new cache."""
    unit_def, U = check_plan(cfg)
    B = h.shape[0]
    x0 = h  # the embeddings: input of every shared invocation
    unit = None
    if ctx.mode == "cached":
        unit = cache["groups"][0]
        S = next((leaves["k"].shape[2] for leaves in unit if "k" in leaves), None)
        if ctx.row_start is None and S is not None:  # the K/V row writes, planned once
            ctx = dataclasses.replace(ctx, row_plan=plan_row_writes(ctx.row_idx, S))
    elif ctx.make_cache:
        unit = init_cache(cfg, B, ctx.make_cache, h.dtype, h.device)["groups"][0]
    # the new state leaves of every recurrent block, one list per leaf over U
    states = {bi: {key: [] for key in STATE_LEAVES[kind]}
              for bi, kind in enumerate(unit_def) if kind in STATE_LEAVES}
    for r in range(U):
        for bi, kind in enumerate(unit_def):
            p = params.layers[r * len(unit_def) + bi]
            c = None
            if kind in STATE_LEAVES and ctx.mode == "cached":
                c = {key: unit[bi][key][r] for key in STATE_LEAVES[kind]}
            if kind == "mamba2":
                out, nc = m2.mamba2_apply(cfg, p.mamba, rms_norm(h, p.ln, cfg.norm_eps), c,
                                          ctx.n_commit)
                h = h + out
            elif kind == "rwkv6":  # the channel-mix reads its weights from the same dict
                out, nc = rk.rwkv6_time_mix(cfg, p.tm, rms_norm(h, p.ln1, cfg.norm_eps), c,
                                            ctx.n_commit)
                h = h + out
                out, nc_cm = rk.rwkv6_channel_mix(cfg, p.tm, rms_norm(h, p.ln2, cfg.norm_eps), c,
                                                  ctx.n_commit)
                h = h + out
                nc = {**nc, **nc_cm}
            elif kind == "dense":
                h = _attn_mlp(cfg, p, h, ctx, None if unit is None else unit[bi], r)
            else:  # shared: the model's attention + MLP on concat(h, x0) @ in_w
                inp = torch.cat([h, x0], dim=-1) @ p.in_w
                h = h + _attn_mlp(cfg, params.shared_attn, inp, ctx,
                                 None if unit is None else unit[bi], r)
            if bi in states:
                for key, leaf in states[bi].items():
                    leaf.append(nc[key])
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    if unit is None:
        return h, None
    unit = tuple({key: torch.stack(leaf) for key, leaf in states[bi].items()}
                 if bi in states else leaves for bi, leaves in enumerate(unit))
    return h, {"len": None, "groups": [unit]}  # len managed by the caller


def logits_from_hidden(cfg, params: DecoderLM, h):
    return h @ params.lm_head


def embed_tokens(cfg, params: DecoderLM, tokens):
    return params.embed[tokens.long()]
