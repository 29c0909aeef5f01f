"""Decoder assembly (``repro.models.transformer``): every plan of the
reference's configs.

The plan, the cache layout and the block math follow the reference.  A plan
is a list of groups, each a unit of block kinds repeated U times:
``[(("dense",), L)]`` for a dense decoder (GQA or MLA attention),
``[(("moe",), L)]`` for mixtral, ``[(("dense",), 1), (("moe",), L-1)]`` for
deepseek-moe (its dense first layer), ``[(("mamba2",) * k + ("shared",),
U)]`` for zamba2 (a weight-shared attention block after every k mamba2
layers), ``[(("dense",) * 4 + ("cross",), U)]`` for llama-3.2-vision (a
cross-attention block to the stub encoder states after every four) and
``[(("rwkv6",), L)]`` for rwkv6 (attention-free: time-mix + channel-mix).

The cache is ``{"len", "groups": [unit per group]}``, ``unit`` one dict per
block of the unit whose leaves stack the U repeats first: ``{"k", "v"}``
[U, B, S, Hkv, hd] for a GQA block (dense, moe, or a shared invocation,
each invocation its own rows), ``{"ckv", "krope"}`` [U, B, S, kv_lora_rank]
/ [U, B, S, rope_head_dim] for an MLA block, ``{"ek", "ev"}`` [U, B, n_enc,
Hkv, hd] for a cross block (the encoder K/V, filled by the prefill; no row
leaves), ``{"conv", "ssm"}`` [U, B, K-1, conv_dim] / [U, B, H, hd, N] for a
mamba2 block, ``{"sx_tm", "wkv", "sx_cm"}`` [U, B, d] / [U, B, H, hd, hd] /
[U, B, d] for an rwkv6 block.  One ``kv_move_leaves`` launch moves the rows
of every layer of every row leaf of every group, where the Pallas grid
(U, B) runs once per leaf.  ``"len"`` is a host int: decode reads it as its
start row.

Cached forwards write K/V and latent rows into the cache in place (rows
past the committed length are dead and may be shared), but return new
mamba2 and rwkv6 state tensors and leave the input's as they were, so a
caller may keep a cache as a snapshot of its recurrent state (the chain
engine does).

Under a tensor-parallel group a training or prefill forward may split the
residual stream's sequence over the ranks between the blocks
(``apply_model(..., seq_shard=True)``, the reference's ``seq_shard_acts``
with its "act_seq" rule): each rank holds its rows (``parallel.SeqGroup``),
runs the norms and the residual adds on them, and forms the whole
sequence only inside a block — an all-gather into the rank's heads or ff
columns, a reduce-scatter out, where the whole-sequence form has its
all-reduce — or for work every rank repeats whole (the MoE router, a
recurrent block whose heads the ranks do not divide).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.kv import ROW_KEYS
from repro_torch.kernels import ops
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rk
from repro_torch.models.attention import (
    attention_cached,
    attention_full,
    cross_attention,
    encoder_kv,
    plan_row_writes,
    prefill_attention,
)
from repro_torch.models.common import dense_init, project, rms_norm
from repro_torch.parallel.group import SeqGroup

# -----------------------------------------------------------------------------
# Plans
# -----------------------------------------------------------------------------

BLOCK_KINDS = ("dense", "moe", "cross", "mamba2", "shared", "rwkv6")
ATTENTION_KINDS = ("dense", "moe", "cross", "shared")  # blocks with an attention sub-block
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


def check_plan(cfg) -> list:
    """The plan, once every group is known to hold only block kinds of the
    reference, with attention where a block has an attention sub-block;
    raises for any other."""
    plan = build_plan(cfg)
    kinds = {kind for unit, _ in plan for kind in unit}
    if (cfg.attn_kind not in ("gqa", "mla", "none") or not kinds <= set(BLOCK_KINDS)
            or (cfg.attn_kind == "none" and kinds & set(ATTENTION_KINDS))):
        raise ValueError(f"{cfg.name}: no such plan {plan} with attention {cfg.attn_kind!r}")
    return plan


def _mla(cfg, kind: str) -> bool:
    """Whether a block of this kind attends through MLA (a cross block and
    zamba2's shared block are always GQA, as in the reference)."""
    return cfg.attn_kind == "mla" and kind in ("dense", "moe")


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
    enc: Any = None  # [B, n_enc, d] stub encoder states (cross blocks, prefill)
    tp: Any = None  # parallel.TPGroup: the weights are this rank's shards (cfg its shapes)
    moe_ep: bool = False  # with tp: the MoE's shards are of the "ep" form (else "tp")
    seq: Any = None  # parallel.SeqGroup over tp: the residual holds this rank's rows only


# -----------------------------------------------------------------------------
# Parameters
# -----------------------------------------------------------------------------


def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


class DenseBlock(nn.Module):
    """Weights of one dense block: attention + SwiGLU MLP (also a cross
    block, whose attention reads the encoder states, and the zamba2
    model's shared attention block)."""

    def __init__(self, ln1, attn: dict, ln2, mlp: dict):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        # GQA: wq [d,Hq,hd], wk/wv [d,Hkv,hd], wo [Hq,hd,d] (+ bq/bk/bv); MLA: models/mla.py
        self.attn = _frozen(attn)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.mlp = _frozen(mlp)  # wg/wu [d,ff], wd [ff,d]


class MoEBlock(nn.Module):
    """Weights of one moe block: attention + the mixture of experts —
    ``moe`` the router [d, E] and the routed experts wg/wu [E, d, ff], wd
    [E, ff, d]; ``shared`` the shared experts' wg/wu [d, S*ff], wd [S*ff, d]
    (None without any)."""

    def __init__(self, ln1, attn: dict, ln2, moe: dict, shared: dict | None):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.attn = _frozen(attn)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.moe = _frozen(moe)
        self.shared = None if shared is None else _frozen(shared)


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
    """Weights of a decoder: embedding, the blocks of the plan in order
    (each group's U repeats of its unit, flattened, group after group),
    final norm, lm_head, and zamba2's shared attention block (None
    otherwise)."""

    def __init__(self, embed, final_norm, lm_head, layers, shared_attn=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)  # [V, d]
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)  # [d, V]
        self.layers = nn.ModuleList(layers)
        self.shared_attn = shared_attn


def _keep(where, key, t):
    return t


def init_model(cfg, seed: int, device, place=None) -> DecoderLM:
    """Seeded truncated-normal weights drawn directly on ``device`` (the
    reference's init scales; torch's generator gives other numbers than
    ``jax.random``, so parity tests convert JAX weights instead).

    ``place(where, key, tensor)`` (``param_where``'s names) takes each
    tensor as soon as it is drawn and returns what the model keeps — a
    tensor-parallel rank's padded shard (``parallel.Shard.tensor``) — so a
    rank never holds more than one whole tensor; the draws, and so the
    values, are the same with or without it.  The MoE's, MLA's and the
    recurrent blocks' dicts are placed once drawn whole."""
    plan = check_plan(cfg)
    place = place or _keep
    # meta (the dry run) draws nothing: a meta tensor has a shape and no values
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d, hq, hkv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def init(where, key, shape, scale=None):
        return place(where, key, dense_init(gen, shape, dt, device, scale))

    def const(where, key, shape, val):
        return place(where, key, torch.full(shape, val, dtype=dt, device=device))

    def placed(where, tensors):
        return {k: place(where, k, v) for k, v in tensors.items()}

    def attention(kind):
        if _mla(cfg, kind):
            return placed("attn", mla_mod.init_mla(cfg, gen, device, dt))
        attn = {"wq": init("attn", "wq", (d, hq, hd)), "wk": init("attn", "wk", (d, hkv, hd)),
                "wv": init("attn", "wv", (d, hkv, hd)),
                "wo": init("attn", "wo", (hq, hd, d), scale=(hq * hd) ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=const("attn", "bq", (hq, hd), 0.0),
                        bk=const("attn", "bk", (hkv, hd), 0.0),
                        bv=const("attn", "bv", (hkv, hd), 0.0))
        return attn

    def block(kind):
        attn = attention(kind)
        if kind == "moe":
            routed, shared = moe_mod.init_moe(cfg, gen, device, dt)
            return MoEBlock(const("block", "ln1", (d,), 1.0), attn,
                            const("block", "ln2", (d,), 1.0), placed("moe", routed),
                            None if shared is None else placed("shared", shared))
        mlp = {"wg": init("mlp", "wg", (d, ff)), "wu": init("mlp", "wu", (d, ff)),
               "wd": init("mlp", "wd", (ff, d))}
        return DenseBlock(const("block", "ln1", (d,), 1.0), attn,
                          const("block", "ln2", (d,), 1.0), mlp)

    layers = []
    for unit_def, U in plan:
        for _ in range(U):
            for kind in unit_def:
                if kind in ("dense", "moe", "cross"):
                    layers.append(block(kind))
                elif kind == "mamba2":
                    layers.append(Mamba2Block(const("block", "ln", (d,), 1.0),
                                              placed("mamba", m2.init_mamba2(cfg, gen, device))))
                elif kind == "rwkv6":
                    layers.append(RWKV6Block(const("block", "ln1", (d,), 1.0),
                                             placed("tm", rk.init_rwkv6(cfg, gen, device)),
                                             const("block", "ln2", (d,), 1.0)))
                else:
                    layers.append(SharedBlock(init("block", "in_w", (2 * d, d))))
    has_shared = any("shared" in unit for unit, _ in plan)
    shared = block("shared") if has_shared else None
    return DecoderLM(init("model", "embed", (cfg.vocab_size, d), scale=1.0),
                     const("model", "final_norm", (d,), 1.0),
                     init("model", "lm_head", (d, cfg.vocab_size)), layers, shared)


_WHERE = ("attn", "mlp", "moe", "shared", "mamba", "tm")


def param_where(name: str) -> tuple[str, str]:
    """(where, key) of the parameter ``name`` of a ``DecoderLM``: where is
    the ParameterDict that holds it (attn, mlp, moe, shared — a MoE block's
    shared experts —, mamba, tm), "block" for a block's own tensors
    (norms, zamba2's ``in_w``) and "model" for the model's."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] in _WHERE:
        return parts[-2], parts[-1]
    return ("block" if parts[0] in ("layers", "shared_attn") else "model"), parts[-1]


def map_named_params(params: DecoderLM, fn) -> DecoderLM:
    """A ``DecoderLM`` of the same structure whose every parameter is
    ``fn(name, tensor)`` of ``params``', with the same ``requires_grad``; no
    tensor of ``params`` is copied as a whole."""
    memo = {}
    for name, p in params.named_parameters():
        memo[id(p)] = nn.Parameter(fn(name, p.detach()), requires_grad=p.requires_grad)
    return copy.deepcopy(params, memo)


def map_params(params: DecoderLM, fn) -> DecoderLM:
    """``map_named_params`` with ``fn(where, key, tensor)`` (``param_where``)."""
    return map_named_params(params, lambda name, t: fn(*param_where(name), t))


def _block_cache(cfg, kind, B, S_max, dtype, device) -> dict:
    """One block's cache leaves, without the U axis."""
    if kind in STATE_LEAVES:
        init_state = m2.init_mamba_cache if kind == "mamba2" else rk.init_rwkv_cache
        return init_state(cfg, B, dtype, device)
    if _mla(cfg, kind):
        return {"ckv": torch.zeros((B, S_max, cfg.kv_lora_rank), dtype=dtype, device=device),
                "krope": torch.zeros((B, S_max, cfg.rope_head_dim), dtype=dtype, device=device)}
    if kind == "cross":
        shape = (B, cfg.n_enc_tokens, cfg.n_kv_heads, cfg.head_dim)
        return {"ek": torch.zeros(shape, dtype=dtype, device=device),
                "ev": torch.zeros(shape, dtype=dtype, device=device)}
    shape = (B, S_max, cfg.n_kv_heads, cfg.head_dim)  # dense, moe or a shared invocation
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg, B, S_max, dtype, device):
    groups = []
    for unit_def, U in check_plan(cfg):
        unit = []
        for kind in unit_def:
            one = _block_cache(cfg, kind, B, S_max, dtype, device)
            unit.append({k: torch.zeros((U,) + tuple(v.shape), dtype=v.dtype, device=device)
                         for k, v in one.items()})
        groups.append(tuple(unit))
    return {"len": 0, "groups": groups}


# -----------------------------------------------------------------------------
# Apply
# -----------------------------------------------------------------------------


def _mlp_apply(cfg, p, x):
    B, S, d = x.shape
    h = ops.fused_swiglu(x.reshape(B * S, d), p["wg"], p["wu"])
    return project(h, p["wd"]).reshape(B, S, d)


def _io(ctx: Ctx):
    """The group through which the residual stream enters and leaves
    rank-local work: ``ctx.seq`` when it is sequence-sharded, else
    ``ctx.tp`` (None without a group)."""
    return ctx.tp if ctx.seq is None else ctx.seq


def _reduce(ctx: Ctx, partial):
    """A row-split product's partial sum back onto the residual: summed over
    the tensor-parallel ranks (reduce-scattered to this rank's rows when the
    stream is sequence-sharded; the identity without a group)."""
    io = _io(ctx)
    return partial if io is None else io.reduce(partial)


def _copy(ctx: Ctx, x):
    """The residual stream entering rank-local work: itself (all-gathered
    when sequence-sharded), its gradient summed over the ranks (the
    identity without a group)."""
    io = _io(ctx)
    return x if io is None else io.copy(x)


def _whole(ctx: Ctx, x):
    """The residual stream entering work that every rank repeats whole: the
    whole sequence (``SeqGroup.gather``), or ``x`` itself."""
    return x if ctx.seq is None else ctx.seq.gather(x)


def _own(ctx: Ctx, y):
    """The whole result of such work back onto this rank's rows
    (``SeqGroup.split``), or ``y`` itself."""
    return y if ctx.seq is None else ctx.seq.split(y)


def seq_group(tp, n: int):
    """The ``parallel.SeqGroup`` of a sequence of ``n`` rows split over
    ``tp``'s ranks; None without a group (one rank holds every row)."""
    return None if tp is None else SeqGroup(tp, n)


def _attn_apply(cfg, kind, p, hn, ctx: Ctx, leaves, r: int):
    """The attention sub-block of a block of ``kind`` on its normed input,
    with the cache rows (or encoder K/V) of repeat ``r`` of ``leaves``; a
    prefill with ``make_cache`` fills them."""
    full = ctx.mode != "cached"
    fill = full and ctx.make_cache
    if kind == "cross":
        if full:
            if ctx.enc is None:
                raise ValueError(f"{cfg.name}: a cross block needs the encoder states (enc)")
            ek, ev = encoder_kv(p, ctx.enc if ctx.tp is None else ctx.tp.copy(ctx.enc))
            if fill:
                leaves["ek"][r] = ek
                leaves["ev"][r] = ev
        else:
            ek, ev = leaves["ek"][r], leaves["ev"][r]
        return cross_attention(p, hn, ek, ev)
    n = hn.shape[1]
    if _mla(cfg, kind):
        if full and not (torch.is_grad_enabled() and hn.requires_grad):
            # serving: absorbed, through the kernel the verify and the decode attend with
            cache = (leaves["ckv"][r], leaves["krope"][r]) if fill else None
            return mla_mod.mla_prefill(cfg, p, hn, ctx.positions, cache, tp=ctx.tp)[0]
        if full:
            a, (ckv, krope) = mla_mod.mla_full(cfg, p, hn, ctx.positions, tp=ctx.tp)
            if fill:
                leaves["ckv"][r, :, :n] = ckv
                leaves["krope"][r, :, :n] = krope
            return a
        return mla_mod.mla_cached(cfg, p, hn, leaves["ckv"][r], leaves["krope"][r], ctx.row_idx,
                                  ctx.positions, ctx.attn_mask, row_start=ctx.row_start,
                                  row_plan=ctx.row_plan, tp=ctx.tp)[0]
    if full:
        if fill and not (torch.is_grad_enabled() and hn.requires_grad):
            # the kernel the verify and the decode attend with (it has no backward)
            return prefill_attention(cfg, p, hn, ctx.positions, leaves["k"][r], leaves["v"][r])
        a, (k, v) = attention_full(cfg, p, hn, ctx.positions)
        if fill:
            leaves["k"][r, :, :n] = k
            leaves["v"][r, :, :n] = v
        return a
    return attention_cached(cfg, p, hn, leaves["k"][r], leaves["v"][r], ctx.row_idx,
                            ctx.positions, ctx.attn_mask, row_start=ctx.row_start,
                            row_plan=ctx.row_plan)[0]


def _attn_mlp(cfg, kind, p, h, ctx: Ctx, leaves, r: int):
    """A block with an attention sub-block and an MLP (SwiGLU, or the
    mixture of experts of a moe block), both with pre-norms.  Under a group
    the normed input of a GQA attention and of the dense MLP is copied into
    their rank-local work (``_copy``), which attends head-parallel on the
    whole sequence; MLA's input is whole (its down projections are whole on
    every rank, and it places its own copies), and the MoE places its own."""
    hn = rms_norm(h, p.ln1, cfg.norm_eps)
    hn = _whole(ctx, hn) if _mla(cfg, kind) else _copy(ctx, hn)
    h = h + _reduce(ctx, _attn_apply(cfg, kind, p.attn, hn, ctx, leaves, r))
    hn = rms_norm(h, p.ln2, cfg.norm_eps)
    if kind == "moe":
        return h + moe_mod.moe_apply(cfg, p.moe, p.shared, hn, tp=ctx.tp, ep=ctx.moe_ep,
                                     seq=ctx.seq)
    return h + _reduce(ctx, _mlp_apply(cfg, p.mlp, _copy(ctx, hn)))


def _row_leaves_len(groups):
    """S of the first row leaf of a cache's groups (None without any)."""
    for unit in groups:
        for leaves in unit:
            for key in ROW_KEYS:
                if key in leaves:
                    return leaves[key].shape[2]
    return None


REMAT = ("none", "full")


def _recurrent(ctx: Ctx, heads_io, fn, x):
    """``fn(x, tp)`` of a recurrent sub-block on its normed input: with its
    heads split, ``heads_io`` (``_io``) enters and leaves their rank-local
    work; with every head on every rank, the block runs whole — on the whole
    sequence, this rank's rows taken after, when the stream is
    sequence-sharded.  -> (out, new state)."""
    if heads_io is not None or ctx.seq is None:
        return fn(x, heads_io)
    out, nc = fn(_whole(ctx, x), None)
    return _own(ctx, out), nc


def _apply_block(cfg, kind, params: DecoderLM, p, h, x0, ctx: Ctx, leaves, r: int, heads_io):
    """One block of ``kind`` (weights ``p``) on the residual ``h``; returns
    (h, its new state leaves — None for a block without state or outside
    the cached mode)."""
    c = nc = None
    if kind in STATE_LEAVES and ctx.mode == "cached":
        c = {key: leaves[key][r] for key in STATE_LEAVES[kind]}
    if kind == "mamba2":
        out, nc = _recurrent(ctx, heads_io, lambda x, tp: m2.mamba2_apply(
            cfg, p.mamba, x, c, ctx.n_commit, tp=tp), rms_norm(h, p.ln, cfg.norm_eps))
        h = h + out
    elif kind == "rwkv6":  # the channel-mix reads its weights from the same dict
        out, nc = _recurrent(ctx, heads_io, lambda x, tp: rk.rwkv6_time_mix(
            cfg, p.tm, x, c, ctx.n_commit, tp=tp), rms_norm(h, p.ln1, cfg.norm_eps))
        h = h + out
        out, nc_cm = rk.rwkv6_channel_mix(cfg, p.tm, rms_norm(h, p.ln2, cfg.norm_eps),
                                          c, ctx.n_commit, tp=ctx.tp, seq=ctx.seq)
        h = h + out
        nc = {**nc, **nc_cm}
    elif kind == "shared":  # the model's attention + MLP on concat(h, x0) @ in_w
        inp = project(torch.cat([h, x0], dim=-1), p.in_w)
        h = h + _attn_mlp(cfg, "shared", params.shared_attn, inp, ctx, leaves, r)
    else:  # dense, moe, cross
        h = _attn_mlp(cfg, kind, p, h, ctx, leaves, r)
    return h, nc


def apply_model(cfg, params: DecoderLM, h, ctx: Ctx, cache=None, remat: str = "none",
                seq_shard: bool = False):
    """h: [B, n, d] embedded inputs.  Returns (hidden [B, n, d], cache):
    in "cached" mode the row leaves of ``cache`` are written in place and
    the returned cache holds them, the cross blocks' encoder K/V as they
    were, and new mamba2 and rwkv6 state leaves; a prefill with
    ``make_cache`` returns a new cache.

    ``remat="full"`` (a forward without a cache: training) runs each unit
    of the plan — one repeat of its group's blocks — under
    ``torch.utils.checkpoint``, as the reference checkpoints each scanned
    unit: the backward recomputes the unit's forward, collectives
    included, and keeps only the residual between units.

    ``seq_shard`` (a forward without a cache or a prefill, under
    ``ctx.tp``): the residual stream between the blocks, the residual that
    ``remat="full"`` keeps included, holds this rank's rows only, and ``h``
    is this rank's rows of the n = ``ctx.positions.shape[1]`` embedded rows
    (``embed_tokens``, or ``SeqGroup.split``, with ``seq_group(ctx.tp,
    n)``).  The hidden returned is whole, the final norm run on the rows
    then gathered; the cache is the whole-sequence forward's.  Without a
    group it is the plain forward.  The cached forwards (a few new rows
    each) raise."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "full" and (ctx.mode == "cached" or ctx.make_cache):
        raise ValueError("remat='full' recomputes the forward: no cache may be written")
    if seq_shard and ctx.mode == "cached":
        raise ValueError("seq_shard splits a whole sequence over the ranks: a cached forward "
                         "has none")
    if seq_shard:
        ctx = dataclasses.replace(ctx, seq=seq_group(ctx.tp, ctx.positions.shape[1]))
    plan = check_plan(cfg)
    B = h.shape[0]
    x0 = h  # the embeddings: input of every shared invocation
    groups = None
    if ctx.mode == "cached":
        groups = cache["groups"]
        S = _row_leaves_len(groups)
        if ctx.row_start is None and S is not None:  # the row writes, planned once
            ctx = dataclasses.replace(ctx, row_plan=plan_row_writes(ctx.row_idx, S))
    elif ctx.make_cache:
        groups = init_cache(cfg, B, ctx.make_cache, h.dtype, h.device)["groups"]
    new_groups = []
    # the group the recurrent blocks' heads are split over (None: whole on this rank)
    heads_io = _io(ctx) if getattr(cfg, "ssm_heads", 0) else None
    li = 0  # index of the next layer in params.layers
    for gi, (unit_def, U) in enumerate(plan):
        unit = None if groups is None else groups[gi]
        # the new state leaves of every recurrent block, one list per leaf over U
        states = {bi: {key: [] for key in STATE_LEAVES[kind]}
                  for bi, kind in enumerate(unit_def) if kind in STATE_LEAVES}

        def run_unit(h, r, li, unit_def=unit_def, unit=unit):
            ncs = []
            for bi, kind in enumerate(unit_def):
                h, nc = _apply_block(cfg, kind, params, params.layers[li + bi], h, x0, ctx,
                                     None if unit is None else unit[bi], r, heads_io)
                ncs.append(nc)
            return h, ncs

        for r in range(U):
            if remat == "full":
                # the backward recomputes it later: bind this group's run_unit now
                h = checkpoint(lambda h, r=r, li=li, f=run_unit: f(h, r, li)[0], h,
                               use_reentrant=False)
            else:
                h, ncs = run_unit(h, r, li)
                for bi in states:
                    for key, leaf in states[bi].items():
                        leaf.append(ncs[bi][key])
            li += len(unit_def)
        if unit is not None:
            new_groups.append(tuple(
                {key: torch.stack(leaf) for key, leaf in states[bi].items()}
                if bi in states else leaves for bi, leaves in enumerate(unit)))
    h = _whole(ctx, rms_norm(h, params.final_norm, cfg.norm_eps))
    if groups is None:
        return h, None
    return h, {"len": None, "groups": new_groups}  # len managed by the caller


def logits_from_hidden(cfg, params: DecoderLM, h, vocab_tp=None):
    """h @ lm_head; with ``vocab_tp`` (the group lm_head's vocabulary is
    split over) every rank's columns are gathered, so each rank holds the
    whole [B, n, V]."""
    if vocab_tp is None:
        return project(h, params.lm_head)
    return vocab_tp.gather(project(vocab_tp.copy(h), params.lm_head), dim=-1)


def embed_tokens(cfg, params: DecoderLM, tokens, vocab_tp=None, seq=None):
    """The embedding rows of ``tokens``; with ``vocab_tp`` (the group the
    table's vocabulary is split over; ``cfg`` the rank's, its
    ``vocab_size`` the rank's rows) each rank looks up the ids in its
    range, zeros elsewhere, and the sum over the ranks is the row (exactly:
    one term is not zero).  With ``seq`` (a ``parallel.SeqGroup``) this
    rank's rows of the sequence only: the sum reduce-scattered, or the
    whole table's rows split."""
    ids = tokens.long()
    if vocab_tp is None:
        rows = params.embed[ids]
        return rows if seq is None else seq.split(rows)
    V_loc = cfg.vocab_size
    local = ids - vocab_tp.rank * V_loc
    mine = (local >= 0) & (local < V_loc)
    rows = params.embed[local.clamp(0, V_loc - 1)]
    part = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return vocab_tp.reduce(part) if seq is None else seq.reduce(part)
