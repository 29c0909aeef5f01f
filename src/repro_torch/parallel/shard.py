"""Tensor-parallel shards of the port's weights.

``Shard(cfg, rank, world)`` is one rank's view of a model of ``cfg``
sharded over ``world`` ranks: the config padded by
``configs.resolve_for_tp``, the per-rank config its forward runs at
(``local_cfg``), and ``tensor(where, key, t)``, which pads one tensor of the
unpadded model (``models.padding.pad_tensor``) and keeps this rank's part
of it as a contiguous tensor of its own (16-byte aligned, so that the
kernels take it as it is and nothing keeps the whole tensor alive).

What a rank keeps, by ``rules.spec_for`` over the mesh {"model": world}:

* ``wg``/``wu`` split by ff columns and ``wd`` by its rows (the dense MLP
  and, in the "tp" MoE form, every expert's ff); the "ep" form splits the
  routed experts instead.  A rank's share of the dense MLP is zero-padded
  to a multiple of ``FF_ALIGN`` (zero columns of wg/wu, zero rows of wd:
  exact, as ``resolve_for_tp``'s own padding is), so that ``fused_swiglu``
  streams its rows in 16-byte copies (at an odd width a bf16 row goes by
  byte loads, ROADMAP R7).  The router, the norms and a MoE block's shared
  experts are whole on every rank.
* ``embed`` and ``lm_head`` split by vocabulary where the ranks divide it
  (a masked lookup and an all-reduce, the logits gathered), else whole.
* Attention by heads, in the layout of ``attn_layout``: where the ranks
  divide the KV heads, each rank its contiguous query heads and their KV
  heads (spec_for's split).  Where they do not, the reference replicates
  wk/wv; here a rank keeps only the KV heads its query heads read, and pads
  its query heads to whole groups with zero heads (zero ``wq`` columns and
  ``wo`` rows), so that every rank runs the kernels' uniform grouping G =
  Hq/Hkv, and its cache holds those KV heads only.  A cross block's
  encoder K/V hold the rank's KV heads the same way, and zamba2's shared
  block splits as a dense block does (its per-invocation ``in_w`` whole).
* MLA by heads: ``w_uq``/``w_uk``/``w_uv`` and ``wo``; the down
  projections and their norms whole, and every rank keeps the whole
  latent cache (``ckv``/``krope`` have no heads; the reference splits its
  sequence axis instead, an accepted difference).
* The recurrent blocks by heads where the ranks divide them
  (``ssm_heads``; ``models/mamba2.py`` and ``models/rwkv6.py`` say what a
  rank keeps, and sum what spans its heads), else whole on every rank, as
  the reference's ``spec_for`` falls back; rwkv6's channel-mix ff by
  columns of ``cm_k`` and rows of ``cm_v`` (its share padded as the dense
  MLP's), ``cm_r`` whole.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, resolve_for_tp
from repro_torch.models import mamba2 as m2
from repro_torch.models.axes import weight_axes
from repro_torch.models.padding import pad_tensor
from repro_torch.models.transformer import DecoderLM, map_named_params, map_params, param_where
from repro_torch.parallel.rules import model_dim

_Q_KEYS = ("wq", "bq", "wo")
_KV_KEYS = ("wk", "wv", "bk", "bv")
FF_ALIGN = 8  # a rank's dense-MLP width is a multiple of this: 16-byte rows in bf16
# the ff-split tensors whose share is padded to FF_ALIGN: the dense MLP's (zamba2's shared
# block's too) and rwkv6's channel-mix
_FF_PADDED = {("mlp", "wg"), ("mlp", "wu"), ("mlp", "wd"), ("tm", "cm_k"), ("tm", "cm_v")}
_RECURRENT = ("mamba", "tm")  # where the recurrent blocks' tensors sit (param_where)
# the whole tensors a sequence-sharded forward reads on each rank's own rows only (by where, or
# (where, key)): every block's own tensors (the norms, zamba2's in_w), the final norm, a MoE
# block's shared experts, rwkv6's channel-mix gate
_ROW_LOCAL = {"block", "shared", ("model", "final_norm"), ("tm", "cm_r"), ("tm", "mu_cm")}


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """One rank's config (``Shard.local_cfg``): the padded config at the
    rank's shapes, and ``ssm_heads``, the rank's heads of the recurrent
    blocks (0: all of them), from which their widths follow."""

    ssm_heads: int = 0


def attn_layout(n_heads: int, n_kv_heads: int, rank: int, world: int) -> tuple[tuple, tuple]:
    """(q_src, kv_src) of rank ``rank``: the global query head of each local
    query slot (-1 for a zero head) and the global KV head of each local KV
    slot.  The rank owns query heads [rank·Hq/world, (rank+1)·Hq/world); it
    keeps every KV head they read and, for each, the g = Hq/Hkv slots of its
    group, holding the owned heads at their place in the group and zero
    heads elsewhere.  Where world divides Hkv the groups are whole and this
    is the contiguous split."""
    if world == 1:
        return tuple(range(n_heads)), tuple(range(n_kv_heads))
    if n_heads % world:
        raise ValueError(f"{n_heads} query heads do not split over {world} ranks "
                         "(configs.resolve_for_tp pads them)")
    g, per = n_heads // n_kv_heads, n_heads // world
    own = range(rank * per, (rank + 1) * per)
    kv_src = tuple(sorted({q // g for q in own}))
    q_src = tuple(k * g + j if k * g + j in own else -1 for k in kv_src for j in range(g))
    return q_src, kv_src


@dataclasses.dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``world`` of a model of ``cfg`` (unpadded);
    ``moe_form`` "tp" or "ep" (taken only where world divides E)."""

    cfg: Any
    rank: int
    world: int
    moe_form: str = "tp"

    def __post_init__(self):
        if self.moe_form not in ("tp", "ep"):
            raise ValueError(f"moe_form must be 'tp' or 'ep', got {self.moe_form!r}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a group of {self.world}")

    @functools.cached_property
    def padded(self):
        return resolve_for_tp(self.cfg, self.world)

    @property
    def ep(self) -> bool:
        E = self.cfg.n_experts
        return self.moe_form == "ep" and E > 0 and E % self.world == 0

    @functools.cached_property
    def attn(self) -> tuple[tuple, tuple]:
        c = self.padded
        return attn_layout(c.n_heads, c.n_kv_heads, self.rank, self.world)

    @functools.cached_property
    def ff(self) -> int:
        """This rank's dense-MLP width: its share of the padded d_ff, rounded
        up to a multiple of ``FF_ALIGN`` when the ranks split it."""
        share = self.padded.d_ff // self.world
        return share if self.world == 1 else -(-share // FF_ALIGN) * FF_ALIGN

    @functools.cached_property
    def ssm_heads(self) -> int:
        """This rank's heads of the recurrent blocks, its contiguous share
        [rank·h, (rank+1)·h) of their H heads (zamba2-2.7b's 80 mamba2
        heads: 40 at tp 2; rwkv6-7b's 64: 32 at tp 2); 0 where every rank
        holds all of them: one rank, no recurrent block, ranks that do not
        divide H (the reference's ``spec_for`` replicates "inner" then), or
        a mamba2 block of several BC groups."""
        c, kinds = self.padded, set(self.padded.layer_kinds)
        if self.world == 1 or "mamba2" in kinds and c.ssm_groups != 1:
            return 0
        if "mamba2" in kinds:
            H = c.ssm_expand * c.d_model // c.ssm_head_dim
        elif "rwkv6" in kinds:
            H = c.d_model // c.ssm_head_dim
        else:
            return 0
        return H // self.world if H % self.world == 0 else 0

    @functools.cached_property
    def vocab_split(self) -> bool:
        """Whether embed and lm_head are split by vocabulary (where the ranks
        divide it; else whole on every rank)."""
        c = self.padded
        return self.world > 1 and model_dim({"model": self.world}, weight_axes("model", "lm_head"),
                                            (c.d_model, c.vocab_size)) is not None

    @functools.cached_property
    def local_cfg(self) -> RankConfig:
        """The padded config at this rank's shapes, which its forward and its
        cache run at: its head counts, its dense-MLP (and rwkv6 channel-mix)
        width ``ff``, its experts' width (the "tp" MoE form's share; the
        "ep" form keeps whole experts, E/world of them, and ``n_experts``
        stays E: the capacity is the whole dispatch's), its vocabulary and
        its recurrent heads ``ssm_heads``.  ``d_model`` stays whole: the
        residual stream is whole on every rank."""
        c = self.padded
        kw = dict(d_ff=self.ff, vocab_size=c.vocab_size // self.world if self.vocab_split
                  else c.vocab_size, ssm_heads=self.ssm_heads)
        if c.n_experts:
            dff = c.moe_d_ff or c.d_ff
            kw["moe_d_ff"] = dff if self.ep else dff // self.world
        if c.n_heads:
            q_src, kv_src = self.attn
            kw.update(n_heads=len(q_src), n_kv_heads=len(kv_src), head_dim=c.head_dim)
        fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
        return RankConfig(**{**fields, **kw})

    def tensor(self, where: str, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``, a tensor of the unpadded model."""
        return self.slice(where, key, pad_tensor(self.cfg, self.padded, where, key, t))

    def slice(self, where: str, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``, a tensor of the padded model."""
        fresh = dict(memory_format=torch.contiguous_format)
        if self.world == 1 or where in ("block", "shared") or (where, key) == ("moe", "router"):
            return t.clone(**fresh)
        if where == "attn" and key in _Q_KEYS + _KV_KEYS:
            src = self.attn[0] if key in _Q_KEYS else self.attn[1]
            dim = 1 if key in ("wq", "wk", "wv") else 0
            out = t.index_select(dim, torch.tensor([max(s, 0) for s in src], device=t.device))
            for slot, s in enumerate(src):
                if s < 0:
                    out.select(dim, slot).zero_()
            return out
        axes = weight_axes(where, key, "ep" if self.ep else "tp")
        if where in _RECURRENT and "ff" not in axes:
            return self._heads_part(where, key, t)
        d = model_dim({"model": self.world}, axes, t.shape)
        if d is None:
            return t.clone(**fresh)
        n = t.shape[d] // self.world
        part = t.narrow(d, self.rank * n, n)
        if (where, key) in _FF_PADDED and self.ff != n:
            out = t.new_zeros(part.shape[:d] + (self.ff,) + part.shape[d + 1:])
            out.narrow(d, 0, n).copy_(part)
            return out
        return part.clone(**fresh)

    def _segments(self, where: str, key: str) -> tuple | None:
        """(dim, ((axis, width), ...)) of a recurrent tensor of the padded
        model where the heads are split: the dimension that they split and
        its segments in order, each with its whole width (None for a plain
        "inner" dimension: all of it); None for a tensor kept whole (``cm_r``
        among them: the channel-mix gate multiplies the reduced sum)."""
        if not self.ssm_heads or (where, key) == ("tm", "cm_r"):
            return None
        for d, ax in enumerate(weight_axes(where, key)):
            if ax == "inner":
                return d, (("inner", None),)
            if isinstance(ax, tuple):  # mamba2's joined segments
                return d, tuple(zip(ax, m2.segments(self.padded)[key]))
        return None

    def _heads_part(self, where: str, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a recurrent tensor ``t`` of the padded model:
        each "inner" segment of its split dimension cut to the rank's heads,
        the other segments whole (mamba2's BC columns); the whole tensor
        where the heads are not split."""
        seg = self._segments(where, key)
        if seg is None:
            return t.clone(memory_format=torch.contiguous_format)
        d, parts, off = seg[0], [], 0
        for ax, width in seg[1]:
            width = t.shape[d] if width is None else width
            piece = t.narrow(d, off, width)
            off += width
            if ax == "inner":
                n = width // self.world
                piece = piece.narrow(d, self.rank * n, n)
            parts.append(piece)
        return torch.cat(parts, d)

    def params(self, params: DecoderLM) -> DecoderLM:
        """This rank's ``DecoderLM`` of a whole, unpadded one."""
        return map_params(params, self.tensor)

    def join(self, where: str, key: str, pieces: list) -> torch.Tensor:
        """The padded model's tensor from every rank's part (``slice``'s
        inverse; ``pieces`` in rank order, each rank's ``Shard`` of the same
        cfg and world)."""
        if self.world == 1 or where in ("block", "shared") or (where, key) == ("moe", "router"):
            return pieces[0]
        if where == "attn" and key in _Q_KEYS + _KV_KEYS:
            c, q = self.padded, key in _Q_KEYS
            dim = 1 if key in ("wq", "wk", "wv") else 0
            shape = list(pieces[0].shape)
            shape[dim] = c.n_heads if q else c.n_kv_heads
            out = pieces[0].new_zeros(shape)
            for rank, piece in enumerate(pieces):
                src = attn_layout(c.n_heads, c.n_kv_heads, rank, self.world)[0 if q else 1]
                for slot, s in enumerate(src):
                    if s >= 0:
                        out.select(dim, s).copy_(piece.select(dim, slot))
            return out
        if where in _RECURRENT and (where, key) not in _FF_PADDED:
            seg = self._segments(where, key)
            if seg is None:
                return pieces[0]
            d, parts, off = seg[0], [], 0
            for ax, width in seg[1]:  # each rank's part of a segment, or rank 0's whole one
                n = pieces[0].shape[d] if width is None else \
                    width // self.world if ax == "inner" else width
                parts += [t.narrow(d, off, n) for t in (pieces if ax == "inner" else pieces[:1])]
                off += n
            return torch.cat(parts, d)
        d, full = self._split_dim(where, key)
        if d is None:
            return pieces[0]
        if (where, key) in _FF_PADDED:  # each rank's share without its padding
            pieces = [t.narrow(d, 0, full[d] // self.world) for t in pieces]
        return torch.cat(pieces, d)

    def _split_dim(self, where: str, key: str) -> tuple:
        """(the dimension the ranks split, the padded model's shape) of a
        tensor that is neither an attention head tensor nor a recurrent
        segment tensor; (None, None) for one kept whole."""
        c = self.padded
        dff = c.moe_d_ff or c.d_ff
        qk, kvl = c.nope_head_dim + c.rope_head_dim, c.kv_lora_rank
        full = {("mlp", "wg"): (c.d_model, c.d_ff), ("mlp", "wu"): (c.d_model, c.d_ff),
                ("mlp", "wd"): (c.d_ff, c.d_model), ("moe", "wg"): (c.n_experts, c.d_model, dff),
                ("moe", "wu"): (c.n_experts, c.d_model, dff),
                ("moe", "wd"): (c.n_experts, dff, c.d_model),
                ("model", "embed"): (c.vocab_size, c.d_model),
                ("model", "lm_head"): (c.d_model, c.vocab_size),
                ("attn", "w_uq"): (c.q_lora_rank, c.n_heads, qk),
                ("attn", "w_uk"): (kvl, c.n_heads, c.nope_head_dim),
                ("attn", "w_uv"): (kvl, c.n_heads, c.v_head_dim),
                ("tm", "cm_k"): (c.d_model, c.d_ff), ("tm", "cm_v"): (c.d_ff, c.d_model)
                }.get((where, key))
        axes = weight_axes(where, key, "ep" if self.ep else "tp")
        d = None if full is None else model_dim({"model": self.world}, axes, full)
        return (None, None) if d is None else (d, full)

    # ---- training: what no collective of the forward does ----------------------
    @functools.cached_property
    def _kv_holders(self) -> dict:
        """Global KV head -> the ranks that hold it (several where the ranks
        do not divide the KV heads, ``attn_layout``)."""
        c, held = self.padded, {}
        for r in range(self.world):
            for h in attn_layout(c.n_heads, c.n_kv_heads, r, self.world)[1]:
                held.setdefault(h, []).append(r)
        return held

    def _attn_dim(self, key: str) -> int:
        return 1 if key in ("wq", "wk", "wv") else 0

    def reduce_grads(self, params: DecoderLM, grads: list, group,
                     seq_shard: bool = False) -> list:
        """The gradients of this rank's ``params`` (one per parameter, in
        ``parameters()`` order) once what the forward's collectives leave
        partial is summed over ``group`` (this shard's ranks; call it after
        the backward, on every rank):

        * the whole tensors that only rank-local work reads — mamba2's BC
          segments of ``w_in``, ``conv_w`` and ``conv_b``, rwkv6's
          ``mu_tm`` and ``decay_a`` where the heads are split — summed;
        * after a forward with ``seq_shard`` (the residual stream split over
          the ranks by sequence), the whole tensors that each rank reads on
          its own rows only — every norm of the residual (the blocks'
          ``ln1``/``ln2``/``ln``, ``final_norm``), zamba2's ``in_w``, a MoE
          block's shared experts, rwkv6's ``cm_r`` and ``mu_cm`` (the
          channel-mix gate) — summed, in one all-reduce per dtype;
        * a KV head that several ranks hold (the ranks do not divide the KV
          heads): each rank's ``wk``/``wv``/``bk``/``bv`` slot summed over
          the ranks that hold its head;
        * the zero query slots ``attn_layout`` pads a rank with, which are
          no heads of the model: their ``wq``/``bq``/``wo`` gradient zeroed
          (a zero query attends uniformly, so its ``wo`` rows get one).

        Every other gradient is already this rank's part of the whole
        one (the split tensors) or the whole one (the tensors every rank
        holds), as the forward's ``TPGroup.copy``/``reduce`` placed them."""
        if self.world == 1:
            return list(grads)
        where = [param_where(n) for n, _ in params.named_parameters()]
        out = [self._reduce_grad(*w, g, group) for w, g in zip(where, grads)]
        if seq_shard:
            rows = [i for i, w in enumerate(where) if w[0] in _ROW_LOCAL or w in _ROW_LOCAL]
            for dtype in {out[i].dtype for i in rows}:
                idx = [i for i in rows if out[i].dtype == dtype]
                flat = group.all_reduce(torch.cat([out[i].reshape(-1) for i in idx]))
                for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
                    out[i] = part.view_as(out[i])
        return out

    def _reduce_grad(self, where: str, key: str, g: torch.Tensor, group) -> torch.Tensor:
        if where == "attn" and key in _Q_KEYS:
            pads = [slot for slot, s in enumerate(self.attn[0]) if s < 0]
            if pads:
                g = g.clone()
                for slot in pads:
                    g.select(self._attn_dim(key), slot).zero_()
            return g
        if where == "attn" and key in _KV_KEYS:
            held = self._kv_holders
            if all(len(ranks) == 1 for ranks in held.values()):
                return g
            dim, kv_src = self._attn_dim(key), self.attn[1]
            shape = list(g.shape)
            shape[dim] = self.padded.n_kv_heads
            idx = torch.tensor(kv_src, device=g.device)
            whole = g.new_zeros(shape).index_copy_(dim, idx, g)
            return group.all_reduce(whole).index_select(dim, idx)
        if not self.ssm_heads:
            return g
        if (where, key) in (("tm", "mu_tm"), ("tm", "decay_a")):
            return group.all_reduce(g.clone(memory_format=torch.contiguous_format))
        if where == "mamba" and key in ("w_in", "conv_w", "conv_b"):
            d, segs = self._segments(where, key)
            g, off = g.clone(), 0
            for ax, width in segs:
                n = width // self.world if ax == "inner" else width
                if ax is None:
                    g.narrow(d, off, n).copy_(group.all_reduce(g.narrow(d, off, n).contiguous()))
                off += n
            return g
        return g

    def norm_weights(self, params: DecoderLM) -> list:
        """Per parameter of this rank's ``params``, how its squares enter the
        global gradient norm of the padded model (``optim.adamw``): None
        for a tensor every rank holds whole (counted once, on each rank
        alike), else a weight (1, or a 0/1 tensor that broadcasts against
        it) for a tensor whose parts the ranks hold, summed over the group:
        a KV head that several ranks hold, or mamba2's whole BC segment,
        counts on the first rank that holds it only."""
        return [self._norm_weight(*param_where(n), p) for n, p in params.named_parameters()]

    def _norm_weight(self, where: str, key: str, t: torch.Tensor):
        def along(dim: int, w: list):
            shape = [1] * t.dim()
            shape[dim] = len(w)
            return torch.tensor(w, dtype=torch.float32, device=t.device).reshape(shape)

        if self.world == 1 or where in ("block", "shared") or (where, key) == ("moe", "router"):
            return None
        if where == "attn" and key in _Q_KEYS:
            return 1.0
        if where == "attn" and key in _KV_KEYS:
            first = [float(self._kv_holders[h][0] == self.rank) for h in self.attn[1]]
            return 1.0 if all(first) else along(self._attn_dim(key), first)
        axes = weight_axes(where, key, "ep" if self.ep else "tp")
        if where in _RECURRENT and "ff" not in axes:
            seg = self._segments(where, key)
            if seg is None:
                return None
            d, segs = seg
            if all(ax == "inner" for ax, _ in segs):
                return 1.0
            w = []
            for ax, width in segs:
                n = width // self.world if ax == "inner" else width
                w += [1.0 if ax == "inner" or self.rank == 0 else 0.0] * n
            return along(d, w)
        return None if self._split_dim(where, key)[0] is None else 1.0


def unshard_params(cfg, shards: list, moe_form: str = "tp") -> DecoderLM:
    """The whole, unpadded ``DecoderLM`` of ``cfg`` from every rank's
    shards (``shards[r]``: rank r's ``DecoderLM`` of a group of
    ``len(shards)``)."""
    from repro_torch.models.padding import unpad_tensor

    shard = Shard(cfg, 0, len(shards), moe_form)
    by_rank = [dict(s.named_parameters()) for s in shards]

    def whole(name, t):
        where, key = param_where(name)
        joined = shard.join(where, key, [p[name].detach() for p in by_rank])
        return unpad_tensor(cfg, shard.padded, where, key, joined).clone(
            memory_format=torch.contiguous_format)

    return map_named_params(shards[0], whole)


def shard_params(cfg, params: DecoderLM, group, moe_form: str = "tp") -> DecoderLM:
    """``params`` (a whole model of ``cfg``) as rank ``group.rank`` of
    ``group.world`` keeps it: padded by ``resolve_for_tp`` and sliced, tensor
    by tensor."""
    return Shard(cfg, group.rank, group.world, moe_form).params(params)
