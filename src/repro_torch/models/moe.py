"""Mixture-of-Experts (``repro.models.moe``): capacity-based grouped dispatch
on one device.

The reference's single-device path (``_moe_local``): a router picks the
top-k experts of every row, the (row, k) pairs are sorted stably by
expert, and the first ``capacity`` pairs of each expert fill its slots of
an [E, C, d] buffer; the pairs past capacity are dropped (their weight is
0 and they read a sink row).  The experts' SwiGLU MLPs run as batched
products over the buffer, and each row sums its k weighted results.  The
top-k weights are renormalised by ``max(sum, 1e-9)``.  The shared experts
(deepseek-moe) are one dense SwiGLU MLP on every row, added after.

Capacity is ``max(1, ceil(T * k / E * capacity_factor))`` with T the rows
of the whole forward, padding and every tree node included, so a verify of
n rows may drop where a decode of one row does not.

The reference sums with scatter-adds; on the card an ``index_add_`` would
add a row's k results in an order that changes from run to run.  Here the
buffer is filled by a copy into distinct slots (only the sink row, which is
never read, is shared) and each row's k results are summed by one
reduction over the k axis, with no atomics, so a forward gives the same
bits every time.

Under tensor parallelism (``tp``, a ``parallel.TPGroup``) the reference's
two forms (``repro/models/moe.py:108-163``), the rank's shards cut for
the one named (``parallel.Shard``): "tp" — every expert's ff split
over the ranks, the dispatch the same on every rank, one all-reduce of
the partial outputs; "ep" — the experts split over the ranks (only where
the ranks divide E, else the model takes "tp"), each rank routing every
row and keeping the pairs of its own experts at the same capacity and the
same places within each expert as the whole dispatch, then one all-reduce.
The shared experts run replicated on every rank, after the all-reduce, as
the reference computes them outside its ``shard_map``.

With the residual stream sequence-sharded (``seq``, a
``parallel.SeqGroup``) the router must still see every row of the forward,
since the capacity counts them all: the rank's rows are gathered (work
that every rank repeats whole), the dispatch runs as above on the whole
sequence, and the experts' partial sum is reduce-scattered to the rank's
rows; the shared experts run on the rank's rows only.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, project, project_batched


def init_moe(cfg, gen, device, dtype) -> tuple[dict, dict | None]:
    """(routed, shared): router [d, E], wg/wu [E, d, ff], wd [E, ff, d], and
    the shared experts' wg/wu [d, S*ff], wd [S*ff, d] (None without any),
    drawn with the reference's init scales."""
    E, d = cfg.n_experts, cfg.d_model
    dff = cfg.moe_d_ff or cfg.d_ff

    def init(shape):
        return dense_init(gen, shape, dtype, device)

    routed = {"router": init((d, E)), "wg": init((E, d, dff)), "wu": init((E, d, dff)),
              "wd": init((E, dff, d))}
    shared = None
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * dff
        shared = {"wg": init((d, sff)), "wu": init((d, sff)), "wd": init((sff, d))}
    return routed, shared


def capacity(cfg, T: int) -> int:
    """Slots per expert for a forward of T rows (the reference's rule)."""
    return max(1, math.ceil(T * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor))


def route(x2d, router, n_experts: int, top_k: int, cap: int):
    """The dispatch plan of x2d [T, d]: (dest [T, k] the buffer row of each
    (row, k) pair — E * cap for a dropped pair —, weight [T, k] f32, 0 for
    a dropped pair).  Pairs are ranked within their expert in the order of
    a stable sort by expert, as the reference ranks them."""
    T = x2d.shape[0]
    # the router's product in float32, as the reference's (its serving product:
    # a row's gates do not depend on the rows beside it)
    gates = torch.softmax(project(x2d.float(), router.float()), dim=-1)
    topv, topi = torch.topk(gates, top_k, dim=-1)  # [T, k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(n_experts, device=x2d.device,
                                                          dtype=sorted_e.dtype))
    pos_sorted = torch.arange(T * top_k, device=x2d.device) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted).reshape(T, top_k)
    keep = pos < cap
    dest = torch.where(keep, topi * cap + pos, n_experts * cap)
    return dest, topv * keep


def _swiglu(x, wg, wu, wd):
    """The shared experts: one dense SwiGLU MLP.  A serving forward runs the
    dense blocks' kernel and serving product (row-invariant); under a
    gradient the plain products, as the reference's."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wg, wu, wd)):
        return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd
    return project(ops.fused_swiglu(x, wg, wu), wd)


def _combine(hflat, dest, w):
    """Each row's k expert results (rows ``dest`` [T, k] of hflat, the sink
    row for a dropped pair) weighted by ``w`` [T, k] and summed over k:
    [T, d]."""
    contrib = hflat[dest] * w[..., None].to(hflat.dtype)  # [T, k, d]
    return contrib.sum(1)


def moe_apply(cfg, p: dict, shared: dict | None, x, tp=None, ep: bool = False, seq=None):
    """x [B, n, d] -> [B, n, d]: the routed experts plus the shared ones.
    With ``tp`` the routed experts are this rank's shards — of the "ep"
    form with ``ep`` (E/world whole experts), else of the "tp" form — and
    their outputs are summed over the ranks.  The router and the shared
    experts, whole on every rank, read ``x`` as it is; the rows that fill
    the experts' buffer and the routing weights enter the rank's experts
    through ``TPGroup.copy``, so their gradient is the whole one.  With
    ``seq`` (a ``parallel.SeqGroup`` over ``tp``), ``x`` and the result
    are this rank's rows of the sequence (the module docstring)."""
    x_own = x
    if seq is not None:
        x = seq.gather(x)
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    T, E, k = x2d.shape[0], cfg.n_experts, cfg.moe_top_k
    cap = capacity(cfg, T)
    dest, w = route(x2d, p["router"], E, k, cap)
    xin = x2d
    if tp is not None:
        xin, w = tp.copy(x2d), tp.copy(w)
    E_loc = E // tp.world if ep else E
    if ep:  # keep the pairs of this rank's experts [lo, lo + E_loc)
        lo = tp.rank * E_loc * cap
        mine = (dest >= lo) & (dest < lo + E_loc * cap)
        dest = torch.where(mine, dest - lo, E_loc * cap)
        w = w * mine
    # every kept pair has a slot of its own; dropped pairs all land in the sink row
    xbuf = x2d.new_zeros((E_loc * cap + 1, d))
    xbuf[dest.reshape(-1)] = xin.repeat_interleave(k, dim=0)
    xe = xbuf[:-1].reshape(E_loc, cap, d)
    # the experts' batched products (an expert's M is the capacity, which moves
    # with the forward's rows: each sums in an order that M does not choose)
    h = project_batched(torch.nn.functional.silu(project_batched(xe, p["wg"]))
                        * project_batched(xe, p["wu"]), p["wd"])
    hflat = torch.cat([h.reshape(E_loc * cap, d), h.new_zeros((1, d))])
    out = _combine(hflat, dest, w)
    if seq is not None:  # this rank's rows from here on
        out = seq.reduce(out.reshape(B, S, d)).reshape(-1, d)
        x2d = x_own.reshape(-1, d)
    elif tp is not None:
        out = tp.reduce(out)
    if shared is not None:
        out = out + _swiglu(x2d, shared["wg"], shared["wu"], shared["wd"])
    return out.reshape(x_own.shape)
