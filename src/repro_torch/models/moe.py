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
bits every time.  The tensor- and expert-parallel
forms of the reference need a mesh; they are not ported.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import dense_init


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
    gates = torch.softmax(x2d.float() @ router.float(), dim=-1)
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
    return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd


def moe_apply(cfg, p: dict, shared: dict | None, x):
    """x [B, n, d] -> [B, n, d]: the routed experts plus the shared ones."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    T, E, k = x2d.shape[0], cfg.n_experts, cfg.moe_top_k
    cap = capacity(cfg, T)
    dest, w = route(x2d, p["router"], E, k, cap)
    # every kept pair has a slot of its own; dropped pairs all land in the sink row
    xbuf = x2d.new_zeros((E * cap + 1, d))
    xbuf[dest.reshape(-1)] = x2d.repeat_interleave(k, dim=0)
    xe = xbuf[:-1].reshape(E, cap, d)
    h = torch.bmm(torch.nn.functional.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"]),
                  p["wd"])
    hflat = torch.cat([h.reshape(E * cap, d), h.new_zeros((1, d))])
    contrib = hflat[dest] * w[..., None].to(h.dtype)  # [T, k, d]
    out = contrib.sum(1)
    if shared is not None:
        out = out + _swiglu(x2d, shared["wg"], shared["wu"], shared["wd"])
    return out.reshape(B, S, d)
