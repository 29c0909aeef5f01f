"""Multi-head Latent Attention (``repro.models.mla``; MiniCPM3 /
DeepSeek-V2 style).

The cache keeps only the compressed latent ``ckv`` [B, S, kv_lora_rank]
and the rotary key ``krope`` [B, S, rope_head_dim], shared by all heads.
Prefill materialises per-head K/V from the latent; the cached forwards use
the absorbed form (W_uk folded into the query, W_uv applied after the
probability-weighted latent sum), so decode and the tree forward never
build per-head K/V.  No Pallas kernel runs in the reference's MLA, so this
is plain PyTorch; the cache rows are written as the GQA caches' are.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.attention import plan_row_writes, scatter_rows, update_rows_contiguous
from repro_torch.models.common import apply_rope, dense_init, rms_norm


def init_mla(cfg, gen, device, dtype) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim

    def init(shape, scale=None):
        return dense_init(gen, shape, dtype, device, scale)

    return {
        "w_dq": init((d, ql)), "q_norm": torch.ones(ql, dtype=dtype, device=device),
        "w_uq": init((ql, H, nd + rd)), "w_dkv": init((d, kvl + rd)),
        "kv_norm": torch.ones(kvl, dtype=dtype, device=device),
        "w_uk": init((kvl, H, nd)), "w_uv": init((kvl, H, vd)),
        "wo": init((H, vd, d), scale=(H * vd) ** -0.5),
    }


def _copy(tp, x):
    """Under a group: a latent of the whole down projections entering the
    rank's heads, its gradient summed over the ranks (``TPGroup.copy``)."""
    return x if tp is None else tp.copy(x)


def _queries(cfg, p, x, positions, tp=None):
    nd = cfg.nope_head_dim
    q_lat = _copy(tp, rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps))
    q = torch.einsum("bsl,lhk->bshk", q_lat, p["w_uq"])  # [B, S, H, nd + rd]
    return q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)


def _latents(cfg, p, x, positions, tp=None):
    kvl = cfg.kv_lora_rank
    lat = x @ p["w_dkv"]  # [B, S, kvl + rd]
    c_kv = rms_norm(lat[..., :kvl], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(lat[..., None, kvl:], positions, cfg.rope_theta)[..., 0, :]
    return _copy(tp, c_kv), _copy(tp, k_rope)


def _out(p, o):
    return torch.einsum("bnhk,hkd->bnd", o, p["wo"])


def mla_full(cfg, p, x, positions, tp=None):
    """Causal MLA over the whole sequence (prefill), with per-head K/V built
    from the latent.  Returns (out [B, S, d], (c_kv, k_rope)) for the cache.
    The reference computes it in query chunks, which change no value.
    ``tp``: the group the heads are split over (None: all here); the down
    projections and their norms are whole on every rank, and their outputs
    (``q_lat``, ``c_kv``, ``k_rope``) enter the rank's heads through
    ``TPGroup.copy``, so their gradient is the whole one on every rank."""
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    q_nope, q_rope = _queries(cfg, p, x, positions, tp)
    c_kv, k_rope = _latents(cfg, p, x, positions, tp)
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uv"])
    scores = (torch.einsum("bnhk,bshk->bhns", q_nope, k_nope)
              + torch.einsum("bnhk,bsk->bhns", q_rope, k_rope)) * scale
    mask = (positions[:, None, :] <= positions[:, :, None])[:, None]  # [B, 1, S, S]
    probs = torch.softmax(torch.where(mask, scores.float(), -1e30), dim=-1).to(v.dtype)
    return _out(p, torch.einsum("bhns,bshk->bnhk", probs, v)), (c_kv, k_rope)


def mla_cached(cfg, p, x, cache_ckv, cache_krope, row_idx, positions, attn_mask, *,
               row_start=None, row_plan=None, tp=None):
    """Cached MLA (decode / tree forward), absorbed form.  The new latent
    rows are written in place at ``row_idx`` [B, n] (through ``row_plan``,
    the forward's ``plan_row_writes``) or at [row_start, row_start + n);
    then the n queries attend the cache under ``attn_mask`` [B, n, S], and
    a query that sees no row gives 0.  Returns (out, ckv, krope)."""
    q_nope, q_rope = _queries(cfg, p, x, positions, tp)
    c_new, kr_new = _latents(cfg, p, x, positions, tp)
    if row_start is not None:
        update_rows_contiguous(cache_ckv, c_new, row_start)
        update_rows_contiguous(cache_krope, kr_new, row_start)
    else:
        row_plan = row_plan or plan_row_writes(row_idx, cache_ckv.shape[1])
        scatter_rows(cache_ckv, c_new, row_idx, plan=row_plan)
        scatter_rows(cache_krope, kr_new, row_idx, plan=row_plan)
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    q_eff = torch.einsum("bnhk,lhk->bnhl", q_nope, p["w_uk"])  # W_uk folded into the query
    scores = (torch.einsum("bnhl,bsl->bhns", q_eff, cache_ckv)
              + torch.einsum("bnhk,bsk->bhns", q_rope, cache_krope)) * scale
    m = attn_mask[:, None]  # [B, 1, n, S]
    probs = torch.softmax(torch.where(m, scores.float(), -1e30), dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, 0.0)
    lat = torch.einsum("bhns,bsl->bnhl", probs.to(cache_ckv.dtype), cache_ckv)
    o = torch.einsum("bnhl,lhk->bnhk", lat, p["w_uv"])
    return _out(p, o), cache_ckv, cache_krope
