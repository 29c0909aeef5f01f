"""Multi-head Latent Attention (``repro.models.mla``; MiniCPM3 /
DeepSeek-V2 style).

The cache keeps only the compressed latent ``ckv`` [B, S, kv_lora_rank]
and the rotary key ``krope`` [B, S, rope_head_dim], shared by all heads.
The reference's prefill materialises per-head K/V from the latent
(``mla_full``); its cached forwards use the absorbed form (W_uk folded into
the query, W_uv applied after the probability-weighted latent sum), so
decode and the tree forward never build per-head K/V.  No Pallas kernel
runs in the reference's MLA; its products and attention are XLA einsums.

A serving forward (no gradient) of the port is row-invariant, as the
tree engine's contract needs in bf16: the 2-D products go through
``models.common.project``, the per-head products with W_uk and W_uv
through ``models.common.project_batched`` (on head-major copies of the two
weights, ``head_major``), and the absorbed attention through
``ops.latent_attention``, which sums each query's keys by rank.  The
cache-filling prefill attends the same way (``mla_prefill``), in query
chunks: absorbed, where the reference's prefill is not, so that a prompt
row carries the bits that the first verify recomputes.  Under a gradient
the prefill is ``mla_full`` with plain products, as the reference's.  The
cache rows are written as the GQA caches' are.
"""

from __future__ import annotations

import math
import weakref

import torch

from repro_torch.kernels import ops, work
from repro_torch.models.attention import (
    ATTN_CHUNK,
    attn_chunk,
    causal_mask,
    chunked,
    plan_row_writes,
    scatter_rows,
    update_rows_contiguous,
)
from repro_torch.models.common import apply_rope, dense_init, project, project_batched, rms_norm

# id of a weight -> (a weak reference to it, (its version, dims) when copied, its
# head-major copy): ``head_major``'s copies, each dropped with its weight
_HEAD_MAJOR: dict = {}


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
    B, S = x.shape[:2]
    q_lat = _copy(tp, rms_norm(project(x, p["w_dq"]), p["q_norm"], cfg.norm_eps))
    if torch.is_grad_enabled() and (q_lat.requires_grad or p["w_uq"].requires_grad):
        q = torch.einsum("bsl,lhk->bshk", q_lat, p["w_uq"])  # the reference's, differentiated
    else:
        l, H, k = p["w_uq"].shape
        q = project(q_lat, p["w_uq"].reshape(l, H * k)).reshape(B, S, H, k)  # [B, S, H, nd + rd]
    return q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)


def _latents(cfg, p, x, positions, tp=None):
    kvl = cfg.kv_lora_rank
    lat = project(x, p["w_dkv"])  # [B, S, kvl + rd]
    c_kv = rms_norm(lat[..., :kvl], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(lat[..., None, kvl:], positions, cfg.rope_theta)[..., 0, :]
    return _copy(tp, c_kv), _copy(tp, k_rope)


def _out(p, o):
    """o [B, n, H, vd] @ wo [H, vd, d] -> [B, n, d]: in a serving forward one
    product over the heads' joined columns; under a gradient the
    reference's einsum."""
    if torch.is_grad_enabled() and (o.requires_grad or p["wo"].requires_grad):
        return torch.einsum("bnhk,hkd->bnd", o, p["wo"])
    B, n, H, vd = o.shape
    return project(o.reshape(B, n, H * vd), p["wo"].reshape(H * vd, -1))


def _no_work(w, dims):
    return 0, 0


@work.counted("mla_head_major", _no_work)
def head_major(w, dims):
    """``w.permute(*dims)`` made contiguous, once per weight: MLA's W_uk
    [kvl, H, nd] as [H, nd, kvl] (dims (1, 2, 0)) and W_uv [kvl, H, vd] as
    [H, kvl, vd] (dims (1, 0, 2)), the per-head operands of the batched
    serving product.  The copy is kept beside the weight and made again only
    after the weight was written in place (its version moved), so a model's
    forwards after the first read it as they read the weight; the dry run
    counts it as no work of a step.  Under a gradient the permuted view
    itself (the reference's weights, differentiated)."""
    if torch.is_grad_enabled() and w.requires_grad:
        return w.permute(*dims)
    key = id(w)
    hit = _HEAD_MAJOR.get(key)
    if hit is None or hit[0]() is not w or hit[1] != (w._version, dims):
        ref = weakref.ref(w, lambda _, key=key: _HEAD_MAJOR.pop(key, None))
        hit = _HEAD_MAJOR[key] = (ref, (w._version, dims),
                                  w.detach().permute(*dims).contiguous())
    return hit[2]


def _per_head(x, w):
    """x [B, n, H, K] @ w [H, K, N] head by head -> [B, n, H, N]: one batched
    product over the heads (``project_batched``)."""
    B, n, H, K = x.shape
    y = project_batched(x.permute(2, 0, 1, 3).reshape(H, B * n, K), w)
    return y.reshape(H, B, n, -1).permute(1, 2, 0, 3)


def _absorbed(cfg, p, q_nope, q_rope, ckv, krope, mask):
    """The absorbed attention of the queries over the latent rows ckv /
    krope [B, S, .] under mask [B, n, S]: W_uk folded into the query, the
    kernel's latent sum, then W_uv.  -> o [B, n, H, vd]."""
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    q_eff = _per_head(q_nope, head_major(p["w_uk"], (1, 2, 0)))  # [B, n, H, kvl]
    lat = ops.latent_attention(q_eff, q_rope, ckv, krope, mask, scale)
    return _per_head(lat, head_major(p["w_uv"], (1, 0, 2)))


def _attend_work(q_nope, q_rope, k_nope, k_rope, v, positions, scale, backward=False):
    d_qk = q_nope.shape[-1] + q_rope.shape[-1]
    S = q_nope.shape[1]
    if backward:
        flops, nbytes = work.full_attention_backward(q_nope, k_nope, v, d_qk=d_qk,
                                                     recompute=attn_chunk(S) < S)
    else:
        flops, nbytes = work.full_attention(q_nope, k_nope, v, d_qk=d_qk)
    return flops, nbytes + (q_rope.numel() + k_rope.numel()) * q_rope.element_size() * (
        2 if backward else 1)


@work.counted("mla_full", _attend_work, lambda *a: _attend_work(*a, backward=True))
def causal_mla(q_nope, q_rope, k_nope, k_rope, v, positions, scale: float):
    """MLA's causal attention over per-head keys (``k_nope`` [B, S, H, nd]
    and the shared ``k_rope`` [B, S, rd]) and values ``v`` [B, S, H, vd],
    in query chunks (``attention.chunked``).  -> [B, S, H, vd]."""
    S = q_nope.shape[1]
    c = attn_chunk(S)

    def one_chunk(i, q_nope, q_rope, k_nope, k_rope, v, positions):
        scores = (torch.einsum("bnhk,bshk->bhns", q_nope[:, i:i + c], k_nope)
                  + torch.einsum("bnhk,bsk->bhns", q_rope[:, i:i + c], k_rope)) * scale
        mask = causal_mask(positions[:, i:i + c], positions)[:, None]  # [B, 1, c, S]
        probs = torch.softmax(torch.where(mask, scores.float(), -1e30), dim=-1).to(v.dtype)
        return torch.einsum("bhns,bshk->bnhk", probs, v)

    return chunked(one_chunk, S, q_nope, q_rope, k_nope, k_rope, v, positions)


def mla_full(cfg, p, x, positions, tp=None):
    """Causal MLA over the whole sequence (prefill), with per-head K/V built
    from the latent.  Returns (out [B, S, d], (c_kv, k_rope)) for the cache.
    The attention runs in query chunks, as the reference's.
    ``tp``: the group the heads are split over (None: all here); the down
    projections and their norms are whole on every rank, and their outputs
    (``q_lat``, ``c_kv``, ``k_rope``) enter the rank's heads through
    ``TPGroup.copy``, so their gradient is the whole one on every rank."""
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    q_nope, q_rope = _queries(cfg, p, x, positions, tp)
    c_kv, k_rope = _latents(cfg, p, x, positions, tp)
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uv"])
    out = causal_mla(q_nope, q_rope, k_nope, k_rope, v, positions, scale)
    return _out(p, out), (c_kv, k_rope)


def mla_prefill(cfg, p, x, positions, cache=None, tp=None):
    """A serving prefill of MLA (no gradient), absorbed: the rows' latents
    are written at rows [0, n) of ``cache`` (ckv [B, S, kvl], krope [B, S,
    rd]; None: they are attended as they are), then every query attends them
    under the causal mask through ``ops.latent_attention``, in chunks of
    ``ATTN_CHUNK`` queries, as a verify and a decode step attend: a prompt
    row carries the bits that the first verify recomputes (the reference's
    prefill is ``mla_full``, non-absorbed; the two agree within the
    tolerance, not in bits).  Returns (out [B, n, d], (c_kv, k_rope))."""
    q_nope, q_rope = _queries(cfg, p, x, positions, tp)
    c_kv, k_rope = _latents(cfg, p, x, positions, tp)
    if cache is not None:
        ckv, krope = cache
        update_rows_contiguous(ckv, c_kv, 0)
        update_rows_contiguous(krope, k_rope, 0)
    else:
        ckv, krope = c_kv, k_rope
    B, n = x.shape[:2]
    S = ckv.shape[1]
    outs = []
    for i in range(0, n, ATTN_CHUNK):
        j = min(i + ATTN_CHUNK, n)
        mask = torch.zeros((B, j - i, S), dtype=torch.bool, device=x.device)
        mask[:, :, :j] = causal_mask(positions[:, i:j], positions[:, :j])
        outs.append(_absorbed(cfg, p, q_nope[:, i:j], q_rope[:, i:j], ckv, krope, mask))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return _out(p, o), (c_kv, k_rope)


def mla_cached(cfg, p, x, cache_ckv, cache_krope, row_idx, positions, attn_mask, *,
               row_start=None, row_plan=None, tp=None):
    """Cached MLA (decode / tree forward), absorbed form.  The new latent
    rows are written in place at ``row_idx`` [B, n] (through ``row_plan``,
    the forward's ``plan_row_writes``) or at [row_start, row_start + n);
    then the n queries attend the cache under ``attn_mask`` [B, n, S]
    (``ops.latent_attention``), and a query that sees no row gives 0.
    Returns (out, ckv, krope)."""
    q_nope, q_rope = _queries(cfg, p, x, positions, tp)
    c_new, kr_new = _latents(cfg, p, x, positions, tp)
    if row_start is not None:
        update_rows_contiguous(cache_ckv, c_new, row_start)
        update_rows_contiguous(cache_krope, kr_new, row_start)
    else:
        row_plan = row_plan or plan_row_writes(row_idx, cache_ckv.shape[1])
        scatter_rows(cache_ckv, c_new, row_idx, plan=row_plan)
        scatter_rows(cache_krope, kr_new, row_idx, plan=row_plan)
    o = _absorbed(cfg, p, q_nope, q_rope, cache_ckv, cache_krope, attn_mask)
    return _out(p, o), cache_ckv, cache_krope
