"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``).

The CPU parity tests run these; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They are deliberately naive — materialized
scores, f32 math — so they are easy to audit against the reference."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant import QuantizedLinear, dequantize


REF_BLOCK_BYTES = 1 << 28  # the most bytes of gathered keys and values one block of queries holds


def tree_attention_ref(q, k, v, mask):
    """Non-square tree-masked GQA attention.

    q: [B, n, Hq, hd]; k, v: [B, S, Hkv, hd]; mask: bool [B, n, S], True =
    attend.  Returns [B, n, Hq, hd] in q's dtype; a fully masked query row
    returns zeros.

    Each query first gathers the keys it attends, in row order, to the
    front of its own copy of the cache, so that its sums run over the same
    terms at the same indices wherever those keys lie in the cache.  A
    tree verify holds a node's ancestors at rows of the tree's order, the
    greedy decode at consecutive rows; the float32 sums over the key axis
    group their terms by index, and in bf16 the one rounding of the output
    turns that into an ulp now and then, enough to break a tie of two
    logits one way in the verify and the other in the decode.  The queries
    run in blocks whose copies take at most ``REF_BLOCK_BYTES`` (one query
    at least), so a long prefill never holds a copy of the cache for every
    row.  The CPU's batched products pick their path by the batch's size,
    so past the smoke configs' shapes a row's last bits may still depend
    on how many rows came with it."""
    B, n = q.shape[:2]
    S, hkv, hd = k.shape[1:]
    rows = max(1, REF_BLOCK_BYTES // (2 * B * S * hkv * hd * (k.element_size() + 4)))
    if n <= rows:
        return _tree_attention_rows(q, k, v, mask)
    return torch.cat([_tree_attention_rows(q[:, i:i + rows], k, v, mask[:, i:i + rows])
                      for i in range(0, n, rows)], dim=1)


def _tree_attention_rows(q, k, v, mask):
    """``tree_attention_ref`` of one block of queries."""
    B, n, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    # each query's attended rows first, in row order, then the others
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
    mask = torch.gather(mask, -1, order)
    pick = torch.arange(B, device=k.device)[:, None, None], order
    qg = q.reshape(B, n, hkv, g, hd).float()
    scores = torch.einsum("bnkgh,bnskh->bnkgs", qg, k[pick].float()) / math.sqrt(hd)
    m = mask[:, :, None, None, :]
    scores = torch.where(m, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bnkgs,bnskh->bnkgh", probs, v[pick].float())
    return out.reshape(B, n, hq, hd).to(q.dtype)


def decode_attention_ref(q, k, v, length):
    """One query position per batch row against the cache rows < length.

    q: [B, Hq, hd]; k, v: [B, S, Hkv, hd]; length: int [B].  Returns
    [B, Hq, hd] in q's dtype; a row with length 0 returns zeros.  It is
    ``tree_attention_ref`` at n = 1 under the mask cols < length, as the
    reference's oracle is."""
    S = k.shape[1]
    mask = torch.arange(S, device=k.device)[None, :] < length.to(k.device)[:, None]
    return tree_attention_ref(q[:, None], k, v, mask[:, None, :])[:, 0]


def fused_swiglu_ref(x, wg, wu):
    """silu(x @ wg) * (x @ wu) in f32, returned in x's dtype.
    x: [M, K]; wg, wu: [K, N] -> [M, N].

    A single row is multiplied as a pair (itself twice): a BLAS takes one
    row by a matrix-vector product, whose sums run in another order than
    its matrix product's, and a row's result must not depend on how many
    rows came with it (a decode step's row against the same row in a
    verify; in bf16 the output's rounding turns the last bits into ulps)."""
    xf = x.float()
    if x.shape[0] == 1:
        xf = xf.expand(2, -1)
    g = xf @ wg.float()
    u = xf @ wu.float()
    return (F.silu(g) * u)[:x.shape[0]].to(x.dtype)


def stream_matmul_ref(x, w):
    """x @ w in x's dtype: x [..., K]; w [K, N] -> [..., N].

    The product the serving forward computed before it went through the
    ``stream_matmul`` kernel, kept as it was, so that the port's results on
    the CPU stay what they were bit for bit.  In bf16 the CPU's product gives
    a row the same bits alone and among rows at the smoke shapes; in float32
    a single row takes the BLAS's matrix-vector product, whose sums run in
    another order than its matrix product's (the kernel's order does not
    depend on the rows)."""
    return x @ w


def latent_attention_ref(q_lat, q_rope, ckv, krope, mask, scale: float):
    """MLA's absorbed attention, as the port computed it before the
    ``latent_attention`` kernel (the reference's ``mla_cached`` einsums):
    q_lat [B, n, H, KL], q_rope [B, n, H, RD] against the latent rows ckv
    [B, S, KL] / krope [B, S, RD] under mask bool [B, n, S]; the scores in
    the inputs' dtype, the softmax in f32, the weights rounded to the
    dtype.  Returns lat [B, n, H, KL], zeros for a fully masked query."""
    scores = (torch.einsum("bnhl,bsl->bhns", q_lat, ckv)
              + torch.einsum("bnhk,bsk->bhns", q_rope, krope)) * scale
    m = mask[:, None]  # [B, 1, n, S]
    probs = torch.softmax(torch.where(m, scores.float(), -1e30), dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhns,bsl->bnhl", probs.to(ckv.dtype), ckv)


def stream_bmm_ref(x, w):
    """torch.bmm(x, w) in x's dtype: x [G, M, K]; w [G, K, N] -> [G, M, N].
    The batched products the serving forward computed before they went
    through the ``stream_bmm`` kernel, kept as they were (the CPU's results
    stay what they were bit for bit)."""
    return torch.bmm(x, w)


def rms_norm_ref(x, weight, eps: float):
    """x * rsqrt(mean(x², -1) + eps) * weight in f32, returned in x's dtype
    (``repro.models.common.rms_norm``).  The arithmetic the port's norm ran
    before the ``rms_norm`` kernel, kept as it was: the CPU's results stay
    what they were, and a forward under a gradient differentiates it."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def kv_move_rows_ref(arr, src, dst, mask):
    """Index-based KV row moves on one cache leaf, as a parallel assignment.

    arr: [U, B, S, ...]; src, dst: int [B, M]; mask: bool [B, M].  For every
    active move (mask, 0 <= src < S, 0 <= dst < S) out[u, b, dst] =
    arr[u, b, src], all sources read before any write.  Inactive moves land
    in a spare row S that is cut off, so they never touch the cache (a -1
    index would be the last row in torch).  Returns a new tensor."""
    U, B, S = arr.shape[:3]
    M = src.shape[1]
    src, dst = src.long(), dst.long()
    act = mask & (src >= 0) & (src < S) & (dst >= 0) & (dst < S)
    flat = arr.reshape(U, B, S, -1)
    Fw = flat.shape[-1]
    sidx = torch.where(act, src, torch.zeros_like(src))
    rows = flat.gather(2, sidx[None, :, :, None].expand(U, B, M, Fw))
    didx = torch.where(act, dst, torch.full_like(dst, S))
    out = torch.cat([flat, flat.new_zeros(U, B, 1, Fw)], dim=2)
    out.scatter_(2, didx[None, :, :, None].expand(U, B, M, Fw), rows)
    return out[:, :, :S].reshape(arr.shape)


def slot_write_rows_ref(cache_leaves, donor_leaves, slot):
    """The slot lifecycle write, leaf by leaf: ``out[:, slot] = donor[:, 0]``
    for every cache leaf [U, B, ...] and its donor [U, 1, ...], or
    ``out[:, slot] = 0`` when ``donor_leaves`` is None (zeroing).  Returns
    new tensors; the inputs are left as they were."""
    outs = []
    for i, big in enumerate(cache_leaves):
        out = big.clone()
        if donor_leaves is None:
            out[:, slot] = 0
        else:
            out[:, slot] = donor_leaves[i][:, 0]
        outs.append(out)
    return outs


def int4_matmul_ref(x, qweight, scales, zeros, group_size: int):
    """AWQ groupwise int4 dequant-GEMM, in f32.

    x: [T, K]; qweight: int8 [K//2, N] packed (the kernel's contract: low
    nibble even k, high nibble odd k); scales, zeros: [K//group_size, N].
    w = (q - z) * s; returns (x @ w) [T, N] in x's dtype.  The reference's
    ``int4_matmul_ref`` takes the unpacked [K, N] instead."""
    w = dequantize(QuantizedLinear(qweight, scales, zeros, group_size))
    return (x.to(torch.float32) @ w).to(x.dtype)
