"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``).

The CPU parity tests run these; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They are deliberately naive — materialized
scores, f32 math — so they are easy to audit against the reference."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant import QuantizedLinear, dequantize


def tree_attention_ref(q, k, v, mask):
    """Non-square tree-masked GQA attention.

    q: [B, n, Hq, hd]; k, v: [B, S, Hkv, hd]; mask: bool [B, n, S], True =
    attend.  Returns [B, n, Hq, hd] in q's dtype; a fully masked query row
    returns zeros."""
    B, n, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(B, n, hkv, g, hd).float()
    scores = torch.einsum("bnkgh,bskh->bkgns", qg, k.float()) / math.sqrt(hd)
    m = mask[:, None, None, :, :]
    scores = torch.where(m, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bkgns,bskh->bnkgh", probs, v.float())
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
    x: [M, K]; wg, wu: [K, N] -> [M, N]."""
    g = x.float() @ wg.float()
    u = x.float() @ wu.float()
    return (F.silu(g) * u).to(x.dtype)


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
