"""Shared model building blocks (``repro.models.common``): seeded init,
RMSNorm, RoPE, the dense product and the training loss."""

from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref


def dense_init(gen: torch.Generator, shape, dtype, device, scale=None) -> torch.Tensor:
    """Truncated-normal init in [-3σ, 3σ], σ = ``scale`` or fan_in^-1/2,
    drawn by ``gen`` straight into a tensor on ``device`` (a full-width
    model is never built on the host and copied).  On meta nothing is
    drawn (``gen`` may be None): only the shape and dtype exist."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std, generator=gen)
    return t.to(dtype)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N], the dense products of the shared blocks.

    A serving forward (no gradient) goes through ``ops.stream_matmul``,
    whose order of summation does not depend on the rows: a verify's row
    among n then carries the bits of the greedy decode's row alone, as the
    tree engine's contract needs.  A forward under a gradient (an input
    that requires one while grad mode is on: ``ops.fused_swiglu``'s test)
    is ``x @ w``, as the reference computes it — the kernel has no
    backward, and its row tiles would stream the weight again for each 16
    rows of a training batch.  The choice follows what the caller
    computes, not the device: on the CPU both are ``x @ w``."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return x @ w
    return ops.stream_matmul(x, w)


def project_batched(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [G, M, K] @ w [G, K, N], the family-specific batched products (the
    MoE's experts, rwkv6's token-shift projections, MLA's per-head
    products): ``project``'s rule for ``ops.stream_bmm``, whose groups each
    sum in an order that neither M nor G chooses; ``torch.bmm`` under a
    gradient.  On the CPU both are ``torch.bmm``."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return torch.bmm(x, w)
    return ops.stream_bmm(x, w)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x², -1) + eps) * weight in f32, in x's dtype.

    A serving forward (no gradient) goes through ``ops.rms_norm``, whose
    sum over a row does not depend on the rows beside it (PyTorch's
    reduction picks its order by their number, and a verify's row then
    took other bits than the greedy decode's); a forward under a gradient
    (``project``'s test) differentiates the plain arithmetic
    (``ref.rms_norm_ref``).  On the CPU both are the plain arithmetic."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return ref.rms_norm_ref(x, weight, eps)
    return ops.rms_norm(x, weight, eps)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split rotation in f32.
    x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., seq, half]
    cos = torch.cos(angles)[..., None, :]  # [..., seq, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean token cross-entropy in f32: log-sum-exp minus the gold logit,
    averaged over every token or, with ``mask``, over the masked ones (a
    denominator of at least 1).  logits [..., V], labels [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
