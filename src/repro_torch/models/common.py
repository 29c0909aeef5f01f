"""Shared model building blocks (``repro.models.common``): seeded init,
RMSNorm, RoPE and the training loss."""

from __future__ import annotations

import torch


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


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


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
