"""int8 gradient compression (``repro.optim.compression``).

Per-tensor symmetric int8 with an f32 scale cuts a gradient's bytes 4x at a
worst-case error of half a step of the int8 grid.  ``pod_allreduce_compressed``
is the reference's cross-pod mean over a process group (``parallel.TPGroup``,
the data-parallel replicas): every rank's int8 tensor and scale are gathered,
dequantised, summed and divided by the ranks."""

from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor):
    """x (any float shape) -> (int8 tensor, f32 scale)."""
    x32 = x.float()
    amax = x32.abs().max()
    scale = torch.maximum(amax / 127.0, torch.tensor(1e-12, dtype=torch.float32,
                                                      device=x.device))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def pod_allreduce_compressed(g: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``g`` over ``group``'s ranks, exchanged as int8: the same
    on every rank (every rank sums the same gathered values in rank order)."""
    q, scale = compress_int8(g)
    qs = group.all_gather(q[None], dim=0)  # [p, ...] int8
    ss = group.all_gather(scale.reshape(1), dim=0)  # [p]
    return (mean_dequantized(qs, ss)).to(g.dtype)


def mean_dequantized(qs: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """sum_i ss[i] * qs[i] / p in f32, summed in rank order."""
    total = ss[0] * qs[0].float()
    for i in range(1, qs.shape[0]):
        total = total + ss[i] * qs[i].float()
    return total / qs.shape[0]
