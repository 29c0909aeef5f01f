"""int8 gradient compression (``repro.optim.compression``).

Per-tensor symmetric int8 with an f32 scale cuts a gradient's bytes 4x at a
worst-case error of half a step of the int8 grid.  The reference uses it for
the cross-pod all-reduce (``pod_allreduce_compressed``), a collective that
comes with tensor parallelism (ROADMAP item 13b)."""

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
