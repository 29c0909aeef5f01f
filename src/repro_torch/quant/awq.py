"""Groupwise int4 weight quantization, AWQ-style (``repro.quant.awq``).

The paper serves every transformer-layer weight as 4-bit AWQ with group
size 128.  As in the reference, the serving-side artifact is reproduced
exactly — a scale and a zero point per (group, column), nibble-packed
storage, consumed by the dequant-GEMM ``ops.int4_matmul`` — and AWQ's
activation-aware scale search is replaced by min/max calibration.

Packing: values in [0, 15]; byte b of column n holds k = 2b in the low
nibble and k = 2b + 1 in the high nibble, as ``csrc/int4_matmul.cu``
unpacks them.  Nibbles are taken from a ``uint8`` view: ``>>`` on an
``int8`` tensor is an arithmetic shift.  Every function runs on the device
of its input and gives the reference's values bit for bit (``torch.round``
rounds half to even, as ``jnp.round`` does).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedLinear(NamedTuple):
    qweight: torch.Tensor  # int8 [K//2, N] packed nibbles
    scales: torch.Tensor  # f32 [K//g, N]
    zeros: torch.Tensor  # f32 [K//g, N], a float zero point (never rounded)
    group_size: int


def quantize_groupwise(w: torch.Tensor, group_size: int = 128) -> QuantizedLinear:
    """w: [K, N] float.  Min/max asymmetric 4-bit per (group, column)."""
    K, N = w.shape
    if K % group_size or K % 2:
        raise ValueError(f"quantize_groupwise: K={K} must be even and a multiple of "
                         f"group_size={group_size}")
    wg = w.to(torch.float32).reshape(K // group_size, group_size, N)
    wmin = wg.amin(dim=1)  # [G, N]
    wmax = wg.amax(dim=1)
    scales = torch.clamp_min((wmax - wmin) / 15.0, 1e-8)
    zeros = -wmin / scales  # q = w/s + z in [0, 15]
    q = torch.round(wg / scales[:, None, :] + zeros[:, None, :]).clamp(0, 15)
    return QuantizedLinear(pack_int4(q.reshape(K, N).to(torch.int8)), scales, zeros, group_size)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] values 0..15 -> packed int8 [K//2, N]."""
    K, N = q.shape
    if K % 2:
        raise ValueError(f"pack_int4: K={K} must be even")
    pairs = q.reshape(K // 2, 2, N).to(torch.uint8)
    return (pairs[:, 0, :] | (pairs[:, 1, :] << 4)).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed int8 [K//2, N] -> int8 [K, N] values 0..15."""
    p = packed.view(torch.uint8)
    K2, N = p.shape
    return torch.stack([p & 0xF, (p >> 4) & 0xF], dim=1).reshape(K2 * 2, N).to(torch.int8)


def dequantize(q: QuantizedLinear) -> torch.Tensor:
    """The dense f32 [K, N] weight, (q - z) * s (the oracle of the kernel)."""
    w = unpack_int4(q.qweight).to(torch.float32)
    s = q.scales.to(torch.float32).repeat_interleave(q.group_size, dim=0)
    z = q.zeros.to(torch.float32).repeat_interleave(q.group_size, dim=0)
    return (w - z) * s
