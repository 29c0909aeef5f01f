"""Weights of the JAX reference, as numpy, into the port's modules.

The parity tests build a model with ``repro`` (``Model.init(PRNGKey)``),
unbox every ``Param`` to a numpy array, and hand the tree to
``params_from_numpy``.  The tree keeps the reference's layout: ``groups[0]``
is the unit tuple, one dict per block of the unit, whose leaves carry the
stacked repeat axis U first (``repro/models/transformer.py:307-316``); a
zamba2 tree also holds the model-level ``shared_attn`` block (no U axis),
and each ``shared`` entry of the unit its per-invocation ``in_w``; an rwkv6
entry holds ``ln1``, ``ln2`` and ``tm``, the parameters of its time-mix and
channel-mix.

``quantized_from_numpy`` does the same for the reference's
``QuantizedLinear`` (``repro.quant``), so both packages multiply by the
same packed bytes.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models.transformer import (
    DecoderLM,
    DenseBlock,
    Mamba2Block,
    RWKV6Block,
    SharedBlock,
    check_plan,
)
from repro_torch.quant import QuantizedLinear


def params_from_numpy(cfg, tree, device) -> DecoderLM:
    device = resolve_device(device)
    unit_def, U = check_plan(cfg)

    def t(a):
        return torch.tensor(a, dtype=getattr(torch, cfg.param_dtype), device=device)

    def dense(p, u=None):
        def pick(a):
            return t(a if u is None else a[u])

        return DenseBlock(pick(p["ln1"]), {k: pick(v) for k, v in p["attn"].items()},
                          pick(p["ln2"]), {k: pick(v) for k, v in p["mlp"].items()})

    unit = tree["groups"][0]
    layers = []
    for u in range(U):
        for kind, p in zip(unit_def, unit):
            if kind == "dense":
                layers.append(dense(p, u))
            elif kind == "mamba2":
                layers.append(Mamba2Block(t(p["ln"][u]), m2.params_from_reference(
                    {k: t(v[u]) for k, v in p["mamba"].items()})))
            elif kind == "rwkv6":
                layers.append(RWKV6Block(t(p["ln1"][u]), rk.params_from_reference(
                    {k: t(v[u]) for k, v in p["tm"].items()}), t(p["ln2"][u])))
            else:
                layers.append(SharedBlock(t(p["in_w"][u])))
    shared = dense(tree["shared_attn"]) if "shared" in unit_def else None
    return DecoderLM(t(tree["embed"]), t(tree["final_norm"]), t(tree["lm_head"]), layers, shared)


def quantized_from_numpy(qweight, scales, zeros, group_size: int, device) -> QuantizedLinear:
    """The reference's ``QuantizedLinear``, unboxed to numpy (int8 [K//2, N]
    packed, f32 [K//g, N] scales and zeros), as the port's on ``device``."""
    device = resolve_device(device)
    return QuantizedLinear(torch.tensor(qweight, dtype=torch.int8, device=device),
                           torch.tensor(scales, dtype=torch.float32, device=device),
                           torch.tensor(zeros, dtype=torch.float32, device=device),
                           int(group_size))
