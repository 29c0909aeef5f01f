"""Weights of the JAX reference, as numpy, into the port's modules.

The parity tests build a model with ``repro`` (``Model.init(PRNGKey)``),
unbox every ``Param`` to a numpy array, and hand the tree to
``params_from_numpy``.  The tree keeps the reference's layout: ``groups``
holds one unit tuple per group of the plan, one dict per block of the unit,
whose leaves carry the stacked repeat axis U first
(``repro/models/transformer.py:307-316``).  A dense, moe or cross entry
holds ``ln1``, ``attn`` (GQA or MLA weights), ``ln2`` and ``mlp`` — for a
moe block the router, the routed experts and, under ``shared``, the shared
experts.  A zamba2 tree also holds the model-level ``shared_attn`` block
(no U axis), and each ``shared`` entry of the unit its per-invocation
``in_w``; an rwkv6 entry holds ``ln1``, ``ln2`` and ``tm``, the parameters
of its time-mix and channel-mix.

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
    MoEBlock,
    RWKV6Block,
    SharedBlock,
    check_plan,
)
from repro_torch.quant import QuantizedLinear


def params_from_numpy(cfg, tree, device) -> DecoderLM:
    device = resolve_device(device)

    def t(a):
        return torch.tensor(a, dtype=getattr(torch, cfg.param_dtype), device=device)

    def block(kind, p, u=None):
        def one(a):
            return t(a if u is None else a[u])

        def pick(d):
            return {k: one(v) for k, v in d.items()}

        ln1, ln2 = one(p["ln1"]), one(p["ln2"])
        if kind == "moe":
            mlp = dict(p["mlp"])
            shared = mlp.pop("shared", None)
            return MoEBlock(ln1, pick(p["attn"]), ln2, pick(mlp),
                            None if shared is None else pick(shared))
        return DenseBlock(ln1, pick(p["attn"]), ln2, pick(p["mlp"]))

    layers = []
    for (unit_def, U), unit in zip(check_plan(cfg), tree["groups"]):
        for u in range(U):
            for kind, p in zip(unit_def, unit):
                if kind in ("dense", "moe", "cross"):
                    layers.append(block(kind, p, u))
                elif kind == "mamba2":
                    layers.append(Mamba2Block(t(p["ln"][u]), m2.params_from_reference(
                        {k: t(v[u]) for k, v in p["mamba"].items()})))
                elif kind == "rwkv6":
                    layers.append(RWKV6Block(t(p["ln1"][u]), rk.params_from_reference(
                        {k: t(v[u]) for k, v in p["tm"].items()}), t(p["ln2"][u])))
                else:
                    layers.append(SharedBlock(t(p["in_w"][u])))
    shared = None if tree.get("shared_attn") is None else block("dense", tree["shared_attn"])
    return DecoderLM(t(tree["embed"]), t(tree["final_norm"]), t(tree["lm_head"]), layers, shared)


def quantized_from_numpy(qweight, scales, zeros, group_size: int, device) -> QuantizedLinear:
    """The reference's ``QuantizedLinear``, unboxed to numpy (int8 [K//2, N]
    packed, f32 [K//g, N] scales and zeros), as the port's on ``device``."""
    device = resolve_device(device)
    return QuantizedLinear(torch.tensor(qweight, dtype=torch.int8, device=device),
                           torch.tensor(scales, dtype=torch.float32, device=device),
                           torch.tensor(zeros, dtype=torch.float32, device=device),
                           int(group_size))
