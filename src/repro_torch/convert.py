"""Weights of the JAX reference, as numpy, into the port's modules.

The parity tests build a model with ``repro`` (``Model.init(PRNGKey)``),
unbox every ``Param`` to a numpy array, and hand the tree to
``params_from_numpy``.  The tree keeps the reference's layout: ``groups[0]``
is a one-block unit tuple whose leaves carry the stacked layer axis U first
(``repro/models/transformer.py:307-316``).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import DenseBlock, DenseLM, check_dense


def params_from_numpy(cfg, tree, device) -> DenseLM:
    device = resolve_device(device)
    U = check_dense(cfg)

    def t(a):
        return torch.tensor(a, dtype=getattr(torch, cfg.param_dtype), device=device)

    (unit,) = tree["groups"][0]
    layers = [
        DenseBlock(t(unit["ln1"][u]), {k: t(v[u]) for k, v in unit["attn"].items()},
                   t(unit["ln2"][u]), {k: t(v[u]) for k, v in unit["mlp"].items()})
        for u in range(U)
    ]
    return DenseLM(t(tree["embed"]), t(tree["final_norm"]), t(tree["lm_head"]), layers)
