"""AdamW with f32 master copies (``repro.optim.adamw``).

Params may be bf16; masters and moments are f32, and the update casts back
to the param dtype.  The update is functional, as the reference's: it reads
the old params and state, writes none of them, and returns new tensors, so
a step that fails part-way (``runtime.fault.retry_step``) can run again
from the same state.  Params are a module (its ``parameters()`` in order)
or a sequence of tensors; the state holds one tensor per parameter in that
order.  The update runs leaf by leaf, so its temporaries are one tensor's
size, not the model's.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int  # updates applied so far (a host int; the reference's i32 scalar)
    mu: list  # first moment per parameter, f32
    nu: list  # second moment per parameter, f32
    master: list  # f32 master copy per parameter (never the parameter's storage)


def param_leaves(params) -> list:
    """The parameter tensors of ``params``, in the state's order."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params)


def with_leaves(params, leaves):
    """``params`` rebuilt around new tensors, one per leaf in order: a new
    module of the same structure (each parameter keeps its requires_grad),
    or a list.  ``params`` itself is left as it was."""
    if not isinstance(params, torch.nn.Module):
        return list(leaves)
    old = param_leaves(params)
    if len(old) != len(leaves):
        raise ValueError(f"{len(leaves)} tensors for {len(old)} parameters")
    memo = {id(p): torch.nn.Parameter(t, requires_grad=p.requires_grad)
            for p, t in zip(old, leaves)}
    return copy.deepcopy(params, memo)


def adamw_init(params) -> AdamWState:
    leaves = [p.detach() for p in param_leaves(params)]
    return AdamWState(
        step=0,
        mu=[torch.zeros_like(p, dtype=torch.float32) for p in leaves],
        nu=[torch.zeros_like(p, dtype=torch.float32) for p in leaves],
        # a copy, also for f32 params: a master that aliased its param would
        # see any in-place write to the param
        master=[p.to(torch.float32, copy=True) for p in leaves],
    )


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def global_norm(grads, group=None, weights=None) -> torch.Tensor:
    """The gradient's global norm: the square root of a sum of per-leaf sums
    of squares, as the reference's Python sum.

    With ``group`` (a ``parallel.TPGroup`` whose ranks each hold a part of
    the model) and ``weights`` (one per leaf, ``parallel.shard.Shard.
    norm_weights``) it is the norm of the whole model's gradient: the
    leaves of weight None are whole on every rank and count once; the
    others' squares, times their weight, are summed over the group (one
    all-reduce).  Every rank gets the same bits."""
    if group is None or group.world == 1:
        return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    whole = [torch.sum(torch.square(g)) for g, w in zip(grads, weights) if w is None]
    parts = [torch.sum(torch.square(g) * w) for g, w in zip(grads, weights) if w is not None]
    total = group.all_reduce(sum(parts, grads[0].new_zeros(())).reshape(1))[0]
    return torch.sqrt(sum(whole, total.new_zeros(())) + total)


def adamw_update(grads, state: AdamWState, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0, group=None, norm_weights=None):
    """Returns (new_params, new_state).  ``grads``: one tensor per parameter
    (None counts as zeros); ``lr``: a scalar (the schedule's output).

    The global-norm clip scales every gradient by min(1, clip / ||g||);
    bias correction uses the new step; weight decay is decoupled and hits
    every leaf.  The arithmetic is the reference's, operation for
    operation, in f32.  ``group`` and ``norm_weights``: a tensor-parallel
    rank's (``global_norm``), whose clip is then the whole model's."""
    leaves = param_leaves(params)
    grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
             for p, g in zip(leaves, grads)]
    gnorm = global_norm(grads, group, norm_weights)
    scale = torch.minimum(_f32(1.0), grad_clip / torch.maximum(gnorm, _f32(1e-9)))

    step = state.step + 1
    t = _f32(step)
    bc1 = 1.0 - _f32(b1) ** t
    bc2 = 1.0 - _f32(b2) ** t
    lr = _f32(lr)  # bc1, bc2 and lr: 0-d CPU tensors, passed to the card as scalars

    mu, nu, master, new_leaves = [], [], [], []
    for p, g, m, v, w in zip(leaves, grads, state.mu, state.nu, state.master):
        g = g * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        w = w - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * w)
        mu.append(m)
        nu.append(v)
        master.append(w)
        new_leaves.append(w.to(p.dtype, copy=True))
    return with_leaves(params, new_leaves), AdamWState(step=step, mu=mu, nu=nu, master=master)
