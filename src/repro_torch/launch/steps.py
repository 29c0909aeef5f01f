"""Step functions (``repro.launch.steps``): the train step and the serving
steps the drivers run.

``make_train_step`` returns a functional step, as the reference's
(``jax.value_and_grad`` then AdamW): it reads the params and the optimizer
state and returns new ones, writing none of the old — the gradients come
from ``torch.autograd.grad``, never accumulated into ``.grad`` — so
``runtime.fault.retry_step`` may run it again after a failure.  On the card
the MLP's forward is the ``fused_swiglu`` kernel inside its autograd op
(``kernels/ops.py``), at M = B·S rows.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import cross_entropy_loss
from repro_torch.optim import adamw_update, pod_allreduce_compressed, warmup_cosine
from repro_torch.optim.adamw import param_leaves


def _feed(model, batch) -> tuple[dict, torch.Tensor]:
    """The forward's inputs and the labels of a batch: {"tokens": [B, S+1]}
    or {"embeds": [B, S, d], "labels": [B, S]}, + "enc" [B, n_enc, d]."""
    if "tokens" in batch:
        tokens = model._dev(batch["tokens"])
        feed, labels = {"tokens": tokens[:, :-1]}, tokens[:, 1:]
    else:
        feed, labels = {"embeds": batch["embeds"]}, model._dev(batch["labels"])
    if "enc" in batch:
        feed["enc"] = batch["enc"]
    return feed, labels


def loss_and_grads(model, params, batch) -> tuple[torch.Tensor, list]:
    """Mean-token cross-entropy of ``batch`` and its gradient, one tensor per
    parameter (``param_leaves`` order; zeros for a parameter the loss does
    not reach).  Every parameter must require a gradient."""
    feed, labels = _feed(model, batch)
    leaves = param_leaves(params)
    loss = cross_entropy_loss(model.forward_train(params, **feed), labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _world_group(device):
    """The default process group as a ``parallel.TPGroup`` of this rank."""
    import torch.distributed as dist

    from repro_torch.parallel.group import TPGroup

    world = dist.get_world_size()
    return TPGroup(pg=dist.group.WORLD, rank=dist.get_rank(), world=world, device=device,
                   backend=dist.get_backend(), ranks=tuple(range(world)))


def make_train_step(cfg, model, *, peak_lr=3e-4, warmup_steps=100, total_steps=10_000,
                    grad_compress_pod: bool = False):
    """fwd + CE loss + bwd + AdamW at the ``warmup_cosine`` learning rate of
    the state's step.  ``train_step(params, opt_state, batch) -> (params,
    opt_state, loss)``; the batch as ``_feed`` takes it.

    ``grad_compress_pod`` averages the gradient over the "pod" group — the
    process group, when one is initialized, its ranks data-parallel
    replicas, each with its own rows — through
    ``optim.pod_allreduce_compressed``, the int8 exchange.  A single-process
    run has no such group, and the flag changes nothing, as in the reference
    without a "pod" mesh axis.  A model sharded over a group of several
    ranks does not train yet (ROADMAP item 13e)."""
    group = getattr(model, "group", None)
    if group is not None and group.world > 1:
        raise NotImplementedError("tensor-parallel training (a gradient through the "
                                  "collectives) is ROADMAP item 13e")
    pod = None
    if grad_compress_pod and torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        pod = _world_group(model.device)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch)
        if pod is not None:
            grads = [pod_allreduce_compressed(g, pod) for g in grads]
        lr = warmup_cosine(opt_state.step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                           total_steps=total_steps)
        new_params, new_opt = adamw_update(grads, opt_state, params, lr)
        return new_params, new_opt, loss

    return train_step


def make_prefill_step(cfg, model, *, S_max: int):
    """Full forward populating the KV cache; emits (next-token ids [B, 1], cache)."""

    def prefill_step(params, batch):
        feed = {"tokens": batch["tokens"]} if "tokens" in batch else {"embeds": batch["embeds"]}
        if "enc" in batch:
            feed["enc"] = batch["enc"]
        logits, cache = model.prefill(params, S_max=S_max, **feed)
        return logits[:, -1, :].argmax(-1).to(torch.int32)[:, None], cache

    return prefill_step


def make_decode_step(cfg, model, *, S_max: int):
    """One new token against a cache of S_max rows."""

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens, S_max)
        return logits[:, -1, :].argmax(-1).to(torch.int32)[:, None], cache

    return serve_step


def make_spec_verify_step(cfg, model, *, S_max: int, bs: int):
    """The paper's target-side verification forward: ``bs`` tree nodes under
    a non-square mask; returns (argmax [B, bs], cache)."""

    def verify_step(params, cache, tokens, positions, rows, mask):
        logits, cache = model.spec_forward(params, cache, tokens, positions, rows, mask)
        return logits.argmax(-1).to(torch.int32), cache

    return verify_step
