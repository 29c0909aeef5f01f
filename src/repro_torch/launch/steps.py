"""Step functions (``repro.launch.steps``): the train step and the serving
steps the drivers run.

``make_train_step`` returns a functional step, as the reference's
(``jax.value_and_grad`` then AdamW): it reads the params and the optimizer
state and returns new ones, writing none of the old — the gradients come
from ``torch.autograd.grad``, never accumulated into ``.grad`` — so
``runtime.fault.retry_step`` may run it again after a failure.  On the card
the MLP's forward is the ``fused_swiglu`` kernel inside its autograd op
(``kernels/ops.py``), at M = B·S rows.

A model sharded over a group of several ranks trains too (the reference's
``--mesh-model``, where GSPMD makes the backward): every rank computes the
same loss from the same gathered logits, the forward's collectives carry
the gradient (``parallel.group``: ``reduce``, ``copy``, ``sum_both``,
``gather``; with ``seq_shard`` also ``seq_copy``, ``seq_reduce`` and
``split``), ``parallel.shard.Shard.reduce_grads`` sums what they leave
partial (``sharded_grads``, the step's gradient half), and the clip takes
the whole model's norm over the group.  The gradient of a tensor every
rank holds whole is then the whole gradient, the same bits on every rank;
a split tensor's is the rank's part of it.  ``seq_shard`` (the reference's
``seq_shard_acts``, which its dry run trains and prefills with) splits the
residual stream's sequence over the model's ranks between the blocks: the
same gradients, each rank holding its rows of the residual only.
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


def loss_and_grads(model, params, batch, remat: str = "none",
                   seq_shard: bool = False) -> tuple[torch.Tensor, list]:
    """Mean-token cross-entropy of ``batch`` and its gradient, one tensor per
    parameter (``param_leaves`` order; zeros for a parameter the loss does
    not reach).  Every parameter must require a gradient.  On a sharded
    model each gradient is what this rank's backward gives, before
    ``Shard.reduce_grads``.  ``remat``, ``seq_shard``: ``Model.forward_train``'s."""
    feed, labels = _feed(model, batch)
    leaves = param_leaves(params)
    loss = cross_entropy_loss(model.forward_train(params, **feed, remat=remat,
                                                  seq_shard=seq_shard), labels)
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


def data_mean(grads: list, loss: torch.Tensor, data) -> tuple[list, torch.Tensor]:
    """The mean of every gradient and of the loss over the data-parallel
    ranks ``data``: one exact f32 all-reduce of them all, flattened, divided
    by the ranks — the global batch's mean, as GSPMD's over the
    reference's "data" axis.  Every rank gets the same bits."""
    flat = torch.cat([g.float().reshape(-1) for g in grads] + [loss.float().reshape(1)])
    flat = data.all_reduce(flat) / data.world
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].reshape(g.shape).to(g.dtype))
        off += g.numel()
    return out, flat[off]


def _model_group(model):
    """The group ``model`` is sharded over, or None (one rank)."""
    group = getattr(model, "group", None)
    return group if group is not None and group.world > 1 else None


def sharded_grads(model, params, batch, data=None, compress: bool = False,
                  remat: str = "none", seq_shard: bool = False):
    """The train step's gradient half: ``loss_and_grads``, then on a model
    sharded over a group ``Shard.reduce_grads``, then the mean over the
    data-parallel ranks ``data`` — exact (``data_mean``), or with
    ``compress`` the gradient by the int8 exchange
    (``optim.pod_allreduce_compressed``) and the loss exactly.  -> (loss,
    grads), one gradient per parameter in ``param_leaves`` order."""
    loss, grads = loss_and_grads(model, params, batch, remat, seq_shard)
    group = _model_group(model)
    if group is not None:
        grads = model.shard.reduce_grads(params, grads, group, seq_shard)
    if data is not None and data.world > 1:
        mean, loss = data_mean([] if compress else grads, loss, data)
        grads = [pod_allreduce_compressed(g, data) for g in grads] if compress else mean
    return loss, grads


def make_train_step(cfg, model, *, peak_lr=3e-4, warmup_steps=100, total_steps=10_000,
                    grad_compress_pod: bool = False, data=None, remat: str = "none",
                    seq_shard: bool = False):
    """fwd + CE loss + bwd + AdamW at the ``warmup_cosine`` learning rate of
    the state's step.  ``train_step(params, opt_state, batch) -> (params,
    opt_state, loss)``; the batch as ``_feed`` takes it.

    ``model`` may be sharded over a group (``models.api.make_model(...,
    group=)``): the step then runs ``sharded_grads`` (the loss,
    ``torch.autograd.grad``, ``Shard.reduce_grads``, the data mean), the
    clip over the group, AdamW.

    ``data``: the data-parallel ranks (a ``parallel.TPGroup``: the ranks
    that hold the same shard, each with its own rows of the global batch;
    ``launch.mesh.make_train_ranks``), over which ``sharded_grads``
    averages, by the int8 exchange with ``grad_compress_pod``.

    Without ``data``, ``grad_compress_pod`` averages the gradient over the
    whole process group, when one is initialized and the model is not
    sharded over it (its ranks data-parallel replicas; each returns its own
    rows' loss); a single-process run has no such group, and the flag
    changes nothing, as in the reference without a "pod" mesh axis.

    ``remat="full"`` recomputes each unit of the plan in the backward (the
    reference's ``remat="full"``, which its dry run trains with): the same
    gradients, the residual between units the only activation kept.

    ``seq_shard`` splits that residual, and every norm and residual add,
    over the model's ranks by sequence (``Model.forward_train``)."""
    group = _model_group(model)
    pod = None
    if data is None and grad_compress_pod and torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        pod = _world_group(model.device)
        if group is not None:
            if pod.world != group.world:
                raise ValueError("grad_compress_pod on a sharded model needs its data-parallel "
                                 "group: pass data= (launch.mesh.make_train_ranks)")
            pod = None  # the world is the model's group: no data-parallel ranks
    weights = []  # Shard.norm_weights of the params, made at the first step

    def train_step(params, opt_state, batch):
        loss, grads = sharded_grads(model, params, batch, data, compress=grad_compress_pod,
                                    remat=remat, seq_shard=seq_shard)
        if pod is not None:
            grads = [pod_allreduce_compressed(g, pod) for g in grads]
        if group is not None and not weights:
            weights.extend(model.shard.norm_weights(params))
        lr = warmup_cosine(opt_state.step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                           total_steps=total_steps)
        new_params, new_opt = adamw_update(grads, opt_state, params, lr, group=group,
                                           norm_weights=weights or None)
        return new_params, new_opt, loss

    return train_step


def make_prefill_step(cfg, model, *, S_max: int, seq_shard: bool = False):
    """Full forward populating the KV cache; emits (next-token ids [B, 1],
    cache).  ``seq_shard``: ``Model.prefill``'s."""

    def prefill_step(params, batch):
        feed = {"tokens": batch["tokens"]} if "tokens" in batch else {"embeds": batch["embeds"]}
        if "enc" in batch:
            feed["enc"] = batch["enc"]
        logits, cache = model.prefill(params, S_max=S_max, seq_shard=seq_shard, **feed)
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
