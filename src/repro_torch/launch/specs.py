"""Meta-device stand-ins for every input of a dry-run cell, for ONE rank
(``repro.launch.specs``'s counterpart).

``cell_specs(arch, shape, mesh)`` returns (step_fn, args, meta) such that
``step_fn(*args)`` on meta tensors is that rank's production computation
for the (architecture x input shape) cell:

  train_*    -> train_step(params, opt_state, batch)   fwd + bwd + AdamW, remat="full"
  prefill_*  -> prefill_step(params, batch)            full forward + cache
  decode_* / long_* -> serve_step(params, cache, tokens)  one token vs the cache

Train and prefill steps split the residual stream's sequence over the
model ranks (``seq_shard``), as the reference's dry run turns on
``seq_shard_acts`` for them; ``cell_specs(..., seq_shard=False)`` counts
the whole-sequence form (its ``--flag seq_shard_acts=False``).

A mesh is ``launch.mesh.production_mesh``'s dict.  The rank's model is the
published config in bf16 (``COMPUTE_DTYPE``) sharded over a
``parallel.CountingGroup`` of ``mesh["model"]`` ranks, so its shapes are
``parallel.shard.Shard.local_cfg``'s; its weights are built on meta with no
draw.  The batch is split over the ("pod", "data") axes that divide it, as
the reference's ``_batch_axes``; a train step averages its gradient over
those ranks through a second ``CountingGroup``.

Two accepted differences from the reference move a rank's record (the dry
run lists them): the data ranks hold whole replicas of the model's shard
(the reference shards the weights' "embed" axis over "data" too), and the
cache's layout is per rank (KV heads by the rank's query heads, MLA's
latent whole; the reference shards the cache's sequence over "model").
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import replace

import torch

from repro_torch.configs import SHAPES, get_config, resolve_for_tp
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models.api import make_model
from repro_torch.optim import adamw_init
from repro_torch.parallel.group import CountingGroup

COMPUTE_DTYPE = "bfloat16"


def batch_axes(mesh: dict, dim: int) -> tuple[str, ...]:
    """('pod', 'data') filtered to the axes of ``mesh`` that divide ``dim``
    (dropped from the right first, as ``spec_for``'s partial fallback)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh)
    while axes:
        if dim % math.prod(mesh[a] for a in axes) == 0:
            return axes
        axes = axes[:-1]
    return ()


def data_ranks(mesh: dict, dim: int) -> int:
    """The ranks a batch of ``dim`` rows is split over."""
    return math.prod(mesh[a] for a in batch_axes(mesh, dim))


def published_config(arch: str) -> ModelConfig:
    """The published config with bf16 compute and weights."""
    return replace(get_config(arch), dtype=COMPUTE_DTYPE, param_dtype=COMPUTE_DTYPE)


def dryrun_config(arch: str, mesh: dict) -> ModelConfig:
    """The published config in bf16, heads and ff padded for the mesh's
    model ranks (``resolve_for_tp``, the paper's arbitrary-TP padding)."""
    return resolve_for_tp(published_config(arch), mesh.get("model", 1))


def rank_model(arch: str, mesh: dict, rank: int = 0):
    """The model of model-rank ``rank`` on meta."""
    tp = mesh.get("model", 1)
    group = CountingGroup(rank, tp, "meta", axis="model") if tp > 1 else None
    return make_model(published_config(arch), device="meta", group=group)


def param_specs(model, trainable: bool = False):
    """The rank's weights on meta (no draw)."""
    return model.init(0, trainable=trainable)


def opt_specs(params):
    """AdamW's state on meta: f32 moments and master per weight."""
    return adamw_init(params)


def cache_specs(model, B: int, S_max: int, length: int = 0) -> dict:
    """The rank's cache of B rows and S_max positions on meta, ``length``
    rows filled."""
    cache = model.init_cache(B, S_max, COMPUTE_DTYPE)
    cache["len"] = length
    return cache


def batch_specs(cfg: ModelConfig, shape: ShapeCell, mesh: dict) -> dict:
    """The rank's rows of a train or prefill batch; the stub frontends give
    embeddings where the reference's do: musicgen frame embeddings (and
    labels), the vision model's patch embeddings ``enc`` beside its
    tokens."""
    B = shape.global_batch // data_ranks(mesh, shape.global_batch)
    S = shape.seq_len
    dt = getattr(torch, COMPUTE_DTYPE)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict = {}
    if shape.kind == "train":
        if cfg.embed_inputs:
            out["tokens"] = empty((B, S + 1), torch.int32)
        else:
            out["embeds"] = empty((B, S, cfg.d_model), dt)
            out["labels"] = empty((B, S), torch.int32)
    elif cfg.embed_inputs:
        out["tokens"] = empty((B, S), torch.int32)
    else:
        out["embeds"] = empty((B, S, cfg.d_model), dt)
    if cfg.n_enc_tokens:
        out["enc"] = empty((B, cfg.n_enc_tokens, cfg.d_model), dt)
    return out


def check_ranks_alike(arch: str, mesh: dict) -> None:
    """Raise unless every model rank of ``mesh`` runs the same shapes (one
    ``Shard.local_cfg``), so that one rank's count stands for all: it holds
    for every assigned architecture at 16 ranks."""
    from repro_torch.parallel.shard import Shard

    tp = mesh.get("model", 1)
    cfg = published_config(arch)
    if len({Shard(cfg, r, tp).local_cfg for r in range(tp)}) > 1:
        raise ValueError(f"{arch}: the {tp} model ranks run different shapes; one rank's "
                         "count would not stand for all")


def cell_specs(arch: str, shape_name: str, mesh: dict, rank: int = 0, seq_shard: bool = True):
    """-> (step_fn, args, meta dict) of model rank ``rank`` of the cell
    (every rank alike: ``check_ranks_alike``).  ``seq_shard`` applies to
    train and prefill cells (a decode step has no sequence to split); the
    meta dict says whether the step runs it."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step

    shape = SHAPES[shape_name]
    check_ranks_alike(arch, mesh)
    model = rank_model(arch, mesh, rank)
    cfg = model.cfg
    n_data = data_ranks(mesh, shape.global_batch)
    seq = seq_shard and shape.kind in ("train", "prefill")
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind, "seq_len": shape.seq_len,
            "seq_shard": seq,
            "global_batch": shape.global_batch, "rank": rank,
            "rank_batch": shape.global_batch // n_data, "data_ranks": n_data,
            "local_cfg": {k: v for k, v in dataclasses.asdict(model.run_cfg).items()
                          if k in ("n_heads", "n_kv_heads", "d_ff", "moe_d_ff", "vocab_size",
                                   "ssm_heads")}}

    if shape.kind == "train":
        params = param_specs(model, trainable=True)
        data = CountingGroup(0, n_data, "meta", axis="data") if n_data > 1 else None
        step = make_train_step(cfg, model, data=data, remat="full", seq_shard=seq)
        return step, (params, opt_specs(params), batch_specs(cfg, shape, mesh)), meta

    params = param_specs(model)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, model, S_max=shape.seq_len, seq_shard=seq)
        return step, (params, batch_specs(cfg, shape, mesh)), meta

    # decode / long-context decode: one token against a full cache of seq_len rows
    B, S = meta["rank_batch"], shape.seq_len
    cache = cache_specs(model, B, S, length=S - 1)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    return make_decode_step(cfg, model, S_max=S), (params, cache, tokens), meta
