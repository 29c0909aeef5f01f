"""Elastic re-sharding (``repro.runtime.elastic``): a model's weights onto
a tensor-parallel group of another degree, and an engine onto another
target/draft split of the ranks.

The reference re-places a parameter tree under a new mesh's shardings
(``reshard_params``) and re-splits its devices into a target and a draft
mesh (``submeshes``, ``reshard_engine``).  Here the shards of a group of p
ranks are joined into the whole, unpadded weights
(``parallel.shard.unshard_params``) and cut again, padded for the new
degree, as rank r of a group of q keeps them; an engine's world of ranks is
split again target-first (``parallel.split.make_split``) and each rank cuts
its new role's model from the whole weights.
"""

from __future__ import annotations

from repro_torch.models.transformer import DecoderLM, map_params
from repro_torch.parallel.shard import Shard, unshard_params
from repro_torch.launch.mesh import make_serving_ranks
from repro_torch.parallel.split import make_split


def reshard_params(cfg, shards: list, rank: int, world: int, *,
                   moe_form: str = "tp") -> DecoderLM:
    """Rank ``rank`` of ``world``'s ``DecoderLM`` of a model of ``cfg``
    whose weights are ``shards`` (one ``DecoderLM`` per rank of the old
    group, in rank order; the MoE cut in ``moe_form`` on both)."""
    return Shard(cfg, rank, world, moe_form).params(unshard_params(cfg, shards, moe_form))


def submeshes(ranks, n_target: int) -> tuple[tuple, tuple]:
    """Split a flat list of ranks (or devices) target-first into (target,
    draft); a single one is shared by both roles, as the reference's CPU
    fallback shares its one device."""
    ranks = tuple(ranks)
    return (ranks, ranks) if len(ranks) == 1 else make_serving_ranks(ranks, n_target)


def reshard_engine(engine, tparams, dparams, world, n_target: int):
    """Re-split ``world`` (a ``parallel.TPGroup`` of every rank) as
    ``n_target``:(rest) and cut this rank's new role's model from its whole,
    unpadded weights (``tparams``/``dparams``: ``DecoderLM`` on any device,
    the host's included).  Returns (engine', tparams', dparams'): an engine
    of ``engine``'s class and config on the new split, and this rank's
    weights (None for the other role).  Caches are rebuilt by the next
    ``generate()`` (a new session); every rank must call it, in the same
    order."""
    split = make_split(world, n_target)
    T, D = split.models(engine.target.cfg, engine.draft.cfg)
    own = T if split.role == "target" else D
    shard = Shard(own.cfg, split.group.rank, split.group.world)
    whole = tparams if split.role == "target" else dparams
    params = map_params(whole, lambda where, key, t: shard.tensor(where, key,
                                                                  t.to(split.device)))
    new = type(engine)(T, D, engine.cfg, engine.S_max_t, engine.S_max_d, split=split)
    return (new, params, None) if split.role == "target" else (new, None, params)


def replan_split(prof_run, n_devices: int):
    """Re-run the allocation sweep after a topology change (a thin wrapper
    over ``core.scheduler.sweep_allocation``)."""
    from repro_torch.core.scheduler import sweep_allocation

    return sweep_allocation(n_devices, prof_run)
