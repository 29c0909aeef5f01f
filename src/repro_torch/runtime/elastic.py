"""Elastic re-sharding (``repro.runtime.elastic``): a model's weights onto a
tensor-parallel group of another degree.

The reference re-places a parameter tree under a new mesh's shardings
(``reshard_params``).  Here the shards of a group of p ranks are joined
into the whole, unpadded weights (``parallel.shard.unshard_params``) and
cut again, padded for the new degree, as rank r of a group of q keeps
them.  The reference's ``submeshes``, ``reshard_engine`` and
``replan_split`` move an engine onto disjoint target and draft groups,
which ROADMAP item 13c ports.
"""

from __future__ import annotations

from repro_torch.models.transformer import DecoderLM
from repro_torch.parallel.shard import Shard, unshard_params


def reshard_params(cfg, shards: list, rank: int, world: int, *,
                   moe_form: str = "tp") -> DecoderLM:
    """Rank ``rank`` of ``world``'s ``DecoderLM`` of a model of ``cfg``
    whose weights are ``shards`` (one ``DecoderLM`` per rank of the old
    group, in rank order; the MoE cut in ``moe_form`` on both)."""
    return Shard(cfg, rank, world, moe_form).params(unshard_params(cfg, shards, moe_form))
