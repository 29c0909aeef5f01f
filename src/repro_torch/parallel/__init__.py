"""Tensor parallelism over ``torch.distributed`` (``repro.sharding``,
``repro.core.collective_matmul``).

* ``group``: ``TPGroup`` (a process group with the collectives the sharded
  forward uses, and their forms with a gradient for training), ``init_tp``
  and ``make_train_groups`` (a training world's model and data ranks);
* ``rules``: ``DEFAULT_RULES`` and ``spec_for``, over the weights' logical
  axes (``models.axes``);
* ``shard``: ``Shard`` (one rank's padded shards and per-rank config, and
  what a rank's gradient needs after the backward), ``attn_layout``,
  ``shard_params``;
* ``spawn``: ``run_ranks``, which runs a rank program on new processes
  (the tests, ``chip_smoke.py``); ``workers``: those rank programs.

A ``Model`` made with a group (``models.api.make_model(cfg, device,
group=...)``) holds this rank's shards and sums, gathers and looks up over
the group in its forward; the speculative engine runs the same host loop
on every rank; ``launch.steps.make_train_step`` trains it.
"""

from repro_torch.parallel.group import (
    COLLECTIVES,
    TPGroup,
    init_tp,
    reset_collective_counts,
    shutdown_tp,
)
from repro_torch.parallel.rules import DEFAULT_RULES, spec_for

__all__ = ["COLLECTIVES", "DEFAULT_RULES", "TPGroup", "init_tp", "reset_collective_counts",
           "shutdown_tp", "spec_for"]
