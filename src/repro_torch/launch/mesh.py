"""Device and rank carving for disaggregated serving (``repro.launch.mesh``'s
``make_serving_mesh``, paper §3.1 GPU allocation).

The reference carves a slice of accelerators into a target mesh and a draft
mesh per replica.  The port carves CUDA devices the same way: a device
group is a tuple of ``torch.device``; replica i owns the devices
``[i*g, (i+1)*g)``, g = n_target + n_draft, the first ``n_target`` of them
its target group and the rest its draft group, so no device is shared
across replicas or across the two roles.  The ranks of split engines, one
process per card, are carved the same way (``make_serving_ranks``): one
split, or R replicas of one, each its own (target ranks, draft ranks).
A training world is carved into model and data ranks (``make_train_ranks``,
the reference's ("data", "model") mesh of ``launch/train.py
--mesh-model``).  Carving is pure: it only reads the devices it is given.
"""

from __future__ import annotations

import torch


def _visible_devices(device=None) -> list:
    """The visible CUDA devices, or ``[device]`` for a run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_serving_devices(n_target: int, n_draft: int, *, replicas: int = 1, devices=None,
                         device=None):
    """Disjoint (target group, draft group) device tuples per replica.

    ``devices`` defaults to the visible CUDA devices, or to ``[device]``
    when ``device`` is the CPU.  Returns one pair for ``replicas == 1`` and a
    list of ``replicas`` pairs otherwise.  With fewer than ``n_target +
    n_draft`` devices EVERY pair falls back to the first device, shared by
    both roles (one card, or the CPU).  A partial fit — enough devices for
    some replicas but not all — raises instead of overlapping later
    replicas onto the first device."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    devs = [torch.device(d) for d in devices] if devices is not None else _visible_devices(device)
    group = n_target + n_draft

    if len(devs) < group:  # all-or-nothing fallback: one shared device
        shared = ((devs[0],), (devs[0],))
        return shared if replicas == 1 else [shared for _ in range(replicas)]
    if len(devs) < group * replicas:
        raise ValueError(
            f"{len(devs)} devices cannot host {replicas} disjoint replicas of "
            f"{group} devices ({n_target} target + {n_draft} draft) — lower "
            f"the replica count or the per-replica device split")

    def carve(i: int):
        base = i * group
        return tuple(devs[base:base + n_target]), tuple(devs[base + n_target:base + group])

    if replicas == 1:
        return carve(0)
    return [carve(i) for i in range(replicas)]


def make_serving_ranks(ranks, n_target: int, n_draft: int | None = None, *,
                       replicas: int = 1):
    """(target ranks, draft ranks) pairs of split engines
    (``parallel/split.py``), carved from the world's ``ranks`` as
    ``make_serving_devices`` carves devices: replica i owns the ranks
    ``[i*g, (i+1)*g)``, g = n_target + n_draft, split target-first.
    ``n_draft`` defaults to the rest of one replica's share of the ranks.
    Returns one pair for ``replicas == 1`` and a list of ``replicas`` pairs
    otherwise.  A world of other than ``replicas * g`` ranks raises: there
    is no shared fallback, since each rank is a process of its own."""
    ranks = tuple(ranks)
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if n_draft is None:
        n_draft = len(ranks) // replicas - n_target
    group = n_target + n_draft
    if replicas == 1 and not 1 <= n_target < len(ranks):
        raise ValueError(f"a split of {len(ranks)} ranks needs 1 <= n_target < {len(ranks)}, "
                         f"got {n_target}")
    if n_target < 1 or n_draft < 1 or len(ranks) != group * replicas:
        raise ValueError(f"{len(ranks)} ranks are not {replicas} whole split(s) of {n_target} "
                         f"target + {n_draft} draft rank(s): a world of R * (n_target + "
                         "n_draft) ranks runs R replicas, each role at least one rank")

    def carve(i: int):
        base = i * group
        return ranks[base:base + n_target], ranks[base + n_target:base + group]

    return carve(0) if replicas == 1 else [carve(i) for i in range(replicas)]


def make_train_ranks(world: int, mesh_model: int) -> tuple[tuple, tuple]:
    """(model groups, data groups) of a training world of ``world`` ranks
    (the reference's ("data", "model") mesh, ``--mesh-model``): ``world /
    mesh_model`` model groups of ``mesh_model`` consecutive ranks, each
    holding one copy of the model sharded over it, and ``mesh_model`` data
    groups, the ranks that share a model index (each holding the same
    shard, with its own rows of the global batch).  Each group is a tuple
    of global ranks, in group order; ``mesh_model`` must divide the world."""
    if mesh_model < 1 or world < 1 or world % mesh_model:
        raise ValueError(f"--mesh-model {mesh_model} does not divide a world of {world} ranks")
    n_data = world // mesh_model
    model = tuple(tuple(range(i * mesh_model, (i + 1) * mesh_model)) for i in range(n_data))
    data = tuple(tuple(range(j, world, mesh_model)) for j in range(mesh_model))
    return model, data
