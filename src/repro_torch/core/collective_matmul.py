"""Collective matmul (``repro.core.collective_matmul``): the paper's fused
GEMM + all-reduce (§3.3) as a product and collectives over a tensor-parallel
group.

The reference runs both schedules under ``shard_map`` and computes the
products in XLA, outside any Pallas kernel; here they are ``torch.matmul``
and ``torch.distributed`` collectives on a ``parallel.TPGroup``:

  matmul_allreduce    — y = x @ w with w split by rows (K) over the ranks:
                        the rank's product of its K columns, then a
                        reduce-scatter over N and an all-gather (the
                        all-reduce as its two halves; the output replicated).
  matmul_ag_pipelined — y = x @ w with x split by columns (K): the K-shards
                        of x ride a ring of p steps, each rank multiplying
                        the shard it holds by the matching rows of w while
                        the next shard is in flight (isend/irecv).

Both use collectives that torch 2.11 and 2.13 name alike (``reduce_scatter``
and ``all_gather`` in their list forms, ``batch_isend_irecv``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def matmul_allreduce(x: torch.Tensor, w_shard: torch.Tensor, group) -> torch.Tensor:
    """x [M, K] (the same on every rank) @ w, where ``w_shard`` [K/p, N] is
    this rank's rows of w; N must split over the p ranks.  Returns [M, N]
    on every rank."""
    p, r = group.world, group.rank
    k = w_shard.shape[0]
    N = w_shard.shape[1]
    if x.shape[1] != k * p or N % p:
        raise ValueError(f"matmul_allreduce: x{tuple(x.shape)} and a [K/p, N] shard "
                         f"{tuple(w_shard.shape)} over {p} ranks (N must split over them)")
    part = x[:, r * k:(r + 1) * k] @ w_shard
    mine = torch.empty((x.shape[0], N // p), dtype=part.dtype, device=part.device)
    dist.reduce_scatter(mine, [c.contiguous() for c in part.chunk(p, dim=1)], group=group.pg)
    return group.all_gather(mine, dim=1)


def matmul_ag_pipelined(x_shard: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """x @ w, where ``x_shard`` [M, K/p] is this rank's columns of x and w
    [K, N] is whole on every rank.  Step i multiplies the shard that
    arrived from i ranks back by its rows of w while the rank passes it on
    to the next rank.  Returns [M, N] on every rank."""
    p, r = group.world, group.rank
    ks = x_shard.shape[1]
    if w.shape[0] != ks * p:
        raise ValueError(f"matmul_ag_pipelined: a [M, K/p] shard {tuple(x_shard.shape)} over "
                         f"{p} ranks against w{tuple(w.shape)}")
    nxt, prv = group.ranks[(r + 1) % p], group.ranks[(r - 1) % p]
    cur = x_shard.contiguous()
    acc = torch.zeros((x_shard.shape[0], w.shape[1]), dtype=x_shard.dtype, device=x_shard.device)
    for i in range(p):
        src = (r - i) % p  # the K-shard ``cur`` holds at step i
        reqs = []
        if i < p - 1:
            buf = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, cur, nxt, group.pg),
                                           dist.P2POp(dist.irecv, buf, prv, group.pg)])
        acc = acc + cur @ w[src * ks:(src + 1) * ks]
        for req in reqs:
            req.wait()
        if i < p - 1:
            cur = buf
    return acc
