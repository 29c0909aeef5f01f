"""Continuous-batching serving for the port (``repro.serving``).

``ContinuousBatchingRuntime`` serves a request queue through per-slot
admit / decode / retire lifecycles over one ``SpecEngine`` state, lockstep
or with async rounds; every output is byte-identical to a solo
``generate()``.  ``ShardedServingRuntime`` serves one global queue over N
engine replicas with least-loaded routing, in one process or, with
``fleet=``, over replicas on disjoint rank groups (one process per rank).  The queue, scheduler and stats
modules are copies of the reference's framework-neutral ones.

    rt = ContinuousBatchingRuntime(engine, tparams, dparams, n_slots=4)
    for i, prompt in enumerate(prompts):
        rt.submit(Request(rid=i, prompt=prompt, max_new=64))
    outputs = rt.run()          # {rid: [tokens]}
    print(rt.stats.report())    # TTFT / tok-s / occupancy / acceptance
"""

from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.runtime import (
    ContinuousBatchingRuntime,
    EngineMirror,
    EngineStepper,
    VirtualClock,
    WallClock,
)
from repro_torch.serving.router import ShardedServingRuntime, fleet_engines
from repro_torch.serving.scheduler import AdaptiveDepthController, SchedulerConfig
from repro_torch.serving.stats import (
    RequestRecord,
    ServerStats,
    fleet_report,
    merge_summary,
    percentile,
)

__all__ = [
    "AdaptiveDepthController",
    "ContinuousBatchingRuntime",
    "EngineMirror",
    "EngineStepper",
    "Request",
    "RequestQueue",
    "RequestRecord",
    "SchedulerConfig",
    "ServerStats",
    "ShardedServingRuntime",
    "VirtualClock",
    "WallClock",
    "fleet_engines",
    "fleet_report",
    "merge_summary",
    "percentile",
]
