"""The port's serving entry point: speculative decoding end to end.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 3 --max-new 48
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous --async-rounds
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --continuous --d 1
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous --replicas 2 --n-target 1 --n-draft 1

Runs the profile pass (paper §5.5: expansion depth d) unless ``--d`` is
given, then decodes a deterministic request stream through SpecEngine and
reports decoding speed and compression ratio per request.  ``--continuous``
serves a seeded Poisson trace through the continuous-batching runtime
(``repro_torch.serving``) instead: admissions backfill retiring slots
mid-flight, per-request telemetry is printed, and every output is checked
against a solo ``generate()`` run (``--no-verify`` skips it).
``--async-rounds`` drafts round N+1's tree while round N verifies (target
and draft on two CUDA streams of one card), ``--adaptive-depth`` and
``--deadline-s`` turn on the SLO-aware scheduler, ``--trace-out`` /
``--metrics-out`` record phase spans and metrics.  As in the reference CLI
the models are the smoke configs; ``build_engine(..., smoke=False)`` builds
the published widths.  ``--replicas N`` serves the continuous trace over N
engine replicas (one global queue, least-loaded routing, per-replica and
fleet telemetry, ``ShardedServingRuntime``); ``--n-target``/``--n-draft``
set the devices (or, under torchrun, the ranks) each replica asks for
(``launch/mesh.py``).  With fewer
devices than one replica asks for, every replica falls back to one shared
device (``--device``, default ``cuda``) and all replicas share one engine
object.

Launched under torchrun, one process per rank (``launch/mesh.py``'s
``make_serving_ranks`` carves a split):

* with ``WORLD_SIZE == n_target + n_draft`` the engine is split
  (``parallel/split.py``, the paper's disaggregated layout): the target on
  ranks ``[0, n_target)``, sharded over them, the draft on the rest, and
  the plan and the verdict cross between them each round;
* with fewer ranks both models are sharded over all of them and every rank
  runs the same engine (tensor parallelism on one shared group);
* with ``--continuous --replicas R`` and ``WORLD_SIZE == R * (n_target +
  n_draft)`` the world is carved into R such splits, replica i on the ranks
  ``[i*g, (i+1)*g)`` (``parallel.split.init_fleet``), and the router serves
  one global queue over them (``ShardedServingRuntime(fleet=)``): every
  rank runs the fleet loop and mirrors every replica's verdict, one
  exchange on the host per fleet round.

Any other world raises.  Rank 0 prints, after checking that every rank
emitted the same tokens.  The process group is NCCL's on CUDA (one card per
rank) and gloo's on the CPU.  Continuous serving under a group runs on a
virtual clock, so that every rank admits the same request at the same
round.  In a fleet each replica checks the requests it served against its
own solo ``generate()``, and with ``--trace-out`` each rank writes its own
replica's spans and the router's to a file that names the rank.

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --device cpu --continuous --depth 1 --requests 2
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --device cpu --n-target 1 --n-draft 1 --depth 1
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --device cpu --continuous --replicas 2 --n-target 1 \
      --n-draft 1 --depth 1 --requests 4
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.core.scheduler import candidate_depths
from repro_torch.data import make_request_stream, make_request_trace
from repro_torch.launch.mesh import make_serving_devices
from repro_torch.models.api import make_model
from repro_torch.obs.clock import monotonic


def build_engine(target_arch: str, draft_arch: str, *, smoke=True, mode="parallel",
                 bs=8, w=4, c=2, d=2, max_new=48, S_max=512, n_target=6, n_draft=2,
                 peaked=True, replicas=1, device=None, async_rounds=False, group=None,
                 split=None, fleet=None):
    """Build the serving engine(s).  Returns (engine | [engines], tparams,
    dparams, cfgT).

    Weights are the port's own seeded random init, drawn on ``device``
    (target seed 0, draft seed 1); ``peaked`` scales both lm_heads by 4 so
    greedy chains are peaked enough for realistic acceptance.  With
    ``replicas > 1`` the devices are carved into that many (target, draft)
    groups (``make_serving_devices``) and a list of engines is returned; a
    replica whose groups are replica 0's (the shared-device fallback)
    REUSES replica 0's engine object — states are per replica anyway.
    With ``group`` (a ``parallel.TPGroup``) both models are sharded over its
    ranks, the draft on a process group of its own, and the weights are
    this rank's shards of the same draws.  With ``split`` (a
    ``parallel.split.Split``) this rank builds its own role's model and its
    weights only (the other role's params are None): the engine is
    disaggregated.  With ``fleet`` (a ``parallel.split.Fleet`` of
    ``replicas`` splits) this rank builds its own replica's split engine so,
    and returns it at its replica's index of a list whose other entries
    mirror it (``serving.fleet_engines``)."""
    if fleet is not None:
        if replicas != fleet.replicas:
            raise ValueError(f"a fleet of {fleet.replicas} replicas, not {replicas}")
        split = fleet.split
    elif (group is not None or split is not None) and replicas != 1:
        raise ValueError("router replicas on rank groups run as a fleet of whole splits "
                         "(fleet=, parallel.split.init_fleet); one split or one "
                         "tensor-parallel group serves one replica")
    if group is not None or split is not None:
        device = (split.world if split is not None else group).device
    device = resolve_device(device)
    cfg = SpecConfig(bs=bs, w=w, c=c, d=d, mode=mode, max_new=max_new,
                     async_rounds=async_rounds)
    cfgT = get_config(target_arch, smoke=smoke)
    cfgD = get_config(draft_arch, smoke=smoke)
    assert cfgT.vocab_size == cfgD.vocab_size, "draft/target must share a vocab"
    if split is not None:
        T, D = split.models(cfgT, cfgD)
        own = T if split.role == "target" else D
        params = own.init(0 if split.role == "target" else 1)
        if peaked:
            params.lm_head.mul_(4.0)
        tp, dp = (params, None) if split.role == "target" else (None, params)
        eng = SpecEngine(T, D, cfg, S_max_t=S_max, S_max_d=S_max, split=split)
        if fleet is not None:
            from repro_torch.serving import fleet_engines

            eng = fleet_engines(fleet, eng)
        return eng, tp, dp, cfgT
    pairs = make_serving_devices(n_target, n_draft, replicas=replicas, device=device)
    pairs = [pairs] if replicas == 1 else pairs
    if group is not None:
        pairs = [(None, None)]  # each model on this rank's device
    T = make_model(cfgT, device, group)
    D = make_model(cfgD, device, None if group is None else group.new_group())
    tp = T.init(0)
    dp = D.init(1)
    if peaked:
        # random-init logits are near-uniform; scale the lm_head so greedy
        # chains are peaked enough for realistic acceptance behaviour
        tp.lm_head.mul_(4.0)
        dp.lm_head.mul_(4.0)

    def mk(devs_t, devs_d):
        return SpecEngine(T, D, cfg, S_max_t=S_max, S_max_d=S_max,
                          target_devices=devs_t, draft_devices=devs_d)

    engines = [mk(*pairs[0])]
    for pair in pairs[1:]:
        engines.append(engines[0] if pair == pairs[0] else mk(*pair))
    return (engines[0] if replicas == 1 else engines), tp, dp, cfgT


def profile_depth(eng: SpecEngine, tp, dp, prompt_len: int) -> str:
    """Profile pass: set ``eng.cfg.d`` to the lower candidate depth and
    return the report line."""
    prof = eng.profile(tp, dp, np.zeros((1, prompt_len), np.int32))
    d_lo, d_hi = candidate_depths(prof)
    eng.cfg = dataclasses.replace(eng.cfg, d=d_lo)
    return (f"profile: t_draft={prof.t_draft_s*1e3:.1f}ms t_target={prof.t_target_s*1e3:.1f}ms "
            f"-> d in {{{d_lo},{d_hi}}}, using d={d_lo}")


def _quiet(*args, **kwargs) -> None:
    pass


def every_rank(group, obj) -> list:
    """Every rank of ``group``'s ``obj``, in rank order."""
    import torch.distributed as dist

    every = [None] * group.world
    dist.all_gather_object(every, obj, group=group.pg)
    return every


def same_on_every_rank(group, obj) -> bool:
    """Whether every rank of ``group`` holds an equal ``obj`` (True without
    a group)."""
    if group is None:
        return True
    every = every_rank(group, obj)
    return all(o == every[0] for o in every)


def rank_path(path: str, rank: int) -> str:
    """``path`` with ``.rank<rank>`` before its suffix."""
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext}"


def run_continuous(args, engines, tp, dp, cfgT, group=None, fleet=None) -> dict:
    """Serve a Poisson trace through the continuous-batching runtime on a
    wall clock — one engine, or a fleet (a list of engines, ``--replicas``)
    through ``ShardedServingRuntime`` — print the per-request report (the
    fleet report for a fleet), and check every output against a solo
    ``generate()`` (``--no-verify`` skips it; a mismatch raises
    SystemExit).  With ``--trace-out``/``--metrics-out`` the run is traced
    and the round breakdown printed.  With ``group`` every rank serves the
    trace on a virtual clock (the same admissions on every rank), rank 0
    prints, and a rank that emitted other tokens than rank 0 raises
    SystemExit.  With ``fleet`` (``group`` its world) ``engines`` are the
    fleet's (this rank's own replica's and mirrors), each replica checks
    the requests it served against its own solo ``generate()``, and each
    rank writes its own trace.  Returns the results."""
    from repro_torch.obs import MetricsRegistry, Tracer, breakdown_report, phase_breakdown
    from repro_torch.serving import (ContinuousBatchingRuntime, Request, RequestQueue,
                                     SchedulerConfig, ShardedServingRuntime, VirtualClock,
                                     WallClock)

    say = print if group is None or group.rank == 0 else _quiet

    observed = bool(args.trace_out or args.metrics_out)
    tracer = Tracer() if observed else None
    metrics = MetricsRegistry() if observed else None
    scheduler = SchedulerConfig() if args.adaptive_depth else None
    trace = make_request_trace(
        cfgT.vocab_size, args.requests, rate_rps=args.rate,
        prompt_len=(max(4, args.prompt_len // 2), args.prompt_len),
        max_new=args.max_new, seed=0)
    routed = isinstance(engines, list)
    clock = WallClock() if group is None else VirtualClock(round_dt=0.05)
    kw = dict(n_slots=args.slots, queue=RequestQueue(cap=args.queue_cap), clock=clock,
              tracer=tracer, metrics=metrics, scheduler=scheduler)
    if routed:
        rt = ShardedServingRuntime(engines, tp, dp, fleet=fleet, **kw)
    else:
        rt = ContinuousBatchingRuntime(engines, tp, dp, **kw)
    eng = engines[0 if fleet is None else fleet.replica] if routed else engines
    label = f"{len(engines)} replicas x {args.slots} slots" if routed else f"{args.slots} slots"
    accepted = rt.submit_trace(
        Request(rid=r.rid, prompt=r.prompt, arrival_s=r.arrival_s, max_new=r.max_new,
                deadline_s=(r.arrival_s + args.deadline_s) if args.deadline_s else None)
        for r in trace)
    say(f"continuous: {accepted}/{len(trace)} requests accepted ({label}, "
          f"Poisson rate {args.rate}/s, queue cap {args.queue_cap}"
          + (f", deadline {args.deadline_s}s" if args.deadline_s else "")
          + (", adaptive depth" if scheduler else "")
          + (", async rounds" if eng.cfg.async_rounds else "") + ")")
    t0 = monotonic()
    results = rt.run()
    wall = monotonic() - t0
    say(rt.report() if routed else rt.stats.report())
    total = sum(len(v) for v in results.values())
    say(f"wall: {total} tokens in {wall:.1f}s ({total / wall:.1f} tok/s); "
          f"{rt.queue.rejected} shed by admission control")
    summary = rt.summary() if routed else rt.stats.summary()
    if summary["n_deadlined"]:
        say(f"SLO: {summary['slo_attainment']:.0%} of {summary['n_deadlined']} "
              f"deadlined requests met (slack p50 {summary['slack_p50_s']:+.3f}s "
              f"p10 {summary['slack_p10_s']:+.3f}s)")
    if observed and fleet is not None and args.trace_out:  # each rank its replica's spans
        path = tracer.write(rank_path(args.trace_out, group.rank))
        say(f"trace -> {path} (and one per rank beside it)")
    if observed and (group is None or group.rank == 0):
        bd = phase_breakdown(tracer)
        say(breakdown_report(bd))
        if args.trace_out and fleet is None:
            say(f"trace -> {tracer.write(args.trace_out)}")
        if args.metrics_out:
            slo = {k: summary[k] for k in ("n_deadlined", "slo_attainment",
                                           "slack_p50_s", "slack_p10_s")}
            path = metrics.write(args.metrics_out, extra={"phase_breakdown": bd, "slo": slo})
            say(f"metrics -> {path}")
    served = {r.rid: rt.replica_of(r.rid) for r in trace} if routed else {}
    if not same_on_every_rank(group, (results, served)):
        raise SystemExit("the ranks emitted different tokens")
    if group is not None:
        say(f"ranks: all {group.world} emitted the same tokens")
    if args.verify:
        sess = eng.session(tp, dp)
        oks = {}
        for r in trace:  # in a fleet each replica checks the requests it served
            if r.rid in results and (fleet is None or served[r.rid] == fleet.replica):
                solo, _ = sess.generate(r.prompt.reshape(1, -1), max_new=r.max_new)
                oks[r.rid] = results[r.rid] == solo[0]
        if fleet is not None:
            every = every_rank(group, oks)
            oks = {rid: all(o[rid] for o in every if rid in o) for rid in results}
        mismatches = 0
        for r in trace:
            if r.rid not in results:
                continue
            ok = oks[r.rid]
            mismatches += 0 if ok else 1
            where = f" (replica {served[r.rid]})" if routed else ""
            say(f"verify req {r.rid}: "
                  f"{'byte-identical to solo generate()' if ok else 'MISMATCH'}{where}")
        if mismatches:
            raise SystemExit(f"{mismatches} request(s) diverged from solo generate()")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target-arch", default="qwen2.5-14b")
    ap.add_argument("--draft-arch", default="qwen2.5-14b")
    ap.add_argument("--mode", choices=["parallel", "serial"], default="parallel")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--w", type=int, default=4)
    ap.add_argument("--d", "--depth", dest="d", type=int, default=0,
                    help="0 = profile-derived (under torchrun spell it --depth: its own "
                         "options make --d ambiguous)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-target", type=int, default=6,
                    help="devices per replica for the target (with too few devices every "
                         "replica shares one)")
    ap.add_argument("--n-draft", type=int, default=2, help="devices per replica for the draft")
    ap.add_argument("--replicas", type=int, default=1,
                    help="continuous: engine replicas behind one global queue (least-loaded "
                         "routing, per-replica and fleet telemetry)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a Poisson trace through the continuous-batching runtime")
    ap.add_argument("--async-rounds", action="store_true",
                    help="draft round N+1's tree on the draft's CUDA stream while round N "
                         "verifies on the target's (parallel mode only; outputs stay "
                         "byte-identical to lockstep)")
    ap.add_argument("--slots", type=int, default=2, help="continuous: engine batch slots")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="continuous: Poisson arrival rate (req/s)")
    ap.add_argument("--queue-cap", type=int, default=64,
                    help="continuous: admission-control queue cap")
    ap.add_argument("--adaptive-depth", action="store_true",
                    help="continuous: per-slot adaptive draft depth (outputs stay "
                         "byte-identical)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="continuous: per-request finish deadline, seconds after arrival "
                         "(0 = best-effort); EDF queueing and SLO reporting")
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    help="continuous: skip the byte-identical check against solo generate()")
    ap.add_argument("--trace-out", default=None,
                    help="continuous: write phase spans here (.json = Chrome/Perfetto "
                         "traceEvents, .jsonl = span per line)")
    ap.add_argument("--metrics-out", default=None,
                    help="continuous: write the metrics snapshot + phase breakdown here")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    group = split = fleet = None
    replicas = args.replicas if args.continuous else 1
    world = int(os.environ.get("WORLD_SIZE", "1")) if "RANK" in os.environ else 1
    if world > 1:
        g = args.n_target + args.n_draft
        if replicas > 1 and world == replicas * g:
            from repro_torch.parallel.split import init_fleet

            fleet = init_fleet(args.n_target, args.n_draft, replicas, args.device)
            split, group = fleet.split, fleet.exchange
        elif replicas == 1 and world == g:
            from repro_torch.parallel.split import init_split

            split = init_split(args.n_target, args.n_draft, args.device)
            group = split.world
        elif replicas == 1 and world < g:
            from repro_torch.parallel import init_tp

            group = init_tp(args.device)
        else:
            raise SystemExit(
                f"{world} ranks with --replicas {replicas}: the layouts that run are one split "
                f"({g} ranks: --n-target + --n-draft), one tensor-parallel group (fewer "
                f"ranks), or R splits (--continuous --replicas R on R x {g} ranks)")
    try:
        say = print if group is None or group.rank == 0 else _quiet
        eng, tp, dp, cfgT = build_engine(
            args.target_arch, args.draft_arch, mode=args.mode, bs=args.bs, w=args.w,
            d=args.d or 2, max_new=args.max_new, n_target=args.n_target, n_draft=args.n_draft,
            replicas=replicas, device=args.device, async_rounds=args.async_rounds,
            group=None if split is not None else group, split=split, fleet=fleet)
        engines = eng
        eng = eng[0 if fleet is None else fleet.replica] if isinstance(eng, list) else eng
        if fleet is not None:
            say(f"fleet: {fleet.replicas} replicas on disjoint rank groups, target / draft ranks "
                + ", ".join(f"{list(t)} / {list(d)}" for t, d in fleet.pairs)
                + f" ({split.world.backend}); one exchange on the host (gloo) per fleet round")
        elif split is not None:
            say(f"split: target on ranks {list(split.target_ranks)}, draft on ranks "
                f"{list(split.draft_ranks)} ({group.backend}); the plan and the verdict cross "
                "between them each round")
        elif group is not None:
            say(f"tensor parallel: {group.world} ranks ({group.backend}), target heads / KV heads "
                f"per rank {eng.target.run_cfg.n_heads}/{eng.target.run_cfg.n_kv_heads} on rank 0")
        if args.d == 0:
            if fleet is None or fleet.replica == 0:  # a fleet profiles replica 0's split
                say(profile_depth(eng, tp, dp, args.prompt_len))
            if fleet is not None or (group is not None and split is None):
                # rank 0's depth: the ranks' timings differ (a fleet's mirrors read it from eng)
                d = group.broadcast(torch.tensor([eng.cfg.d], device=group.device))
                eng.cfg = dataclasses.replace(eng.cfg, d=int(d[0]))
            for e in set(engines) if isinstance(engines, list) and fleet is None else ():
                e.cfg = eng.cfg
        if args.continuous:
            run_continuous(args, engines, tp, dp, cfgT, group, fleet)
            return

        total_toks, total_s = 0, 0.0
        sess = eng.session(tp, dp)
        prompts = make_request_stream(cfgT.vocab_size, args.prompt_len, 1, args.requests)
        for i, prompt in enumerate(prompts):
            t0 = monotonic()
            out, stats = sess.generate(prompt)
            dt = monotonic() - t0
            if not same_on_every_rank(group, out):
                raise SystemExit(f"req {i}: the ranks emitted different tokens")
            total_toks += len(out[0])
            total_s += dt
            say(f"req {i}: {len(out[0])} tokens in {dt:.2f}s "
                f"({len(out[0])/dt:.1f} tok/s), compression {stats.compression_ratio:.2f}"
                + ("" if group is None else f", the same on all {group.world} ranks"))
        say(f"aggregate: {total_toks/total_s:.1f} tokens/s ({args.mode} mode)")

    finally:
        if world > 1:  # every torchrun path leaves its process group
            from repro_torch.parallel import shutdown_tp

            shutdown_tp()

if __name__ == "__main__":
    main()
