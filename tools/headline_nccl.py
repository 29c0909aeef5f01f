#!/usr/bin/env python3
"""The paper's headline deployment: llama3-70b + llama3-1b in bf16 on four cards over NCCL.

  python3 tools/headline_nccl.py                       # needs 4 NVIDIA GPUs of one host
  python3 tools/headline_nccl.py --backend gloo --layers 4   # all ranks on the first card

Two layouts of the tree engine, each a spawn of four ranks, one card per
rank, the weights drawn from seeds on each rank's card (target seed 0,
draft seed 1, lm_head x4: ``build_engine``'s draws, in bf16), each rank
drawing its own shard tensor by tensor:

  (x1) llama3-70b (80 layers) on ranks 0-2 + llama3-1b (16 layers) on
       rank 3: the disaggregated engine (``workers.split_engine``), target
       and draft on disjoint rank groups, the plan and the verdict
       broadcast over the world;
  (x2) both models over ranks 0-3 on a shared tensor-parallel group
       (``workers.spec_engine``), the draft on a process group of its own.

Each runs lockstep and async tree rounds (bs 8, w 4, c 2, d 2, S_max 512,
max_new 32) on 2 prompts of 16 tokens (``make_request_stream``, seed 11,
the first being ``chip_smoke.split_job``'s), its groups ``serving`` ones
(a bf16 all-reduce is an all-gather and a float32 sum in rank order).
(x1) is checked by ``chip_smoke.report_split``, (x2) by
``chip_smoke.report_shared``: every rank's tokens equal the target's
greedy decode over the same ranks and rank 0's, the same stats on every
rank, one host sync of the port per round, ``chip_smoke.MAIN_KERNELS``
launched by every rank in every run, and each rank's parameter bytes its
shard's.  A diverging output names the first position that differs and
the greedy decode's top-2 logit gap there.  Between them (x1r) runs (x1)'s
greedy decode and lockstep rounds with the backend's ring all-reduce: a
measurement of what the order costs and whether the ring keeps the
contract, printed and not checked.  Then ``chip_smoke.phase_shapes``
holds every kernel shape an (x1) or (x2) rank launched against its plain
version, on that rank's card.

It prints every card's name and power limit, the kernels' build time, and
for each layout the ranks' build time, parameter bytes and peak memory,
and for each run the mean round (host clock over the whole run, no warm
run: the greedy decode before it warms the target) and tokens/s.  A
collective that waits past ``parallel.group.COLLECTIVE_TIMEOUT_S`` (300 s,
``init_process_group``'s timeout) ends its rank, and a spawn whose ranks
run past ``SPAWN_S`` is killed, so a hang fails the run.  Exit 0 when
every check passed.

``--backend gloo`` runs the four ranks on the first card (every exchange
staged through the host: a rehearsal, no speed figure), ``--layers N``
cuts the 70B to its first N layers (the 80 layers fit no single card) and
``--layouts x1r,x1`` runs only those layouts, in that order.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]

WORLD = 4
N_TARGET = 3  # (x1): the 70B's ranks; the 1B on the last
MAX_NEW = 32
PROMPTS = 2
SPAWN_S = 600  # a spawn's limit: build, greedy decode and both runs of every rank


def jobs(layers: int | None) -> dict:
    """name -> (rank program, job) of (x1), (x1r) and (x2)."""
    import chip_smoke
    from repro_torch.data import make_request_stream

    tcfg, dcfg = chip_smoke.bf16_config("llama3-70b"), chip_smoke.bf16_config("llama3-1b")
    if layers:
        tcfg = dataclasses.replace(tcfg, n_layers=layers)
    tree = dict(bs=8, w=4, c=2, d=2, max_new=MAX_NEW)
    kw = {"lockstep": tree, "async": dict(tree, async_rounds=True)}
    common = {"tcfg": tcfg, "dcfg": dcfg, "weights": ("seed", 0, 1, 4.0),
              "prompts": list(make_request_stream(tcfg.vocab_size, 16, 1, PROMPTS, seed=11)),
              "S_max": 512, "greedy_n": MAX_NEW, "sync_rounds": 2, "record_shapes": True}
    x1 = dict(common, n_target=N_TARGET, runs=[(run, "tree", k) for run, k in kw.items()])
    return {"x1": ("split_engine", x1),
            "x1r": ("split_engine", dict(x1, sum="ring", runs=x1["runs"][:1],
                                         record_shapes=False)),
            "x2": ("spec_engine", dict(common, runs=list(kw.items())))}


def report_shared(job, ranks, card, log, backend) -> None:
    """(x2): each rank's layout, parameter bytes (its shards'), memory and
    build, then ``chip_smoke.report_shared``'s checks of every run."""
    import torch

    import chip_smoke
    from chip_smoke import fail
    from repro_torch.parallel.shard import Shard

    tcfg, dcfg = job["tcfg"], job["dcfg"]
    label = f"(x2) {tcfg.name}/{tcfg.n_layers} + {dcfg.name} over {len(ranks)} ranks, bf16"
    for r in ranks:
        for name, keys in r["shapes"].items():
            log.seen[name] |= keys
        want = {role: Shard(c, r["rank"], len(ranks)).local_cfg for role, c in
                (("target", tcfg), ("draft", dcfg))}
        want = {role: c.param_count() * getattr(torch, c.param_dtype).itemsize
                for role, c in want.items()}
        if r["param_bytes"] != want:
            fail(f"{label} rank {r['rank']}: parameter bytes {r['param_bytes']}, its shards take "
                 f"{want}")
        print(f"{label} rank {r['rank']}: heads / KV heads target {r['heads']['target']}, draft "
              f"{r['heads']['draft']}; parameters target {want['target'] / 2**30:.3f} GiB + draft "
              f"{want['draft'] / 2**30:.3f} GiB (its shards), allocated after the build "
              f"{r['allocated_after_build'] / 2**30:.3f} GiB (its peak "
              f"{r['build_peak'] / 2**30:.3f} GiB), peak after it "
              f"{r['peak_allocated'] / 2**30:.3f} GiB, build {r['build_s']:.1f} s, greedy decode "
              f"{r['greedy_s']:.1f} s on {card}", flush=True)
    chip_smoke.report_shared(label, job, ranks, card, backend, sync_runs=("lockstep", "async"))


def report_ring(job, ranks, card, backend) -> None:
    """(x1r): (x1)'s lockstep with the ring all-reduce, a measurement of
    what the ordered sum costs and of whether the ring keeps the contract:
    its figures, no check."""
    tcfg, dcfg = job["tcfg"], job["dcfg"]
    per = [r["runs"]["lockstep"] for r in ranks]
    rounds = per[0]["rounds"]
    toks = sum(len(t) for t in per[0]["tokens"])
    greedy = ranks[0]["greedy"]
    off = [next((k for k, (a, b) in enumerate(zip(t, want)) if a != b), None)
           for t, want in zip(per[0]["tokens"], greedy)]
    same = all(g["tokens"] == per[0]["tokens"] for g in per)
    print(f"(x1r) split {tcfg.name}/{tcfg.n_layers} on {N_TARGET} ranks + {dcfg.name} on "
          f"{WORLD - N_TARGET}, the ring all-reduce (a measurement, not the serving path): "
          f"lockstep {rounds} rounds, mean round {per[0]['wall_s'] / max(rounds, 1) * 1e3:.2f} "
          f"ms, {toks / per[0]['wall_s']:.2f} tok/s ({backend}), "
          f"{sum(per[0]['collectives'].values()) / max(rounds, 1):.2f} collectives per round on "
          f"rank 0; rank 0 leaves the ring's own greedy decode at position {off} (per prompt; "
          f"None: nowhere), every rank the same tokens: {same}; greedy decode "
          f"{ranks[0]['greedy_s']:.1f} s on {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--layers", type=int, default=None,
                    help="the 70B's first N layers (default: all 80)")
    ap.add_argument("--layouts", default="x1,x1r,x2",
                    help="the layouts to run, in this order (default: x1,x1r,x2)")
    args = ap.parse_args()
    import torch

    need = WORLD if args.backend == "nccl" else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        raise RuntimeError(f"headline_nccl: needs {need} CUDA device(s) with {args.backend}, "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    import chip_smoke
    from repro_torch.kernels.build import build_all
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.spawn import run_ranks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    cards = smi[:WORLD] if args.backend == "nccl" else smi[:1]
    card = f"[{'; '.join(cards)}]"
    print(f"cards: {smi}", flush=True)
    print(f"kernels built in {build_all():.1f} s", flush=True)
    devices = [f"cuda:{i if args.backend == 'nccl' else 0}" for i in range(WORLD)]
    every = jobs(args.layers)
    layouts = {name: every[name] for name in args.layouts.split(",")}
    out, failed = {}, []
    for name, (fn, job) in layouts.items():
        t0 = monotonic()
        out[name] = run_ranks(f"repro_torch.parallel.workers:{fn}", WORLD, (job,),
                              workdir=os.path.join(HERE, "build", "headline", args.backend, name),
                              device=devices, backend=args.backend, timeout_s=SPAWN_S, threads=2)
        print(f"({name}): {WORLD} ranks over {args.backend}, "
              + ("one card each" if args.backend == "nccl" else "all on the first card")
              + f", {job['tcfg'].name} at {job['tcfg'].n_layers} of 80 layers and "
              f"{job['dcfg'].name} in bf16, ran in {monotonic() - t0:.1f} s", flush=True)
    log = types.SimpleNamespace(seen=collections.defaultdict(set))
    for name, (_, job) in layouts.items():
        try:  # report every layout, then fail
            if name == "x1":
                chip_smoke.report_split(name, job, out[name], {}, card, log, backend=args.backend)
            elif name == "x1r":
                report_ring(job, out[name], card, args.backend)
            else:
                report_shared(job, out[name], card, log, args.backend)
        except SystemExit:
            failed.append(name)
    for name in [n for n in out if n in ("x1", "x2")]:
        for r, res in enumerate(out[name]):
            one = types.SimpleNamespace(seen=collections.defaultdict(set))
            for kname, keys in res["shapes"].items():
                one.seen[kname] |= keys
            dev = int(devices[r].split(":")[1])
            torch.cuda.set_device(dev)
            print(f"({name}) rank {r} on cuda:{dev}:", end=" ", flush=True)
            try:
                chip_smoke.phase_shapes(torch, one, f"[{smi[dev]}]")
            except SystemExit:
                failed.append(f"{name} shapes rank {r}")
    if failed:
        print(f"headline_nccl ({args.backend}): FAILED {failed}", flush=True)
        return 1
    print(f"headline_nccl ({args.backend}): every check passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
