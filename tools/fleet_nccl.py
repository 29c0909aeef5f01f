#!/usr/bin/env python3
"""Router replicas on disjoint rank groups with one card per rank, over NCCL.

  python3 tools/fleet_nccl.py        # needs 4 NVIDIA GPUs of one host

``chip_smoke.py``'s phase (r) runs two replicas of a split (llama3-8b/8 on
one rank + llama3-1b/4 on one rank) on four ranks that share one card
through gloo.  This script runs the same job (``chip_smoke.fleet_job``)
three times, each checked by ``chip_smoke.report_fleet`` against the
target's single-process greedy decode: at (r)'s depth over NCCL with each
rank on a card of its own, then over gloo with all four ranks on the first
card (as phase (r) runs it), then at full depth (32 + 16 layers) over
NCCL.  Then it runs the serve CLI under torchrun on the four cards:
``--continuous --replicas 2 --n-target 1 --n-draft 1 --depth 1``, lockstep
and with ``--async-rounds``, each of which must exit 0 with every request
byte-identical to its replica's solo ``generate()``.  It prints every
card's name and power limit and each run's mean fleet and replica rounds.
Exit 0 when every check passed.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]


def serve_cli(extra: list) -> None:
    """The serve CLI under torchrun on four ranks, one card each; raises
    SystemExit unless it exits 0 with every request verified."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.serve", "--continuous", "--replicas", "2",
           "--n-target", "1", "--n-draft", "1", "--depth", "1"] + extra
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=HERE, env=env)
    lines = res.stdout.splitlines()
    verify = [ln for ln in lines if ln.startswith("verify req")]
    print(f"serve CLI {' '.join(extra) or '(lockstep)'}: exit {res.returncode}", flush=True)
    for ln in lines:
        if ln.startswith(("fleet", "replica", "ranks:", "verify", "wall", "continuous")):
            print(f"  {ln}", flush=True)
    if res.returncode or not verify or any("byte-identical" not in ln for ln in verify):
        print(res.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"fleet_nccl: the serve CLI {extra} failed")


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("fleet_nccl: needs 4 CUDA devices", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.build import build_all
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.spawn import run_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = f"[{'; '.join(smi[:4])}]"
    print(f"cards: {smi}", flush=True)
    print(f"kernels built in {build_all():.1f} s", flush=True)
    log = types.SimpleNamespace(seen=collections.defaultdict(set))
    (tname, t_depth), (dname, d_depth), replicas = chip_smoke.FLEET
    for backend, full in (("nccl", False), ("gloo", False), ("nccl", True)):
        job = chip_smoke.fleet_job(full_depth=full)
        label = (f"(r) fleet of {replicas} x ({tname}/{job['tcfg'].n_layers} + "
                 f"{dname}/{job['dcfg'].n_layers})")
        t0 = monotonic()
        greedy = chip_smoke.fleet_greedy(torch, job)
        t1 = monotonic()
        ranks = run_ranks("repro_torch.parallel.workers:fleet", 2 * replicas, (job,),
                          workdir=os.path.join(HERE, "build", "fleet_nccl", backend,
                                               "full" if full else "cut"),
                          device=[f"cuda:{i if backend == 'nccl' else 0}"
                                  for i in range(2 * replicas)],
                          backend=backend, timeout_s=600, threads=2)
        print(f"{label}: {2 * replicas} ranks over {backend}"
              + (", one card each" if backend == "nccl" else ", all on the first card")
              + f"; greedy reference {t1 - t0:.1f} s, ranks {monotonic() - t1:.1f} s", flush=True)
        chip_smoke.report_fleet(label, job, ranks, greedy, card, log, backend=backend)
    serve_cli([])
    serve_cli(["--async-rounds"])
    print("fleet_nccl: every check passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
