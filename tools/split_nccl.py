#!/usr/bin/env python3
"""The disaggregated engine with one card per rank, over NCCL.

  python3 tools/split_nccl.py [--backend gloo]   # needs 3 NVIDIA GPUs of one host

``chip_smoke.py``'s phase (s) runs the split's ranks on one card through
gloo, which stages every exchange through the host.  This script runs the
same two paths, built by ``chip_smoke.split_job``, with each rank on a card
of its own and the exchanges as NCCL broadcasts: (s1) llama3-8b on rank 0
and llama3-1b on rank 1 (lockstep, async and chain), then (s2) llama3-8b
over ranks 0-1 and llama3-1b on rank 2 (lockstep).  Each is checked by
``chip_smoke.report_split``: every rank's tokens equal the target's
single-process greedy decode and rank 0's, the same stats on every rank,
one host sync of the port per round (chain: +1 per request), each role's
kernels launched, and no rank holding the other role's weights.  It prints
the mean round of each run and every card's name and power limit.  Exit 0
when every check passed.  ``--backend gloo`` runs the ranks as phase (s)
does, all on the first card, so that one call compares the two layouts.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    backend = ap.parse_args().backend
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 3:
        print("split_nccl: needs 3 CUDA devices", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.build import build_all
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.spawn import run_ranks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = f"[{'; '.join(smi[:3])}]"
    print(f"cards: {smi}", flush=True)
    print(f"kernels built in {build_all():.1f} s", flush=True)
    log = types.SimpleNamespace(seen=collections.defaultdict(set))
    greedy = {}
    for name in ("s1", "s2"):
        _, (_, n_t), (_, n_d), _ = chip_smoke.SPLIT_PATHS[name]
        world = n_t + n_d
        job = chip_smoke.split_job(name)
        t0 = monotonic()
        out = run_ranks("repro_torch.parallel.workers:split_engine", world, (job,),
                        workdir=os.path.join(HERE, "build", "split_nccl", backend, name),
                        device=[f"cuda:{i if backend == 'nccl' else 0}" for i in range(world)],
                        backend=backend,
                        timeout_s=420, threads=2)
        print(f"({name}): {world} ranks over {backend}"
              + (", one card each" if backend == "nccl" else ", all on the first card")
              + f", ran in {monotonic() - t0:.1f} s", flush=True)
        chip_smoke.report_split(name, job, out, greedy, card, log, backend=backend)
    print(f"split_nccl ({backend}): every check passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
