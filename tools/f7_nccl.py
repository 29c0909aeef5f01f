#!/usr/bin/env python3
"""F7's probe: does an f32 all-reduce over NCCL give a row other bits among rows?

  python3 tools/f7_nccl.py        # needs 2 NVIDIA GPUs of one host (4 for world 4)

A ring all-reduce's order of addition for an element depends on the chunk
it falls in, so on the message's size: a tensor-parallel verify of n rows
and a decode step of one row could then sum a row's parts in other orders,
and in float32 a last-bit difference can flip a greedy token.  This script
all-reduces, on ranks of one card each over NCCL, every row of a float32
[n, d] message alone and the message whole (``workers.all_reduce_rows``),
at n 8 and 16 and d 4096, 5120 and 8192 (the 8B's, zamba2's and the 70B's
widths), on 2 ranks and, where the host has 4 cards, on 4: with NCCL's own
all-reduce ("ring") and on a serving group (``TPGroup.serving``, which sums
every floating all-reduce in rank order, ``parallel.group._ordered_sum``),
bf16 on the serving group beside them; it prints per (world, n, d, sum)
how many rows differ from themselves alone and by how much.  Exit 0 when
it ran; what it found is printed, not judged.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]

ROWS = (8, 16)
WIDTHS = (4096, 5120, 8192)
WORLDS = (2, 4)
# (dtype, on a serving group): NCCL's own f32 sum, then the serving group's ordered sums
SUMS = (("float32", False), ("float32", True), ("bfloat16", True))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("f7_nccl: needs 2 CUDA devices", file=sys.stderr)
        return 1
    from repro_torch.parallel.spawn import run_ranks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"cards: {smi}", flush=True)
    rng = np.random.default_rng(0)
    for world in WORLDS:
        if torch.cuda.device_count() < world:
            print(f"world {world}: skipped, {torch.cuda.device_count()} cards", flush=True)
            continue
        shapes = [(n, d) for n in ROWS for d in WIDTHS]
        cases = [(s, dt, serving) for s in shapes
                 for dt, serving in SUMS]
        calls = [("all_reduce_rows", (rng.normal(size=(world, n, d)).astype(np.float32), dt,
                                      serving)) for (n, d), dt, serving in cases]
        out = run_ranks("repro_torch.parallel.workers:several", world, (calls,),
                        workdir=os.path.join(HERE, "build", "f7_nccl", str(world)),
                        device=[f"cuda:{i}" for i in range(world)], backend="nccl",
                        timeout_s=300)
        card = f"[{'; '.join(smi[:world])}]"
        for j, ((n, d), dt, serving) in enumerate(cases):
            res = [r[j] for r in out]
            differ = int((res[0]["whole"] != res[0]["rows"]).any(-1).sum())
            worst = float(np.abs(res[0]["whole"] - res[0]["rows"]).max())
            ranks_equal = all(np.array_equal(r["whole"], res[0]["whole"]) for r in res)
            how = "serving group" if serving else "ring"
            print(f"f7_nccl world {world} n {n} d {d} {dt} {how}: {differ} of {n} rows differ from "
                  f"themselves all-reduced alone (max |diff| {worst:.3g}); every rank's sum "
                  f"{'equal' if ranks_equal else 'NOT equal'} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
