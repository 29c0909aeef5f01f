#!/usr/bin/env python3
"""Tensor-parallel training with one card per rank, over NCCL.

  python3 tools/train_nccl.py        # needs 4 NVIDIA GPUs of one host

``chip_smoke.py``'s phase (t2) trains on ranks that share one card through
gloo.  This script runs ``launch.train.train`` (``workers.mesh_train``) on
a world of four ranks carved by ``mesh_model`` 2 (2 data x 2 model), one
card each over NCCL, on llama3-1b at full width cut to ``chip_smoke``'s
TP_TRAIN depth (f32, a global batch of 4 x 256, TRAIN_NCCL_STEPS steps on
the dataset's batches at ``chip_smoke.TRAIN_LR``), then the same job over
gloo with all four ranks on the first card.  Each run's losses must be the
single-process run's on the same global batches (made first, on the first
card) within ``chip_smoke.TRAIN_LOSS_RTOL``.  It prints every card's name
and power limit and each rank's median step time and peak memory.  Then it
runs the train CLI under torchrun on the four cards (``--mesh-model 2``,
the smoke config, NCCL), which must exit 0, and again after its newest
checkpoint is taken away: the resumed run must write that checkpoint again
bit for bit.  Exit 0 when every check passed.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]

TRAIN_NCCL_STEPS = 4
BATCH = 4  # global rows: 2 a data rank


def train_cli(ckpt: str) -> list:
    """The train CLI under torchrun on four ranks, one card each, with
    ``--mesh-model 2``; raises SystemExit unless it exits 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.train", "--arch", "llama3-1b", "--mesh-model", "2",
           "--steps", "6", "--batch", "4", "--seq", "32", "--ckpt-every", "2", "--log-every",
           "1", "--ckpt", ckpt]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=HERE, env=env)
    lines = res.stdout.splitlines()
    print(f"train CLI --mesh-model 2 on 4 cards (nccl): exit {res.returncode}", flush=True)
    for ln in lines:
        print(f"  {ln}", flush=True)
    if res.returncode:
        print(res.stderr[-3000:], file=sys.stderr)
        raise SystemExit("train_nccl: the train CLI failed")
    return lines


def leaves(path: str) -> list:
    import numpy as np

    n = len([f for f in os.listdir(path) if f.startswith("leaf_")])
    return [np.load(os.path.join(path, f"leaf_{i}.npy")) for i in range(n)]


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("train_nccl: needs 4 CUDA devices", file=sys.stderr)
        return 1
    import numpy as np

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build_all
    from repro_torch.launch.train import train
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.spawn import run_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = f"[{'; '.join(smi[:4])}]"
    print(f"cards: {smi}", flush=True)
    print(f"kernels built in {build_all():.1f} s", flush=True)
    name, depth, _ = chip_smoke.TP_TRAIN
    cfg = dataclasses.replace(get_config(name), n_layers=depth)
    kw = dict(steps=TRAIN_NCCL_STEPS, batch=BATCH, seq=chip_smoke.TRAIN_S,
              lr=chip_smoke.TRAIN_LR, warmup_steps=chip_smoke.TRAIN_WARMUP)
    t0 = monotonic()
    one = train(cfg, device="cuda:0", log=lambda *_: None, **kw)
    want, ref_ms = one["losses"], float(np.median(one["step_s"][1:])) * 1e3
    del one  # the card's memory goes to the ranks (all four share the first card over gloo)
    torch.cuda.empty_cache()
    print(f"(t2n) {name}/{depth} f32, batch {BATCH} x {chip_smoke.TRAIN_S}, {TRAIN_NCCL_STEPS} "
          f"steps: one process on cuda:0 {want} in {monotonic() - t0:.1f} s, step "
          f"{ref_ms:.2f} ms (median of steps 2-{TRAIN_NCCL_STEPS}, host clock) on {smi[0]}",
          flush=True)
    for backend in ("nccl", "gloo"):
        label = f"(t2n) {name}/{depth} world 4, mesh_model 2, {backend}"
        job = {"cfg": cfg, "kw": kw, "mesh_model": 2, "ckpt": None}
        t0 = monotonic()
        ranks = run_ranks("repro_torch.parallel.workers:mesh_train", 4, (job,),
                          workdir=os.path.join(HERE, "build", "train_nccl", backend),
                          device=[f"cuda:{i if backend == 'nccl' else 0}" for i in range(4)],
                          backend=backend, timeout_s=600, threads=2)
        for r in ranks:
            if not np.allclose(r["losses"], want, rtol=chip_smoke.TRAIN_LOSS_RTOL, atol=0.0):
                raise SystemExit(f"{label} rank {r['rank']}: losses {r['losses']} against one "
                                 f"process's {want}")
            print(f"{label} rank {r['rank']}: step "
                  f"{float(np.median(r['step_s'][1:])) * 1e3:.2f} ms (median of steps "
                  f"2-{TRAIN_NCCL_STEPS}, host clock), peak {r['peak_bytes'] / 2**30:.2f} GiB, "
                  f"fused_swiglu {r['launches']['fused_swiglu']} launches, losses within "
                  f"{chip_smoke.TRAIN_LOSS_RTOL} of one process's", flush=True)
        print(f"{label}: {monotonic() - t0:.1f} s with the ranks' start, "
              + ("one card a rank" if backend == "nccl" else "all four ranks on the first card")
              + f" on {card}", flush=True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        ckpt = os.path.join(d, "ckpt")
        train_cli(ckpt)
        kept = {}
        for r in (0, 1):
            step5 = os.path.join(ckpt, f"model{r}", "step_000000000005")
            kept[r] = leaves(step5)
            shutil.rmtree(step5)
        lines = train_cli(ckpt)
        if "resumed from step 4" not in lines:
            raise SystemExit("train_nccl: the train CLI did not resume from step 4")
        for r in (0, 1):
            again = leaves(os.path.join(ckpt, f"model{r}", "step_000000000005"))
            if len(again) != len(kept[r]) or not all(
                    np.array_equal(a, b) for a, b in zip(again, kept[r])):
                raise SystemExit(f"train_nccl: model rank {r}'s resumed state differs")
    print("train CLI: resumed from step 4 and wrote step 5 again bit for bit on both model "
          f"ranks on {card}", flush=True)
    print("train_nccl: every check passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
