"""Run a rank program on new processes, one per rank.

``run_ranks("module:function", world, args, ...)`` starts ``world``
processes of ``python -m repro_torch.parallel.spawn``; each joins a process
group through a ``FileStore`` in ``workdir`` (no TCP port, so concurrent
runs cannot clash), calls ``function(group, *args)`` and pickles what it
returns.  The parent waits for all of them within ``timeout_s``: on
overrun every child is killed and ``TimeoutError`` raised, so a deadlocked
collective fails one call instead of hanging its caller; a child that
fails raises ``RuntimeError`` with the end of its output.  A child imports
the port only (the module of the rank program and what the pickled
arguments need), with one intra-op thread.

  python -m repro_torch.parallel.spawn JOB RANK   # one rank of a job file
"""

from __future__ import annotations

import importlib
import os
import pathlib
import pickle
import subprocess
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.obs.clock import monotonic

_SRC = str(pathlib.Path(__file__).resolve().parents[2])  # the directory holding repro_torch


def run_ranks(fn: str, world: int, args=(), *, workdir, device=None, backend=None,
              timeout_s: float = 120.0, threads: int = 1) -> list:
    """``fn(group, *args)`` on ``world`` new processes; returns the list of
    their results in rank order.  ``device``: one device for every rank
    (ranks share it) or a list with one per rank; None means CUDA, as
    everywhere in the port (without a CUDA device that raises; the CPU is
    ``device="cpu"``).  ``backend``: None for ``init_tp``'s default (NCCL on
    CUDA, gloo on the CPU)."""
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    job = work / "job.pkl"
    store = work / "store"
    store.unlink(missing_ok=True)
    devices = list(device) if isinstance(device, (list, tuple)) else [device] * world
    devices = [str(resolve_device(d)) for d in devices]
    with open(job, "wb") as f:
        pickle.dump({"fn": fn, "world": world, "args": tuple(args), "devices": devices,
                     "backend": backend, "store": str(store), "threads": threads}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS=str(threads))
    procs, logs = [], []
    for rank in range(world):
        (work / f"out{rank}.pkl").unlink(missing_ok=True)
        log = open(work / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-m", "repro_torch.parallel.spawn",
                                       str(job), str(rank)], env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if monotonic() > deadline:
                raise TimeoutError(f"{fn} on {world} ranks ran past {timeout_s:.0f} s: "
                                   + _tails(work, world))
            if any(p.returncode not in (None, 0) for p in procs):
                break  # one rank failed: the others may wait for it forever
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        codes = [p.returncode for p in procs]
        raise RuntimeError(f"{fn} on {world} ranks exited {codes}: " + _tails(work, world))
    out = []
    for rank in range(world):
        with open(work / f"out{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _tails(work: pathlib.Path, world: int, n: int = 3000) -> str:
    parts = []
    for rank in range(world):
        path = work / f"rank{rank}.log"
        text = path.read_text(errors="replace") if path.exists() else ""
        parts.append(f"\n--- rank {rank} ---\n{text[-n:]}")
    return "".join(parts)


def _child(job_path: str, rank: int) -> None:
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job["threads"])
    from repro_torch.parallel.group import init_tp, shutdown_tp

    group = init_tp(job["devices"][rank], job["backend"], rank=rank, world_size=job["world"],
                    store_path=job["store"])
    mod, name = job["fn"].split(":")
    try:
        res = getattr(importlib.import_module(mod), name)(group, *job["args"])
    finally:
        shutdown_tp()
    with open(pathlib.Path(job_path).parent / f"out{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
