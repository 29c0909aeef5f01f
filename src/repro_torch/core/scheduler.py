"""Profiling-driven resource allocation (``repro.core.scheduler``, paper
§3.1 / §5.5).

Before serving, SwiftSpec profiles (1) the draft/target device split x and
(2) the number of tree expansions d per round, so drafting and verification
finish nearly simultaneously:

  profile_times(...)    — time one draft expansion / one target verify
  choose_depth(...)     — d in {r, r+1}, r = floor(t_target / t_draft), pick
                          the higher measured decoding speed (paper §5.5)
  sweep_allocation(...) — try each (x target, k-x draft) device split and
                          keep the fastest decoding speed (paper Fig. 9)

On the card a timed callable must wait for its own device work before it
returns (``torch.cuda.synchronize``), or the clock reads only the enqueue:
``profile_times`` takes a ``device`` and does that wait itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.obs.clock import monotonic


@dataclasses.dataclass
class ProfileResult:
    t_draft_s: float
    t_target_s: float

    @property
    def ratio(self) -> float:
        return self.t_target_s / max(self.t_draft_s, 1e-9)


def _synced(fn: Callable[[], None], device) -> Callable[[], None]:
    """``fn`` followed by a wait for ``device`` when it is a CUDA device."""
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        return fn

    def run():
        fn()
        torch.cuda.synchronize(dev)

    return run


def _time_fn(fn: Callable[[], None], iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    t0 = monotonic()
    for _ in range(iters):
        fn()
    return (monotonic() - t0) / iters


def profile_times(draft_step: Callable[[], None], target_step: Callable[[], None],
                  iters: int = 5, device=None) -> ProfileResult:
    """Time one draft tree expansion and one target verification round;
    on a CUDA ``device`` each call is followed by a wait for the card."""
    return ProfileResult(
        t_draft_s=_time_fn(_synced(draft_step, device), iters),
        t_target_s=_time_fn(_synced(target_step, device), iters),
    )


def candidate_depths(prof: ProfileResult) -> tuple[int, int]:
    """The paper's d in {r, r+1}, r = floor(t_target / t_draft), r >= 1."""
    r = max(1, int(prof.ratio))
    return r, r + 1


def choose_depth(run_at_depth: Callable[[int], float], prof: ProfileResult) -> int:
    """Run the engine at both candidate depths; keep the faster (tokens/s)."""
    cands = candidate_depths(prof)
    speeds = {d: run_at_depth(d) for d in cands}
    return max(speeds, key=speeds.get)


@dataclasses.dataclass
class AllocationResult:
    n_target: int
    n_draft: int
    tokens_per_s: float


def sweep_allocation(n_devices: int, run_split: Callable[[int, int], float],
                     target_sizes: Sequence[int] | None = None) -> AllocationResult:
    """Paper Fig. 9: sweep x target devices against (k - x) draft devices.

    Only even target degrees are considered (paper §5.5: even degrees align
    with head counts and need less padding).  ``run_split(nt, nd)`` returns
    the measured decoding speed of that allocation."""
    if target_sizes is None:
        target_sizes = [x for x in range(2, n_devices) if x % 2 == 0] or [max(1, n_devices - 1)]
    best = None
    for nt in target_sizes:
        nd = n_devices - nt
        if nd < 1:
            continue
        tps = run_split(nt, nd)
        if best is None or tps > best.tokens_per_s:
            best = AllocationResult(nt, nd, tps)
    if best is None:  # the reference's assert, kept under ``python -O``
        raise AssertionError("no feasible allocation")
    return best
