"""Fault tolerance (``repro.runtime.fault``): step retry with backoff and
the straggler policy.

Transient device or runtime errors retry the step.  The reference may retry
because a JAX step is functional; the port's train step
(``launch/steps.make_train_step``) is functional too — it writes no
parameter or optimizer tensor, and returns new ones — so running it again
after a failure starts from the same state.  An error that persists (a
kernel that does not build or launch) is raised once the retries are spent.

Straggler mitigation for the serving engine is draft-bypass: if the draft
misses its deadline, verification proceeds on the root-only chain
(``SpecConfig.draft_bypass``) instead of stalling.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, TypeVar

T = TypeVar("T")
log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    max_retries: int = 3
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    # exceptions considered transient (retryable); CUDA and kernel errors
    # raise RuntimeError (torch.cuda.OutOfMemoryError is one)
    transient: tuple = (RuntimeError, OSError)


def retry_step(fn: Callable[[], T], cfg: FaultConfig = FaultConfig(),
               on_retry: Callable[[int, BaseException], None] | None = None) -> T:
    """Run ``fn`` with bounded retry + exponential backoff.  ``fn`` must be
    safe to run again after it raised (a functional step).  Non-transient
    exceptions propagate immediately; a transient one propagates once
    ``max_retries`` retries have failed."""
    delay = cfg.backoff_s
    for attempt in range(cfg.max_retries + 1):
        try:
            return fn()
        except cfg.transient as e:  # noqa: PERF203
            if attempt == cfg.max_retries:
                raise
            log.warning("transient failure (attempt %d/%d): %s", attempt + 1, cfg.max_retries, e)
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
            delay *= cfg.backoff_mult
    raise AssertionError("unreachable")


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based draft-bypass decision for the serving engine.

    ``deadline_ratio``: the draft must deliver within ratio x its profiled
    time; beyond that the engine verifies the best available subtree
    (the ``SpecConfig.draft_bypass`` path)."""

    t_draft_profiled_s: float
    deadline_ratio: float = 3.0
    window: int = 16  # sliding window of recent draft times

    def __post_init__(self):
        self._recent: list[float] = []

    def observe(self, t_draft_s: float) -> None:
        self._recent.append(t_draft_s)
        if len(self._recent) > self.window:
            self._recent.pop(0)

    @property
    def deadline_s(self) -> float:
        return self.t_draft_profiled_s * self.deadline_ratio

    def should_bypass(self) -> bool:
        """True when the most recent draft time blows the deadline."""
        if not self._recent:
            return False
        return self._recent[-1] > self.deadline_s
