"""The sanctioned monotonic clock — every raw wall-clock read of the port
lives here (a copy of ``repro.obs.clock``).

The static-analysis CLOCK rule (docs/static-analysis.md) bans ``time.time``
/ ``time.perf_counter`` / friends everywhere else in ``src/``, this package
included, so every stopwatch in the port (generate() wall time, the profile
pass, kernel build time) reads ``monotonic()``.  Device time on the GPU is
read with CUDA events, which the rule does not concern.
"""

from __future__ import annotations

import time


def monotonic() -> float:
    """Monotonic fractional seconds; the process-wide stopwatch timebase."""
    # the single sanctioned raw read the CLOCK rule allows
    return time.perf_counter()  # repro: disable=CLOCK — this IS the abstraction

