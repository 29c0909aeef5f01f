"""Deterministic serving prompts and Poisson arrival traces
(``repro.data.pipeline``, numpy only)."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def _draw_prompt_len(rng, prompt_len) -> int:
    """int -> fixed; (lo, hi) -> uniform over 4-token buckets in [lo, hi]."""
    if isinstance(prompt_len, int):
        return prompt_len
    lo, hi = prompt_len
    buckets = list(range(lo, hi + 1, 4)) or [lo]
    return int(buckets[rng.integers(0, len(buckets))])


def make_request_stream(vocab_size: int, prompt_len, batch: int, n_requests: int,
                        seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic serving prompts [batch, P] int32 — the same stream as
    the reference's for the same arguments.

    ``prompt_len``: an int for fixed-shape prompts, or a (lo, hi) tuple for
    variable lengths drawn per request."""
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        P = _draw_prompt_len(rng, prompt_len)
        yield rng.integers(0, vocab_size, size=(batch, P), dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One entry of a serving arrival trace."""

    rid: int
    arrival_s: float
    prompt: np.ndarray  # i32[P]
    max_new: int = 32


def make_request_trace(vocab_size: int, n_requests: int, *, rate_rps: float = 2.0,
                       prompt_len=(8, 24), max_new: int = 32,
                       seed: int = 0) -> list[TraceRequest]:
    """Seeded Poisson arrival trace with variable prompt lengths — the same
    trace as the reference's for the same arguments.

    Inter-arrival gaps are exponential with mean ``1 / rate_rps``; prompt
    lengths are drawn per request (see ``_draw_prompt_len``)."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    t = 0.0
    trace = []
    for i in range(n_requests):
        if i > 0:
            t += float(rng.exponential(1.0 / rate_rps))
        P = _draw_prompt_len(rng, prompt_len)
        prompt = rng.integers(0, vocab_size, size=(P,), dtype=np.int32)
        trace.append(TraceRequest(rid=i, arrival_s=t, prompt=prompt, max_new=max_new))
    return trace
