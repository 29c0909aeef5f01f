"""Deterministic serving prompts (``repro.data.pipeline``, numpy only)."""

from __future__ import annotations

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
