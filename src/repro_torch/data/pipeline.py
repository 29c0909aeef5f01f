"""Deterministic synthetic data (``repro.data.pipeline``, numpy only).

Training: a seeded Markov-chain token stream packed into fixed-length
sequences — deterministic given (seed, step), so a restarted job resumes on
exactly the bytes it would have seen; the same numpy generator calls as the
reference, so the same tokens bit for bit.  The chain has low entropy
(peaked transitions).  ``sharded_batches`` gives each rank of a
data-parallel process group its rows of every batch.

Serving: deterministic prompts and Poisson arrival traces.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4  # Markov out-degree: lower = peakier = more predictable


class SyntheticLMDataset:
    """Seeded Markov LM stream; ``batch(step)`` is a pure function of step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, B = cfg.vocab_size, cfg.branch
        # per-state successor table + peaked probabilities
        self._succ = rng.integers(0, V, size=(V, B), dtype=np.int32)
        p = np.geomspace(1.0, 0.05, B)
        self._probs = p / p.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """-> {"tokens": [B, S+1] int32} (inputs = [:, :-1], labels = [:, 1:])."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        out = np.empty((B, S + 1), np.int32)
        cur = rng.integers(0, cfg.vocab_size, size=B, dtype=np.int32)
        out[:, 0] = cur
        choices = rng.choice(cfg.branch, size=(B, S), p=self._probs)
        for t in range(S):
            cur = self._succ[cur, choices[:, t]]
            out[:, t + 1] = cur
        return {"tokens": out}


def sharded_batches(ds: SyntheticLMDataset, group, start_step: int = 0) -> Iterator[dict]:
    """Rank ``group.rank``'s rows of ``ds.batch(step)`` for step =
    start_step, start_step + 1, ...: {"step", "tokens" [B/p, S+1] int32 on
    the group's device}, the rows [r·B/p, (r+1)·B/p) — the reference's batch
    split over ("pod", "data"), one process per data shard.  ``group`` is
    the data-parallel group (``parallel.group.make_train_groups``'s second):
    the model ranks of one data rank get the same rows."""
    p, r = group.world, group.rank
    B = ds.cfg.global_batch
    if B % p:
        raise ValueError(f"a global batch of {B} rows does not split over {p} ranks")
    n = B // p
    step = start_step
    while True:
        rows = ds.batch(step)["tokens"][r * n:(r + 1) * n]
        yield {"step": step, "tokens": torch.as_tensor(rows, device=group.device)}
        step += 1


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
