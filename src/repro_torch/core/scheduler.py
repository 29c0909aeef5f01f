"""Profiling-driven draft depth (``repro.core.scheduler``, paper §5.5):
the profile pass times one draft expansion and one target verification,
and the round runs d in {r, r+1} expansions, r = floor(t_target / t_draft),
so drafting and verification finish nearly together."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ProfileResult:
    t_draft_s: float
    t_target_s: float

    @property
    def ratio(self) -> float:
        return self.t_target_s / max(self.t_draft_s, 1e-9)


def candidate_depths(prof: ProfileResult) -> tuple[int, int]:
    """The paper's d in {r, r+1}, r = floor(t_target / t_draft), r >= 1."""
    r = max(1, int(prof.ratio))
    return r, r + 1
