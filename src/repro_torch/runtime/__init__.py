"""Fault tolerance (``repro.runtime``): step retry and the straggler policy.
The reference's ``runtime/elastic.py`` (resharding onto another mesh) comes
with tensor parallelism (ROADMAP item 13b)."""

from repro_torch.runtime.fault import FaultConfig, StragglerPolicy, retry_step

__all__ = ["FaultConfig", "StragglerPolicy", "retry_step"]
