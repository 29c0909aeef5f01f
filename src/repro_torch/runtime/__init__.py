"""Fault tolerance (``repro.runtime``): step retry, the straggler policy and
re-sharding onto a tensor-parallel group of another degree (``elastic``)."""

from repro_torch.runtime.elastic import reshard_params
from repro_torch.runtime.fault import FaultConfig, StragglerPolicy, retry_step

__all__ = ["FaultConfig", "StragglerPolicy", "reshard_params", "retry_step"]
