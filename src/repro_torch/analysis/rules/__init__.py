"""Rule modules; importing this package populates the registry.

RETRACE is not ported: the port compiles and captures nothing (no
``torch.compile``, no CUDA graph), so it has no retrace hazard to find; a
capture-hazard rule belongs with the change that brings CUDA graphs."""

from repro_torch.analysis.rules import axis, clock, hotsync, kernelabi  # noqa: F401
