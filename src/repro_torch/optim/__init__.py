"""Optimizer substrate (``repro.optim``): AdamW with f32 masters, the
warmup-cosine schedule and int8 gradient compression, with the int8 mean
over a process group (``pod_allreduce_compressed``)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import (
    compress_int8,
    decompress_int8,
    pod_allreduce_compressed,
)
from repro_torch.optim.schedules import warmup_cosine

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "compress_int8",
    "decompress_int8",
    "pod_allreduce_compressed",
    "warmup_cosine",
]
