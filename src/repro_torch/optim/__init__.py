"""Optimizer substrate (``repro.optim``): AdamW with f32 masters, the
warmup-cosine schedule and int8 gradient compression.  The reference's
``pod_allreduce_compressed`` is a collective over the "pod" mesh axis and
comes with tensor parallelism (ROADMAP item 13b)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.schedules import warmup_cosine

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "compress_int8",
    "decompress_int8",
    "warmup_cosine",
]
