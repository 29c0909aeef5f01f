"""PyTorch + CUDA port of the SwiftSpec reproduction (``repro``), for one
NVIDIA H100.

The JAX package ``repro`` is the reference; this package re-implements its
speculative decoding on torch tensors — the tree engine (lockstep and async
rounds, continuous batching) and the chain engine — with hand-written
Hopper kernels (``repro_torch.kernels``) in place of the Pallas kernels on
those paths.  It imports neither jax nor anything of ``repro``.

Every entry point takes an explicit ``device``.  Left unset it means
``cuda``; without a CUDA device that raises rather than falling back to the
CPU.  The CPU runs only when the caller asks for it (the parity tests do),
and then every kernel wrapper takes its plain PyTorch version.  An explicit
``meta`` builds tensors with shapes and no storage (the dry run,
``launch/dryrun.py``): every kernel wrapper then returns its outputs'
shapes without arithmetic.  Nothing defaults to it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a CUDA device raises.
    ``meta`` only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda', 'cpu' or 'meta', not {dev}")
    return dev


def indexed_device(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current CUDA device,
    so that ``cuda`` and ``cuda:0`` compare equal where they are one card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
