"""Roofline terms of a dry-run cell (``repro.launch.hlo_stats``'s
counterpart), from a ``launch.cost.Cost``:

  compute term    = operations / peak rate of the compute dtype
  memory term     = bytes read and written / HBM rate
  collective term = per mesh axis, collective bytes / that axis's link rate

The hardware is NVIDIA's H100 SXM data sheet, not a measurement: 989e12
bf16 dense operations per second (67e12 in f32 on the CUDA cores),
3.35e12 B/s of HBM, 80 GB of it, NVLink 4 at 450e9 B/s each way between
the ranks of a "model" axis of at most 8 (one NVLink domain), and
InfiniBand NDR at 50e9 B/s per GPU for a larger "model" axis and for the
"data" and "pod" axes.  The count is of the dtype the step really uses,
so no correction is applied (the reference halves its CPU-compiled f32
bytes).
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.work import HBM_BYTES, HBM_BYTES_PER_S, PEAK_OPS

NVLINK_BYTES_PER_S = 450e9  # NVLink 4, each way
NVLINK_DOMAIN = 8  # GPUs of one NVLink domain (an HGX H100 board)
IB_BYTES_PER_S = 50e9  # InfiniBand NDR 400 Gb/s, per GPU


def link_bytes_per_s(axis: str, ranks: int) -> float:
    """The link rate of a collective along ``axis`` over ``ranks`` ranks."""
    if axis == "model" and ranks <= NVLINK_DOMAIN:
        return NVLINK_BYTES_PER_S
    return IB_BYTES_PER_S


@dataclasses.dataclass
class Roofline:
    flops: float  # per-rank operations
    hbm_bytes: float  # per-rank bytes read and written
    collective_bytes: float  # per-rank collective operand bytes
    t_compute_s: float
    t_memory_s: float
    t_collective_s: float
    bottleneck: str
    model_flops: float  # 6·N·D (train) or 2·N_active·D (serve), per rank
    useful_fraction: float  # model_flops / flops
    roofline_fraction: float  # ideal model-flops time / dominant term

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(cost, model_flops_per_chip: float, dtype: str = "torch.bfloat16") -> Roofline:
    """The three terms of ``cost`` (a ``launch.cost.Cost``) on one H100."""
    peak = PEAK_OPS[dtype]
    flops, nbytes = float(cost.total_flops), float(cost.total_bytes)
    t_c = flops / peak
    t_m = nbytes / HBM_BYTES_PER_S
    t_x = sum(a["bytes"] / link_bytes_per_s(axis, a["ranks"])
              for axis, a in cost.collective_axes.items())
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    dominant = max(terms.values())
    return Roofline(
        flops=flops, hbm_bytes=nbytes, collective_bytes=float(cost.collective_bytes),
        t_compute_s=t_c, t_memory_s=t_m, t_collective_s=t_x, bottleneck=bottleneck,
        model_flops=model_flops_per_chip,
        useful_fraction=(model_flops_per_chip / flops) if flops else 0.0,
        roofline_fraction=(model_flops_per_chip / peak / dominant) if dominant > 0 else 0.0,
    )


def fits(peak_bytes: float) -> bool:
    """Whether a rank's peak fits one H100's memory."""
    return peak_bytes <= HBM_BYTES


def model_flops_per_chip(cfg, shape, n_chips: int) -> float:
    """MODEL_FLOPS for the cell, divided over chips.

    Parameter part: 6·N·D (train fwd+bwd) / 2·N_active·D (serve forward), D =
    tokens processed.  Attention part (dominant at long context): per layer
    4·T_q·S_kv·Hq·hd forward (qk + pv), ×3 with backward; causal prefill/train
    halves S_kv on average.  MoE uses active params (routed top-k + shared)."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    d_attn = cfg.n_heads * cfg.head_dim
    n_attn_layers = sum(1 for k in cfg.layer_kinds if k in ("dense", "moe", "cross"))
    if cfg.shared_attn_every:
        n_attn_layers += (cfg.n_layers - cfg.first_k_dense) // cfg.shared_attn_every
    if shape.kind == "train":
        total = 6.0 * n_active * (B * S)
        total += 3 * 4.0 * B * (S * S / 2) * d_attn * n_attn_layers
    elif shape.kind == "prefill":
        total = 2.0 * n_active * (B * S)
        total += 4.0 * B * (S * S / 2) * d_attn * n_attn_layers
    else:  # decode: one token per sequence against an S-row cache
        total = 2.0 * n_active * B
        total += 4.0 * B * S * d_attn * n_attn_layers
    return total / n_chips
