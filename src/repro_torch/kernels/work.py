"""The work of one call of each kernel wrapper: the operations it does and
the bytes it must move (each input read once, each output written once),
as functions of its arguments' shapes and dtypes.

One count serves every reader: ``chip_smoke.py``'s bound column, the cost
counter of the dry run (``launch/cost.py``, which counts a wrapper at the
call by these formulas and never through the ops inside it, so that its
plain version, its meta branch and its CUDA kernel count alike) and later
the benchmark.  The card's rates are the H100 SXM data sheet's.

Where the work depends on the data (the keys a tree mask attends, the
moves a plan makes active) a formula counts from the shapes alone what
the kernel may touch — every key below the bound, every entry of the plan
— unless it is given ``data=True``, which reads the data (a host sync:
only for a measurement, never on a path).

``counted(name, formula)`` marks a function as one unit of the count:
while no counter is set (``set_counter``) it only calls the function.
"""

from __future__ import annotations

import functools
import math

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_OPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}  # f32 CUDA cores / bf16 dense
HBM_BYTES = 80e9  # H100 SXM device memory


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the HBM rate vs
    operations over the peak rate of the inputs' type."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[str(dtype)] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _es(t) -> int:
    return t.element_size()


# -----------------------------------------------------------------------------
# the kernels: (operations, bytes) of one call, the wrapper's own arguments
# -----------------------------------------------------------------------------


def tree_attention(q, k, v, mask, *, kv_bound=None, data: bool = False) -> tuple[int, int]:
    """q [B, n, Hq, hd] against k/v [B, S, Hkv, hd] under mask [B, n, S]:
    4·hd·Hq operations per attended (query, key) pair; q read and the
    output written, the mask read, each needed K/V row read once.  From
    the shapes every key below the bound is needed and attended."""
    B, n, hq, hd = q.shape
    S, hkv = k.shape[1], k.shape[2]
    kv_end = S if kv_bound is None else max(0, min(int(kv_bound), S))
    if data:
        kv_rows, pairs = int(mask.any(1).sum()), int(mask.sum())
    else:
        kv_rows, pairs = B * kv_end, B * n * kv_end
    nbytes = 2 * q.numel() * _es(q) + mask.numel() + 2 * kv_rows * hkv * hd * _es(k)
    return 4 * hd * hq * pairs, nbytes


def decode_attention(q, k, v, length) -> tuple[int, int]:
    """q [B, Hq, hd] against the first L rows of k/v [B, S, Hkv, hd]: L the
    host-int length, or S for per-row lengths read on the card."""
    B, hq, hd = q.shape
    S, hkv = k.shape[1], k.shape[2]
    L = S if not isinstance(length, int) else max(0, min(length, S))
    return 4 * B * hq * hd * L, 2 * q.numel() * _es(q) + 2 * B * L * hkv * hd * _es(k)


def fused_swiglu(x, wg, wu) -> tuple[int, int]:
    """silu(x@wg) * (x@wu), x [M, K], wg/wu [K, N]: two products."""
    M, K = x.shape
    N = wg.shape[1]
    return 4 * M * K * N, (M * K + 2 * K * N + M * N) * _es(x)


def swiglu_backward(x, wg, wu) -> tuple[int, int]:
    """The backward of ``fused_swiglu`` (``ops.swiglu_backward``): the two
    products recomputed, then dx, dwg and dwu; x, wg, wu and the output
    gradient read, dx, dwg and dwu written."""
    M, K = x.shape
    N = wg.shape[1]
    return 12 * M * K * N, (2 * M * K + 4 * K * N + M * N) * _es(x)


def _leaf_row_bytes(x) -> int:
    return math.prod(x.shape[3:]) * x.element_size()


def kv_active(src, dst, mask, S):
    """(batch rows, sources, destinations) of the active moves, int64."""
    import torch

    act = mask & (src >= 0) & (src < S) & (dst >= 0) & (dst < S)
    b = torch.arange(src.shape[0], device=src.device)[:, None].expand_as(src)
    return b[act], src[act].long(), dst[act].long()


def kv_move_leaves(leaves, src, dst, mask, *, donate: bool = False,
                   data: bool = False) -> tuple[int, int]:
    """Row moves over every leaf [U, B, S, ...]: in place the active source
    rows read and the destination rows written; copying through every row
    of the fresh output written, and the rows it needs read — the unmoved
    rows and the sources.  From the shapes every entry of the plan is an
    active move of its own row (in place), and every row is read (copying
    through)."""
    leaves = list(leaves)
    B, S = leaves[0].shape[1:3]
    if data:
        b, s, d = kv_active(src, dst, mask, S)
        if donate:
            rows = 2 * len(s)
        else:
            rows = B * S + sum(len((set(range(S)) - set(d[b == r].tolist())) |
                                   set(s[b == r].tolist())) for r in range(B))
    else:
        rows = 2 * B * src.shape[-1] if donate else 2 * B * S
    return 0, sum(rows * x.shape[0] * _leaf_row_bytes(x) for x in leaves)


def slot_write_rows(cache_leaves, donor_leaves, slot) -> tuple[int, int]:
    """One batch row of every leaf written; the donor's row read (install)."""
    slab = sum(x.shape[0] * math.prod(x.shape[2:]) * x.element_size() for x in cache_leaves)
    return 0, (slab if donor_leaves is None else 2 * slab)


def int4_matmul(x, qweight, scales, zeros, *, group_size: int = 128) -> tuple[int, int]:
    """x [T, K] @ ((q - z)·s): the packed weight, its f32 scales and zeros
    and x read, the output written."""
    T, K = x.shape
    N = qweight.shape[1]
    nbytes = qweight.numel() + 4 * (scales.numel() + zeros.numel()) + (T * K + T * N) * _es(x)
    return 2 * T * K * N, nbytes


def full_attention(q, k, v, *, d_qk: int | None = None) -> tuple[int, int]:
    """Causal attention over a whole sequence (``attention_full``'s and
    ``mla_full``'s core, computed in query chunks): q [B, Sq, Hq, d_qk]
    against k [B, Skv, ., d_qk] and v [B, Skv, H, d_v], every score
    computed (the chunks skip none); q, k and v read and the output
    [B, Sq, Hq, d_v] written."""
    B, Sq, hq = q.shape[:3]
    Skv, d_v = v.shape[1], v.shape[-1]
    d_qk = q.shape[-1] if d_qk is None else d_qk
    es = _es(q)
    nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * hq * d_v) * es
    return 2 * B * Sq * Skv * hq * (d_qk + d_v), nbytes


def full_attention_backward(q, k, v, *, d_qk: int | None = None,
                            recompute: bool = False) -> tuple[int, int]:
    """Its backward: the gradients of the probabilities, the scores, q, k
    and v (twice the forward's products), plus the forward again where a
    query chunk is recomputed; q, k, v and the output gradient read, their
    gradients written."""
    flops, nbytes = full_attention(q, k, v, d_qk=d_qk)
    return (3 if recompute else 2) * flops, 2 * nbytes


# -----------------------------------------------------------------------------
# the counter's hook
# -----------------------------------------------------------------------------

_COUNTER = None  # the active cost counter (launch.cost.CostCounter) or None


def set_counter(counter) -> None:
    """Make ``counter`` (None: no counter) the one every ``counted`` call
    reports to."""
    global _COUNTER
    _COUNTER = counter


def counted(name: str, formula, backward=None):
    """Mark a function as one unit of work: with a counter set, a call is
    counted once by ``formula(*args, **kwargs)`` -> (operations, bytes),
    its backward by ``backward`` (same arguments), and no op inside it is
    counted.  Without a counter the function is called as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def unit(*args, **kwargs):
            if _COUNTER is None:
                return fn(*args, **kwargs)
            return _COUNTER.unit(name, fn, formula, backward, args, kwargs)
        return unit
    return wrap
