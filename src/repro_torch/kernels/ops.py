"""Public kernel wrappers, dispatched by device (``repro.kernels.ops``).

A CPU tensor goes to the plain PyTorch version in ``kernels/ref.py``; a CUDA
tensor goes to the hand-written kernel in ``csrc/`` or the wrapper raises.
Nothing — no flag, no environment variable, no ``try`` — sends a CUDA tensor
to a plain version.  A meta tensor (the dry run, asked for by name) goes to
the wrapper's meta branch, which returns outputs of the kernel's shapes and
dtype with no arithmetic and no library call, and allocates the scratch
the kernel's launch allocates, so that a memory count sees it; each
wrapper is one unit of ``kernels.work``'s count.  Each wrapper adds one to
``LAUNCHES[name]`` where it launches its kernel and nowhere else, so a run
can show which kernels its path went through.  Kernels launch on PyTorch's current stream and do not
synchronise; the wrappers allocate every output and scratch buffer.
Every kernel with a split combine in device memory (tree_attention,
decode_attention, fused_swiglu, int4_matmul) takes atomic tickets from one
zeroed buffer kept per (device, stream), which each launch leaves zero:
launches on one stream run in order, and launches on two streams never share
a ticket.  stream_matmul combines its splits inside a thread-block cluster
and allocates nothing but its output.
"""

from __future__ import annotations

import array
import contextlib
import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref, work

LAUNCHES = {"tree_attention": 0, "decode_attention": 0, "fused_swiglu": 0, "kv_move_rows": 0,
            "slot_write_rows": 0, "int4_matmul": 0, "stream_matmul": 0, "stream_bmm": 0,
            "rms_norm": 0, "latent_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_tickets_by_stream: dict = {}  # (device, stream) -> zeroed int32 tickets (kernels leave them zero)


def attn_split_keys(S: int) -> int:
    """Keys per S split of the attention kernels: 64, or a larger multiple
    of 64 for a cache longer than 32 splits of 64 (the kernel combines at
    most 32).  A function of S alone, so a query row sums in the same order
    whatever n is, and decode_attention in the same order as tree_attention."""
    return 64 * max(1, -(-S // (64 * 32)))


def attn_plan(S: int, kv_end: int | None = None) -> tuple[int, int]:
    """(keys per split, splits launched) of one attention launch: the splits
    of ``attn_split_keys(S)`` keys that hold a key below the host-int bound
    ``kv_end`` (every split when None), at least one.  A split past the bound
    would add exactly nothing to the combine, so leaving it out changes no
    bit of a row.  The plan depends on S and the bound, never on n."""
    split = attn_split_keys(S)
    live = S if kv_end is None else max(0, min(int(kv_end), S))
    return split, max(1, -(-live // split))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _route(name: str, *tensors) -> str:
    """"cuda", "cpu" or "meta": the one device of the inputs; raises on a
    mix or any other device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _stream(dev) -> int:
    """The raw handle of PyTorch's current stream on ``dev`` (a CUDA device
    with its index), without building a ``torch.cuda.Stream`` object: a
    serving round makes hundreds of launches, each paid on the host."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


_SAME_DEVICE = contextlib.nullcontext()


def _on(dev):
    """The context in which a launch on ``dev`` runs: ``dev`` made the
    current device, or nothing to do when it already is (one card a
    process, the common case)."""
    return _SAME_DEVICE if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)


# -----------------------------------------------------------------------------
# tree attention
# -----------------------------------------------------------------------------


def _check_attention(name, q, k, v, B):
    """The kernels' contract on q [B, n, Hq, hd] (or [B, Hq, hd]) and k/v
    [B, S, Hkv, hd]; returns the contiguous tensors."""
    hq, hd = q.shape[-2:]
    S, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share f32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, S, hkv, hd) or v.shape != k.shape or hq % hkv or hd > 256 or hd % 4:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    return q, k, v


def _attention_scratch(lib, q, B, n, hq, hkv, hd, S, kv_end):
    """The launch plan, the partial buffers (None for one split; the caller
    holds them until the launch is enqueued) and the zeroed tickets of one
    launch."""
    dev = q.device
    rows = lib.attention_rows_per_block(_DTYPE_CODE[q.dtype])
    # a block holds heads of one query: n row tiles of min(rows, G) partial rows
    n_rowtiles = n * -(-(hq // hkv) // rows)
    tile_rows = min(rows, hq // hkv)
    split_keys, n_launch = attn_plan(S, kv_end)
    part_acc = part_ml = None
    if n_launch > 1:
        part_acc = torch.empty(B * hkv * n_rowtiles * tile_rows * n_launch * hd,
                               dtype=torch.float32, device=dev)
        part_ml = torch.empty(B * hkv * n_rowtiles * tile_rows * n_launch * 2,
                              dtype=torch.float32, device=dev)
    stream = _stream(dev)
    ctr = _tickets(dev, stream, B * hkv * n_rowtiles)
    return split_keys, n_launch, part_acc, part_ml, ctr, stream


_ATTENTION_ROWS = {torch.float32: 8, torch.bfloat16: 16}  # attention.cuh's Tile<T>::kRows


def _attention_scratch_meta(q, B, n, hq, hkv, hd, S, kv_end):
    """The partial buffers ``_attention_scratch`` allocates for one launch,
    on meta (the tickets are the stream's, allocated once)."""
    rows = _ATTENTION_ROWS[q.dtype]
    n_rowtiles = n * -(-(hq // hkv) // rows)
    tile_rows = min(rows, hq // hkv)
    _, n_launch = attn_plan(S, kv_end)
    if n_launch == 1:
        return ()
    return (torch.empty(B * hkv * n_rowtiles * tile_rows * n_launch * hd, dtype=torch.float32,
                        device=q.device),
            torch.empty(B * hkv * n_rowtiles * tile_rows * n_launch * 2, dtype=torch.float32,
                        device=q.device))


def _tickets(dev, stream: int, need: int):
    """The zeroed int32 ticket buffer of (device, stream), at least ``need``
    long: a split kernel takes one ticket per split and the last block to
    arrive sets the counter back to zero."""
    ctr = _tickets_by_stream.get((dev, stream))
    if ctr is None or ctr.numel() < need:
        with torch.cuda.device(dev):  # zeroed on the stream that will use it
            ctr = torch.zeros(max(need, 1024), dtype=torch.int32, device=dev)
        _tickets_by_stream[(dev, stream)] = ctr
    return ctr


def _ptr(t):
    return None if t is None else t.data_ptr()


@work.counted("tree_attention", work.tree_attention)
def tree_attention(q, k, v, mask, *, kv_bound: int | None = None):
    """q: [B, n, Hq, hd]; k, v: [B, S, Hkv, hd]; mask: bool [B, n, S].

    The paper's non-square tree-masked attention; returns [B, n, Hq, hd]
    in q's dtype, zeros for a fully masked query row.  The kernel takes
    float32 or bfloat16 with hd a multiple of 4, at most 256.  It sums each
    query's attended keys in the order of their rank among them, as the
    plain version does: a row's bits do not depend on the rows its keys
    lie at, nor on the other queries of the call.

    ``kv_bound``, a host int, promises that no query attends a key at or
    past it (the mask is False there): the kernel then neither loads those
    keys nor launches their splits, and the result is the same bit for bit
    as without it.  The CPU path checks the promise."""
    route = _route("tree_attention", q, k, v, mask)
    if route == "meta":
        S = k.shape[1]
        kv_end = S if kv_bound is None else max(0, min(int(kv_bound), S))
        scratch = _attention_scratch_meta(q, *q.shape[:3], k.shape[2], q.shape[3], S, kv_end)
        out = torch.empty_like(q)
        del scratch
        return out
    if route == "cpu":
        if kv_bound is not None and bool(mask[..., max(0, int(kv_bound)):].any()):
            raise ValueError(f"tree_attention: the mask attends a key at or past "
                             f"kv_bound={kv_bound}")
        return ref.tree_attention_ref(q, k, v, mask)
    B, n, hq, hd = q.shape
    S, hkv = k.shape[1], k.shape[2]
    if mask.shape != (B, n, S) or mask.dtype != torch.bool:
        raise ValueError(f"tree_attention: bad mask {tuple(mask.shape)} {mask.dtype} for "
                         f"q{tuple(q.shape)} k{tuple(k.shape)}")
    q, k, v = _check_attention("tree_attention", q, k, v, B)
    mask = mask.contiguous()
    lib = build.lib("tree_attention")
    kv_end = S if kv_bound is None else max(0, min(int(kv_bound), S))
    split_keys, n_launch, part_acc, part_ml, ctr, stream = _attention_scratch(
        lib, q, B, n, hq, hkv, hd, S, kv_end)
    out = torch.empty_like(q)
    with _on(q.device):
        LAUNCHES["tree_attention"] += 1
        rc = lib.tree_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            _ptr(part_acc), _ptr(part_ml), ctr.data_ptr(), B, n, hq, hkv, hd, S, split_keys,
            n_launch,
            kv_end, 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype], stream)
    build.check("tree_attention", rc)
    return out


# -----------------------------------------------------------------------------
# decode attention
# -----------------------------------------------------------------------------


@work.counted("decode_attention", work.decode_attention)
def decode_attention(q, k, v, length):
    """q: [B, Hq, hd]; k, v: [B, S, Hkv, hd]; length: int [B] tensor, or a
    host int for every batch row.

    One query position per batch row against the cache rows < length
    (decode_step); returns [B, Hq, hd] in q's dtype, zeros where the length
    is 0.  On the card a row equals tree_attention's at n = 1 under the
    mask cols < length, bit for bit.  Same dtypes and head sizes as
    tree_attention."""
    B, hq, hd = q.shape
    per_row = isinstance(length, torch.Tensor)
    if per_row and tuple(length.shape) != (B,):
        raise ValueError(f"decode_attention: length must be [B={B}], got {tuple(length.shape)}")
    route = _route("decode_attention", q, k, v, *((length,) if per_row else ()))
    if route == "meta":
        S = k.shape[1]
        kv_end = S if per_row else max(0, min(int(length), S))
        scratch = _attention_scratch_meta(q, B, 1, hq, k.shape[2], hd, S, kv_end)
        out = torch.empty_like(q)
        del scratch
        return out
    if route == "cpu":
        lt = length if per_row else torch.full((B,), int(length), dtype=torch.int32)
        return ref.decode_attention_ref(q, k, v, lt)
    q, k, v = _check_attention("decode_attention", q, k, v, B)
    S, hkv = k.shape[1], k.shape[2]
    lt = length.to(torch.int32).contiguous() if per_row else None
    kv_end = S if per_row else max(0, min(int(length), S))
    lib = build.lib("decode_attention")
    split_keys, n_launch, part_acc, part_ml, ctr, stream = _attention_scratch(
        lib, q, B, 1, hq, hkv, hd, S, kv_end)
    out = torch.empty_like(q)
    with _on(q.device):
        LAUNCHES["decode_attention"] += 1
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if lt is None else lt.data_ptr(),
            out.data_ptr(), _ptr(part_acc), _ptr(part_ml), ctr.data_ptr(), B, hq, hkv, hd, S,
            split_keys,
            n_launch, kv_end, 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype], stream)
    build.check("decode_attention", rc)
    return out


# -----------------------------------------------------------------------------
# weight streams: fused_swiglu and int4_matmul (csrc/weight_stream.cuh)
# -----------------------------------------------------------------------------

_STREAM_TILE_N = 256  # output columns per block of both kernels
_STREAM_BLOCKS = 2 * 132  # blocks a plan aims at: two resident on each SM of an H100
_STREAM_MAX_K = 1024  # K per split at most, so that x fits in shared memory
_STREAM_ROWS_PER_PASS = 64  # rows of x per launch through the split partials
_SWIGLU_K_QUANTUM = 32  # fused_swiglu's K per split is a multiple of this


def stream_plan(K: int, N: int, tile_n: int, k_quantum: int) -> tuple[int, int]:
    """(K per split, splits) of a weight-stream kernel: whole quanta of K
    (the group size for int4_matmul, ``_SWIGLU_K_QUANTUM`` for
    fused_swiglu), as many splits as let the column tiles times the splits
    stay within ``_STREAM_BLOCKS`` (all resident at once), and no more than
    ``_STREAM_MAX_K`` values of K per split (whole quanta permitting).  A
    function of K, N and the quantum alone, never of the rows of x, so a row
    sums over K in the same order whatever the batch."""
    quanta = -(-K // k_quantum)
    tiles = -(-N // tile_n)
    want = max(1, min(quanta, _STREAM_BLOCKS // tiles))
    per = min(-(-quanta // want), max(1, _STREAM_MAX_K // k_quantum))
    return per * k_quantum, -(-quanta // per)


def _stream_partials(dev, splits: int, parts: int, M: int, N: int):
    """The f32 partials [splits, parts, rows of a pass, N rounded up to 4]
    that a weight-stream launch of M rows splits K into (None for one
    split); on meta the allocation that a memory count sees."""
    if splits == 1:
        return None
    rows = min(M, _STREAM_ROWS_PER_PASS)
    return torch.empty(splits * parts * rows * (-(-N // 4) * 4), dtype=torch.float32, device=dev)


def _stream_scratch(dev, splits: int, parts: int, M: int, N: int):
    """The partials of one launch of a weight-stream kernel and its zeroed
    tickets (None and None for one split; the caller holds them until the
    launch is enqueued), and the stream."""
    stream = _stream(dev)
    part = _stream_partials(dev, splits, parts, M, N)
    if part is None:
        return None, None, stream
    # a ticket per (row tile, column tile) of a pass: at most one row tile per row
    return part, _tickets(dev, stream, min(M, _STREAM_ROWS_PER_PASS) * -(-N // _STREAM_TILE_N)), \
        stream


# -----------------------------------------------------------------------------
# fused SwiGLU
# -----------------------------------------------------------------------------


@work.counted("fused_swiglu", work.fused_swiglu, work.swiglu_backward)
def fused_swiglu(x, wg, wu):
    """x: [M, K]; wg, wu: [K, N] -> silu(x@wg) * (x@wu), [M, N] in x's dtype.
    The kernel takes float32 or bfloat16, any N (a tensor-parallel rank's
    share of a padded d_ff may be odd) and weights 16-byte aligned; K is
    split by ``stream_plan``.

    Differentiable: on the CPU the plain version has its own autograd; on
    CUDA, when an input requires a gradient (a training forward), the
    kernel runs inside ``_FusedSwiGLU``, whose backward is
    ``swiglu_backward``.  Without one (every serving path) the kernel is
    called directly and no graph is built.  On meta the same, with the
    meta branch in place of the kernel."""
    route = _route("fused_swiglu", x, wg, wu)
    if route == "meta":
        if torch.is_grad_enabled() and (x.requires_grad or wg.requires_grad or wu.requires_grad):
            return _FusedSwiGLU.apply(x, wg, wu)
        return _fused_swiglu_meta(x, wg, wu)
    if route == "cpu":
        return ref.fused_swiglu_ref(x, wg, wu)
    if torch.is_grad_enabled() and (x.requires_grad or wg.requires_grad or wu.requires_grad):
        return _FusedSwiGLU.apply(x, wg, wu)
    return _fused_swiglu_kernel(x, wg, wu)


def swiglu_backward(x, wg, wu, dh):
    """Gradients (dx, dwg, dwu) of ``silu(x@wg) * (x@wu)`` for the output
    gradient ``dh`` [M, N], in f32 and returned in the inputs' dtypes.
    g = x@wg and u = x@wu are recomputed, not stored by the forward; the
    products are PyTorch's (cuBLAS on the card) and the rest elementwise
    ops: the TPU kernel has no backward kernel, so none is written here.
    silu'(g) = s * (1 + g * (1 - s)), s = sigmoid(g), as torch's own."""
    xf, wgf, wuf, dhf = x.float(), wg.float(), wu.float(), dh.float()
    g = xf @ wgf
    u = xf @ wuf
    s = torch.sigmoid(g)
    du = dhf * (g * s)
    dg = dhf * u * (s * (1 + g * (1 - s)))
    dx = dg @ wgf.T + du @ wuf.T
    return dx.to(x.dtype), (xf.T @ dg).to(wg.dtype), (xf.T @ du).to(wu.dtype)


class _FusedSwiGLU(torch.autograd.Function):
    """The fused_swiglu kernel as an autograd op on CUDA (or meta)
    tensors: the forward is the kernel (its meta branch), the backward
    ``swiglu_backward``."""

    @staticmethod
    def forward(ctx, x, wg, wu):
        ctx.save_for_backward(x, wg, wu)
        if x.device.type == "meta":
            return _fused_swiglu_meta(x, wg, wu)
        return _fused_swiglu_kernel(x, wg, wu)

    @staticmethod
    def backward(ctx, dh):
        dx, dwg, dwu = swiglu_backward(*ctx.saved_tensors, dh)
        return tuple(g if need else None for g, need in zip((dx, dwg, dwu),
                                                             ctx.needs_input_grad))


def _fused_swiglu_meta(x, wg, wu):
    """The kernel's output on meta, with the split partials it allocates."""
    M, K = x.shape
    N = wg.shape[1]
    _, splits = stream_plan(K, N, _STREAM_TILE_N, _SWIGLU_K_QUANTUM)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _stream_partials(x.device, splits, 2, M, N)  # allocated and freed, as by a launch
    return out


def _fused_swiglu_kernel(x, wg, wu):
    """One launch of the fused_swiglu kernel on CUDA tensors."""
    M, K = x.shape
    N = wg.shape[1]
    if x.dtype not in _DTYPE_CODE or wg.dtype != x.dtype or wu.dtype != x.dtype:
        raise TypeError(f"fused_swiglu: x/wg/wu must share f32 or bf16, got "
                        f"{x.dtype}/{wg.dtype}/{wu.dtype}")
    if wg.shape != (K, N) or wu.shape != (K, N) or M == 0 or K == 0 or N == 0:
        raise ValueError(f"fused_swiglu: bad shapes x{tuple(x.shape)} wg{tuple(wg.shape)} "
                         f"wu{tuple(wu.shape)}")
    x, wg, wu = (t.contiguous() for t in (x, wg, wu))
    if wg.data_ptr() % 16 or wu.data_ptr() % 16:
        raise ValueError("fused_swiglu: weights must be 16-byte aligned")
    k_split, splits = stream_plan(K, N, _STREAM_TILE_N, _SWIGLU_K_QUANTUM)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part, ctr, stream = _stream_scratch(x.device, splits, 2, M, N)
    lib = build.lib("fused_swiglu")
    with _on(x.device):
        LAUNCHES["fused_swiglu"] += 1
        rc = lib.fused_swiglu_launch(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr(),
                                     _ptr(part), _ptr(ctr), M, K, N, k_split, splits,
                                     _STREAM_ROWS_PER_PASS, _DTYPE_CODE[x.dtype], stream)
    build.check("fused_swiglu", rc)
    return out


# -----------------------------------------------------------------------------
# the serving product
# -----------------------------------------------------------------------------

_MATMUL_CLUSTER = 8  # splits at most: the CTAs of one portable thread-block cluster
_MATMUL_QUANTUM = {torch.bfloat16: 64, torch.float32: 16}  # K a ring stage (csrc kBK, kKT)
_MATMUL_SMS = 132  # a plan aims at one wave of CTAs on an H100's SMs (see matmul_plan)


@functools.lru_cache(maxsize=None)
def matmul_plan(K: int, N: int, dtype) -> tuple[int, int, int]:
    """(column tile, K per split, splits) of a ``stream_matmul`` launch, a
    function of K, N and the dtype alone, never of the rows: every output
    sums K split by split in this order whatever M is (csrc/stream_matmul.cu).

    The tile is the wgmma's N in bf16 (128 from N 2048 up, else 64) and the
    threads of a CTA in f32 (64 to N 4096, 128 to 16384, else 256), so a
    narrow N gets its CTAs from columns; the splits are the most of 1, 2, 4
    and 8 (one portable cluster) that cut K into equal whole quanta (64
    values of K in bf16, 16 in f32) and, in bf16, keep the column tiles
    times the splits within one wave of one CTA an SM (its ring holds the
    bytes in flight; twice the CTAs, each with half the K, were slower at
    the wide products).  In f32 the splits follow K alone: an output's
    order of summation then depends on K only, so a tensor-parallel rank's
    share of a product's columns (zamba2's ``w_in``, the heads of ``wq``)
    carries the single process's bits, column for column."""
    q = _MATMUL_QUANTUM[dtype]
    if dtype == torch.bfloat16:
        tile = 128 if N >= 2048 else 64
    else:
        tile = 64 if N <= 4096 else 128 if N <= 16384 else 256
    tiles, quanta = -(-N // tile), -(-K // q)
    splits = 1
    while (splits * 2 <= _MATMUL_CLUSTER and splits * 2 <= quanta
           and (dtype != torch.bfloat16 or tiles * splits * 2 <= _MATMUL_SMS)):
        splits *= 2
    while splits > 1 and -(-quanta // -(-quanta // splits)) != splits:
        splits //= 2  # whole quanta a split and no empty split
    return tile, -(-quanta // splits) * q, splits


def matmul_refusal(K: int, N: int, dtype) -> str | None:
    """Why the kernel does not take a [K, N] product of this dtype, or None.
    bf16 loads x and w through TMA tensor maps, whose row strides are
    multiples of 16 bytes: K and N multiples of 8.  f32 takes every shape."""
    if dtype == torch.bfloat16 and (K % 8 or N % 8):
        return (f"bf16 takes K and N that are multiples of 8 (TMA's 16-byte row strides), "
                f"got K={K} N={N}")
    return None


@work.counted("stream_matmul", work.stream_matmul)
def stream_matmul(x, w):
    """x: [..., K]; w: [K, N] -> x @ w, [..., N] in x's dtype (f32
    accumulation).  The serving forward's dense products
    (``models.common.project``): the kernel sums every output element over
    K in an order set by K, N and the dtype alone (``matmul_plan``), so a
    row computed alone equals the same row among any number of rows, bit
    for bit, in f32 and bf16 (the tree engine's verify against its greedy
    decode).  The kernel takes float32 of any shape and bfloat16 with K and
    N multiples of 8 (``matmul_refusal``), and a 16-byte aligned weight; it
    writes nothing but the output.  No backward: a product under a gradient
    is ``x @ w`` (``project``), and one here raises."""
    if w.ndim != 2 or x.ndim < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"stream_matmul: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("stream_matmul: no backward; a product under a gradient is x @ w "
                           "(models.common.project)")
    route = _route("stream_matmul", x, w)
    if route == "cpu":
        return ref.stream_matmul_ref(x, w)
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"stream_matmul: x/w must share f32 or bf16, got {x.dtype}/{w.dtype}")
    K, N = w.shape
    lead = tuple(x.shape[:-1])
    M = math.prod(lead)
    if M == 0 or K == 0 or N == 0:  # nothing to launch
        return x.new_zeros(lead + (N,))
    if route == "meta":  # the kernel allocates nothing but its output
        return torch.empty(lead + (N,), dtype=x.dtype, device=x.device)
    why = matmul_refusal(K, N, x.dtype)
    if why is not None:
        raise ValueError(f"stream_matmul: {why}")
    x2, w = x.reshape(M, K).contiguous(), w.contiguous()
    if x2.data_ptr() % 16:  # a view at an odd offset: TMA reads x from a 16-byte base
        x2 = x2.clone()
    if w.data_ptr() % 16:
        raise ValueError("stream_matmul: the weight must be 16-byte aligned")
    tile, k_split, splits = matmul_plan(K, N, x.dtype)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = build.lib("stream_matmul")
    with _on(x.device):
        LAUNCHES["stream_matmul"] += 1
        rc = lib.stream_matmul_launch(x2.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, tile,
                                      k_split, splits, _DTYPE_CODE[x.dtype], _stream(x.device))
    build.check("stream_matmul", rc)
    return out.reshape(lead + (N,))


@work.counted("stream_bmm", work.stream_bmm)
def stream_bmm(x, w):
    """x: [G, M, K]; w: [G, K, N] -> x @ w, [G, M, N] in x's dtype (f32
    accumulation): the batched form of ``stream_matmul`` in one launch, a
    grid axis over the G groups (the MoE's experts, rwkv6's four
    token-shift projections, MLA's per-head products).  Each group sums
    over K in the order of ``matmul_plan(K, N, dtype)``, never of M or G:
    a row of a group computed alone equals the same row among any number
    of rows, bit for bit (an expert's M is the capacity, which moves with
    the forward's rows).  The same dtypes and shapes as ``stream_matmul``
    per group; no backward (a product under a gradient is ``torch.bmm``,
    ``models.common.project_batched``), and one here raises."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"stream_bmm: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("stream_bmm: no backward; a product under a gradient is torch.bmm "
                           "(models.common.project_batched)")
    route = _route("stream_bmm", x, w)
    if route == "cpu":
        return ref.stream_bmm_ref(x, w)
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"stream_bmm: x/w must share f32 or bf16, got {x.dtype}/{w.dtype}")
    G, M, K = x.shape
    N = w.shape[2]
    if G == 0 or M == 0 or K == 0 or N == 0:  # nothing to launch
        return x.new_zeros((G, M, N))
    if route == "meta":  # the kernel allocates nothing but its output
        return torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    why = matmul_refusal(K, N, x.dtype)
    if why is not None:
        raise ValueError(f"stream_bmm: {why}")
    if G > 65535:
        raise ValueError(f"stream_bmm: G={G} groups exceed the grid's 65535")
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: TMA reads x from a 16-byte base
        x = x.clone()
    if w.data_ptr() % 16:
        raise ValueError("stream_bmm: the weight must be 16-byte aligned")
    tile, k_split, splits = matmul_plan(K, N, x.dtype)
    out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    lib = build.lib("stream_matmul")
    with _on(x.device):
        LAUNCHES["stream_bmm"] += 1
        rc = lib.stream_bmm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), G, M, K, N, tile,
                                   k_split, splits, _DTYPE_CODE[x.dtype], _stream(x.device))
    build.check("stream_matmul", rc)
    return out


# -----------------------------------------------------------------------------
# MLA's latent attention
# -----------------------------------------------------------------------------


@work.counted("latent_attention", work.latent_attention)
def latent_attention(q_lat, q_rope, ckv, krope, mask, scale: float):
    """q_lat: [B, n, H, KL] (the absorbed queries, q_nope·W_ukᵀ); q_rope:
    [B, n, H, RD]; ckv: [B, S, KL] and krope: [B, S, RD], the latent cache
    (one row shared by every head); mask: bool [B, n, S].

    MLA's absorbed attention: each head's scores (q_lat·ckv + q_rope·krope)
    · scale over the rows its query attends, the softmax in f32, and the
    probability-weighted sum of the ckv rows; returns lat [B, n, H, KL] in
    q_lat's dtype, zeros for a query that sees no row.  The kernel sums
    each query's attended keys in the order of their rank among them, as
    tree_attention does: a row's bits depend neither on the other queries of
    the call nor on the rows its keys lie at.  It takes float32 or bfloat16,
    KL and RD multiples of 4, KL at most 256.  No backward."""
    route = _route("latent_attention", q_lat, q_rope, ckv, krope, mask)
    B, n, H, KL = q_lat.shape
    S, RD = krope.shape[1], krope.shape[2]
    if (q_rope.shape != (B, n, H, RD) or ckv.shape != (B, S, KL) or krope.shape != (B, S, RD)
            or mask.shape != (B, n, S)):
        raise ValueError(f"latent_attention: bad shapes q_lat{tuple(q_lat.shape)} q_rope"
                         f"{tuple(q_rope.shape)} ckv{tuple(ckv.shape)} krope"
                         f"{tuple(krope.shape)} mask{tuple(mask.shape)}")
    if route == "meta":
        return torch.empty_like(q_lat)
    if route == "cpu":
        return ref.latent_attention_ref(q_lat, q_rope, ckv, krope, mask, scale)
    dt = q_lat.dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt for t in (q_rope, ckv, krope)):
        raise TypeError(f"latent_attention: q/ckv/krope must share f32 or bf16, got "
                        f"{q_lat.dtype}/{q_rope.dtype}/{ckv.dtype}/{krope.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"latent_attention: the mask must be bool, got {mask.dtype}")
    if KL % 4 or RD % 4 or KL > 256 or B * n == 0 or H == 0 or S == 0:
        raise ValueError(f"latent_attention: KL={KL} and RD={RD} must be multiples of 4, KL at "
                         "most 256")
    ts = [t.contiguous() for t in (q_lat, q_rope, ckv, krope)]
    ts = [t.clone() if t.data_ptr() % 16 else t for t in ts]  # 16-byte bases
    mask = mask.contiguous()
    out = torch.empty((B, n, H, KL), dtype=dt, device=q_lat.device)
    lib = build.lib("latent_attention")
    with _on(q_lat.device):
        LAUNCHES["latent_attention"] += 1
        rc = lib.latent_attention_launch(*(t.data_ptr() for t in ts), mask.data_ptr(),
                                         out.data_ptr(), B, n, H, KL, RD, S, float(scale),
                                         _DTYPE_CODE[dt], _stream(q_lat.device))
    build.check("latent_attention", rc)
    return out


# -----------------------------------------------------------------------------
# the serving norm
# -----------------------------------------------------------------------------

_NORM_MAX_TPR = 512  # threads of a row at most (csrc/rms_norm.cu kMaxThreads)
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def rms_norm_plan(d: int, dtype) -> tuple[int, int, int]:
    """(values a load, threads a row, loads a thread) of the ``rms_norm``
    kernel for rows of d values, a function of d and the dtype alone: the
    kernel's order of summation over a row is fixed by it
    (csrc/rms_norm.cu).  16-byte loads where d is a multiple of their
    values, else single values; threads a power of two from 32, doubling
    while a thread would make more than 4 loads, up to 512; loads a power
    of two (at most 8 of 16 bytes, 16 of one value)."""
    vec = 16 // _ELEM_BYTES[dtype]
    vec = vec if d % vec == 0 else 1
    loads = d // vec
    tpr = 32
    while tpr < _NORM_MAX_TPR and tpr * 4 < loads:
        tpr *= 2
    nv = 1
    while nv * tpr < loads:
        nv *= 2
    if nv > (8 if vec > 1 else 16):
        raise ValueError(f"rms_norm: rows of d={d} exceed the kernel's {tpr} x {nv} loads")
    return vec, tpr, nv


@work.counted("rms_norm", work.rms_norm)
def rms_norm(x, weight, eps: float):
    """x: [..., d]; weight: [d] -> x * rsqrt(mean(x², -1) + eps) * weight,
    in x's dtype (f32 arithmetic).  The serving forward's norm
    (``models.common.rms_norm``): the kernel sums each row's squares in an
    order set by d alone (``rms_norm_plan``), so a row computed alone equals
    the same row among any number of rows, bit for bit; PyTorch's reduction
    picks its order by the number of rows.  The kernel takes float32 or
    bfloat16 (the weight is taken in x's dtype).  No backward: a norm under
    a gradient is the plain version (``models.common.rms_norm``), and one
    here raises."""
    d = x.shape[-1] if x.ndim else 0
    if x.ndim < 1 or tuple(weight.shape) != (d,):
        raise ValueError(f"rms_norm: bad shapes x{tuple(x.shape)} weight{tuple(weight.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError("rms_norm: no backward; a norm under a gradient is the plain "
                           "version (models.common.rms_norm)")
    route = _route("rms_norm", x, weight)
    if route == "cpu":
        return ref.rms_norm_ref(x, weight, eps)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rms_norm: x must be float32 or bfloat16, got {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    M = x.numel() // d if d else 0
    if route == "meta" or M == 0:
        return out
    vec, tpr, nv = rms_norm_plan(d, x.dtype)
    x2, w = x.reshape(M, d).contiguous(), weight.to(x.dtype).contiguous()
    if vec > 1:  # 16-byte loads from 16-byte bases
        x2 = x2.clone() if x2.data_ptr() % 16 else x2
        w = w.clone() if w.data_ptr() % 16 else w
    lib = build.lib("rms_norm")
    with _on(x.device):
        LAUNCHES["rms_norm"] += 1
        rc = lib.rms_norm_launch(x2.data_ptr(), w.data_ptr(), out.data_ptr(), M, d, vec, tpr, nv,
                                 float(eps), _DTYPE_CODE[x.dtype], _stream(x.device))
    build.check("rms_norm", rc)
    return out


# -----------------------------------------------------------------------------
# KV-cache row moves
# -----------------------------------------------------------------------------

_KV_SMEM_BYTES = 96 * 1024  # the staged segments of one block: M rows x chunk bytes
_KV_CHUNK = 256  # the column chunk a block moves, bytes ...
_KV_MIN_CHUNK = 128  # ... halved down to this while the grid is under ...
_KV_MIN_BLOCKS = 2 * 132  # ... two blocks for each SM of an H100
_KV_MAX_LEAVES = 16  # the leaves of one launch: kMaxLeaves of csrc/kv_moves.cu


def kv_move_plan(leaf_shapes, B: int, M: int, elem_bytes: int) -> tuple[int, int]:
    """(chunk, blocks) of one ``kv_move_leaves`` launch on leaves of these
    shapes ([U, B, S, ...]), ``M`` moves per batch row and ``elem_bytes``
    per value: the bytes of a row each block moves for all M rows, and the
    number of blocks.  A function of the shapes alone, never of the plan's
    data: 256-byte chunks, 128 when that fills the card better, smaller
    only when M rows of a chunk would not fit the block's shared memory."""
    rows = [(int(s[0]), math.prod(s[3:]) * elem_bytes) for s in leaf_shapes]

    def blocks(chunk):
        return sum(U * B * -(-row // chunk) for U, row in rows)

    chunk = _KV_CHUNK
    while chunk > _KV_MIN_CHUNK and blocks(chunk) < _KV_MIN_BLOCKS:
        chunk //= 2
    while chunk > 16 and M * chunk > _KV_SMEM_BYTES:
        chunk //= 2
    if M * chunk > _KV_SMEM_BYTES:
        raise ValueError(f"kv_move_leaves: M={M} rows do not fit the shared-memory stage")
    return chunk, blocks(chunk)


@work.counted("kv_move_rows", work.kv_move_leaves)
def kv_move_leaves(leaves, src, dst, mask, *, donate: bool = False) -> list:
    """Move rows of every row leaf of one cache in one launch: leaves[i]
    [U_i, B, S, ...] (U and trailing dims may differ; B, S and the dtype
    are shared); src/dst int [B, M]; mask bool [B, M].  For every active
    move (mask set, 0 <= src, dst < S) out[u, b, dst] = arr[u, b, src], as
    a parallel assignment (all sources read before any write).

    ``donate=True`` moves in place on the card and returns the leaves
    themselves: the caller must own them.  ``donate=False`` never writes a
    leaf and returns fresh tensors (the async snapshot contract,
    core/kv.py), also for an empty plan.  On the CPU both return fresh
    tensors when there is a move.  Too many leaves for the kernel's table
    raise; nothing is split into several launches."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("kv_move_leaves: no leaf")
    first = leaves[0]
    for i, x in enumerate(leaves):
        if x.ndim < 3 or tuple(x.shape[1:3]) != tuple(first.shape[1:3]):
            raise ValueError(f"kv_move_leaves: leaf {i} {tuple(x.shape)} is no [U, B, S, ...] "
                             f"leaf of B, S = {tuple(first.shape[1:3])}")
        if x.dtype != first.dtype:
            raise TypeError(f"kv_move_leaves: leaf {i} is {x.dtype}, leaf 0 {first.dtype}")
    if len(leaves) > _KV_MAX_LEAVES:
        raise ValueError(f"kv_move_leaves: {len(leaves)} leaves, one launch takes at most "
                         f"{_KV_MAX_LEAVES}")
    B, S = first.shape[1:3]
    M = src.shape[-1]
    if src.shape != (B, M) or dst.shape != (B, M) or mask.shape != (B, M):
        raise ValueError(f"kv_move_leaves: src/dst/mask must be [B={B}, M], got "
                         f"{tuple(src.shape)}/{tuple(dst.shape)}/{tuple(mask.shape)}")
    if M == 0:
        return leaves if donate else [x.clone() for x in leaves]
    route = _route("kv_move_leaves", *leaves, src, dst, mask)
    if route == "meta":
        return leaves if donate else [torch.empty_like(x) for x in leaves]
    if route == "cpu":
        return [ref.kv_move_rows_ref(x, src, dst, mask) for x in leaves]
    if not all(x.is_contiguous() for x in leaves):
        raise ValueError("kv_move_leaves: the cache leaves must be contiguous")
    outs = leaves if donate else [torch.empty_like(x) for x in leaves]
    if all(x.numel() == 0 for x in leaves):
        return outs  # no leaf holds an element: nothing to launch
    # rows move as raw bytes: the widest element that every row length and
    # base pointer allows (a divisor of 16), 16 bytes at the serving widths
    row_bytes = [math.prod(x.shape[3:]) * x.element_size() for x in leaves]
    ptrs = [(x.data_ptr(), y.data_ptr()) for x, y in zip(leaves, outs)]
    es = math.gcd(16, *row_bytes, *(p for pair in ptrs for p in pair))
    chunk, _ = kv_move_plan([x.shape for x in leaves], B, M, first.element_size())
    src = src.to(torch.int32).contiguous()
    dst = dst.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    # the leaf table, one row (arr, out, F, U) per leaf
    table = array.array("q", [v for (a, o), r, x in zip(ptrs, row_bytes, leaves)
                              for v in (a, o, r // es, x.shape[0])])
    lib = build.lib("kv_moves")
    with _on(first.device):
        LAUNCHES["kv_move_rows"] += 1
        rc = lib.kv_move_leaves_launch(table.buffer_info()[0], len(leaves), src.data_ptr(),
                                       dst.data_ptr(), mask.data_ptr(), B, S, M, es, chunk,
                                       0 if donate else 1, _stream(first.device))
    build.check("kv_moves", rc)
    return outs


def kv_move_rows(arr, src, dst, mask, *, donate: bool = False):
    """Move rows of one cache leaf arr [U, B, S, ...]: ``kv_move_leaves``
    on that one leaf (same semantics and contract); returns the tensor."""
    return kv_move_leaves([arr], src, dst, mask, donate=donate)[0]


# -----------------------------------------------------------------------------
# slot lifecycle writes
# -----------------------------------------------------------------------------

@work.counted("slot_write_rows", work.slot_write_rows)
def slot_write_rows(cache_leaves, donor_leaves, slot: int):
    """Write batch row 0 of every donor leaf into batch row ``slot`` of the
    matching cache leaf — or zeros, when ``donor_leaves`` is None — for all
    leaves in one launch.

    cache_leaves[i]: [U_i, B, ...]; donor_leaves[i]: [U_i, 1, ...] of the
    same dtype and trailing dims; ``slot`` a host int in [0, B).  On the
    card the leaves are written in place and returned; on the CPU fresh
    tensors are returned.  A leaf that breaks the contract raises on either
    device: nothing is copied leaf by leaf on the card."""
    L = len(cache_leaves)
    if L == 0 or (donor_leaves is not None and len(donor_leaves) != L):
        raise ValueError(f"slot_write_rows: leaf lists must be equal and non-empty: {L} vs "
                         f"{None if donor_leaves is None else len(donor_leaves)}")
    for i, big in enumerate(cache_leaves):
        if big.ndim < 2:
            raise ValueError(f"slot_write_rows: cache leaf {i} {tuple(big.shape)} has no "
                             "batch axis")
        if donor_leaves is not None:
            one = donor_leaves[i]
            if tuple(one.shape) != (big.shape[0], 1) + tuple(big.shape[2:]):
                raise ValueError(f"slot_write_rows: donor leaf {i} {tuple(one.shape)} does not "
                                 f"match cache leaf {tuple(big.shape)}")
            if one.dtype != big.dtype:
                raise TypeError(f"slot_write_rows: dtype mismatch in leaf {i}: cache "
                                f"{big.dtype} vs donor {one.dtype}")
        if not 0 <= slot < big.shape[1]:
            raise ValueError(f"slot_write_rows: slot {slot} outside [0, {big.shape[1]})")
    tensors = list(cache_leaves) + ([] if donor_leaves is None else list(donor_leaves))
    route = _route("slot_write_rows", *tensors)
    if route == "meta":
        return list(cache_leaves)
    if route == "cpu":
        return ref.slot_write_rows_ref(cache_leaves, donor_leaves, slot)
    lib = build.lib("slot_write")
    max_leaves = lib.slot_write_rows_max_leaves()  # the kernel's pointer table
    if L > max_leaves:
        raise ValueError(f"slot_write_rows: {L} leaves, the kernel takes at most {max_leaves}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("slot_write_rows: cache and donor leaves must be contiguous")
    row_bytes = [math.prod(big.shape[2:]) * big.element_size() for big in cache_leaves]
    if all(big.numel() == 0 for big in cache_leaves):
        return list(cache_leaves)  # no leaf holds an element: nothing to launch
    # rows move as raw bytes: the widest element that every row length and
    # base pointer allows, 16 bytes at the serving widths
    es = 16
    for v in row_bytes + [t.data_ptr() for t in tensors]:
        es = math.gcd(es, v)  # a divisor of 16: 1, 2, 4, 8 or 16
    P = ctypes.c_void_p * L
    dst = P(*(t.data_ptr() for t in cache_leaves))
    src = P(*((None,) * L if donor_leaves is None else (t.data_ptr() for t in donor_leaves)))
    rows = (ctypes.c_longlong * L)(*(b // es for b in row_bytes))
    U = (ctypes.c_int * L)(*(t.shape[0] for t in cache_leaves))
    B = (ctypes.c_int * L)(*(t.shape[1] for t in cache_leaves))
    dev = cache_leaves[0].device
    with _on(dev):
        LAUNCHES["slot_write_rows"] += 1
        rc = lib.slot_write_rows_launch(ctypes.addressof(dst), ctypes.addressof(src),
                                        ctypes.addressof(rows), ctypes.addressof(U),
                                        ctypes.addressof(B), L, int(slot), es, _stream(dev))
    build.check("slot_write", rc)
    return list(cache_leaves)


# -----------------------------------------------------------------------------
# int4 AWQ dequant-GEMM
# -----------------------------------------------------------------------------

@work.counted("int4_matmul", work.int4_matmul)
def int4_matmul(x, qweight, scales, zeros, *, group_size: int = 128):
    """x: [T, K]; qweight: int8 [K//2, N] packed (low nibble even k, high
    nibble odd k, ``repro_torch.quant``); scales/zeros: [K//group_size, N].

    Returns x @ ((q - z) * s), [T, N] in x's dtype.  Scales and zeros of
    any float dtype are taken as f32.  The kernel takes x in float32 or
    bfloat16, any T >= 0 and any N; the group size must be even and divide
    K."""
    if x.ndim != 2 or qweight.ndim != 2:
        raise ValueError(f"int4_matmul: x{tuple(x.shape)} and qweight{tuple(qweight.shape)} "
                         "must be 2-D")
    T, K = x.shape
    N = qweight.shape[1]
    if group_size <= 0 or group_size % 2 or K % group_size:
        raise ValueError(f"int4_matmul: K={K} must be a multiple of group_size={group_size}, "
                         "which must be even")
    if qweight.shape[0] * 2 != K:
        raise ValueError(f"int4_matmul: qweight{tuple(qweight.shape)} packs "
                         f"{qweight.shape[0] * 2} values of K, x has K={K}")
    G = K // group_size
    if tuple(scales.shape) != (G, N) or tuple(zeros.shape) != (G, N):
        raise ValueError(f"int4_matmul: scales{tuple(scales.shape)} and zeros"
                         f"{tuple(zeros.shape)} must be [K//group_size={G}, N={N}]")
    if qweight.dtype != torch.int8:
        raise TypeError(f"int4_matmul: qweight must be int8 packed nibbles, got {qweight.dtype}")
    if not (scales.is_floating_point() and zeros.is_floating_point()):
        raise TypeError(f"int4_matmul: scales/zeros must be float, got "
                        f"{scales.dtype}/{zeros.dtype}")
    route = _route("int4_matmul", x, qweight, scales, zeros)
    if route == "meta":
        _, splits = stream_plan(K, N, _STREAM_TILE_N, group_size)
        out = torch.empty((T, N), dtype=x.dtype, device=x.device)
        _stream_partials(x.device, splits, 1, T, N)  # allocated and freed, as by a launch
        return out
    if route == "cpu":
        return ref.int4_matmul_ref(x, qweight, scales, zeros, group_size)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"int4_matmul: x must be float32 or bfloat16, got {x.dtype}")
    if T == 0 or N == 0 or K == 0:  # nothing to launch
        return x.new_zeros((T, N))
    x, qweight = x.contiguous(), qweight.contiguous()
    scales = scales.to(torch.float32).contiguous()
    zeros = zeros.to(torch.float32).contiguous()
    k_split, splits = stream_plan(K, N, _STREAM_TILE_N, group_size)
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    part, ctr, stream = _stream_scratch(x.device, splits, 1, T, N)
    lib = build.lib("int4_matmul")
    with _on(x.device):
        LAUNCHES["int4_matmul"] += 1
        rc = lib.int4_matmul_launch(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                                    zeros.data_ptr(), out.data_ptr(), _ptr(part), _ptr(ctr), T,
                                    K, N, group_size, k_split, splits, _STREAM_ROWS_PER_PASS,
                                    _DTYPE_CODE[x.dtype], stream)
    build.check("int4_matmul", rc)
    return out
