#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

It takes no options and runs every phase, in order:
  build    build the six CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels  hold each kernel against its plain PyTorch version on the card
           (tree_attention — also each row bit for bit against itself alone
           at n=1, and a call with kv_bound against one without —
           decode_attention — also bit for bit against tree_attention at
           one query — fused_swiglu and int4_matmul — row 0 alone and a
           repeated call bit for bit too — kv_move_rows and kv_move_leaves
           (one leaf and the whole cache, in place and copying through),
           slot_write_rows, f32 and bf16), also at the single-layer shapes
           of llama3-3b, llama3-70b, deepseek-coder-1.3b / 33b and
           granite-20b (head groupings 3, 8, 1, 7, 48: tree_attention at
           the verify n 8 and an expansion n 4, decode_attention,
           fused_swiglu at M 1 and 8, kv_move_leaves on each full-depth
           cache) and of the families of phase (h) (tree_attention and
           decode_attention at mixtral's G 6 and musicgen's hd 64,
           fused_swiglu at every dense MLP, kv_move_leaves in place and
           copying through and slot_write_rows on deepseek-moe's two-group
           cache and minicpm3's MLA latents), and time kernel, plain
           version and the PyTorch call that computes the same function
           (for fused_swiglu a composite of cuBLAS and elementwise calls),
           with CUDA events
  serve    the tree engine at full width, llama3-8b target, f32, bs 8, w 4,
           S_max 512, weights drawn once by ``build_engine(smoke=False)``:
           lockstep ``generate()`` — (a) the serve CLI defaults with the
           llama3-1b draft, 3 requests, prompt 16, max_new 48, d from the
           profile pass; (b) self-draft on the same 8B weights, 2 requests —
           then continuous batching through ``ContinuousBatchingRuntime``
           on a wall clock, 2 slots, a seeded Poisson trace of 4 requests
           (prompts 8-16, max_new 32), reduced to the first 16 of the 8B's
           layers and 8 of the 1B's: (c1) lockstep 8B+1B, (c2) async
           rounds 8B+1B (nearly every lookahead rolls back), (c3) async 8B
           self-draft (lookaheads commit), (c4) lockstep 8B self-draft (the
           control of (c3)).  Every output must equal the
           port's own target-only greedy decode (and, in (c), its solo
           ``generate()``); each kernel of a path must have launched in its
           run; each run must make one host sync per round.
  chain    chain-mode speculation, ``ChainSpecEngine.session().generate()``,
           k 4, f32, prompt 16, max_new 32, S_max 512: (d3) llama3-8b +
           llama3-1b on the weights above, parallel, 1 request; then
           zamba2-2.7b at full width (54 mamba2 layers, the shared attention
           block every 6), weights seed 0 with the lm_head x4: (d1)
           self-draft, parallel, 2 requests (every chain commits and the
           next one is reused); (d2) an independent seed-7 draft of the same
           config, parallel and serial, 1 request (rollback: the draft
           recomputes from its pre-round state).  Every output must equal
           the greedy decode, each chain kernel must have launched, and each
           request must make one host sync per round and one for its first
           token.
  awq      (e), between (d3) and (d1): the AWQ int4 path on the llama3-8b
           and llama3-1b weights drawn for (a): every weight of layer 0
           (wq, wk, wv, wo, wg, wu, wd, each as the [K, N] the forward
           multiplies by) quantized on the card by
           ``repro_torch.quant.quantize_groupwise`` (group 128), then
           ``ops.int4_matmul`` at M 1 (a decode step), 8 (the 8B verify) and
           16 (a prompt), f32 and bf16, each result held against
           ``x @ dequantize(q)`` and the plain version, row 0 alone and a
           repeated call bit for bit; the 8B wq, wk, wg and wd timed at
           M 1 and 8, beside torch's ``_weight_int4pack_mm`` in bf16.
  dense    (f1) llama3-3b + llama3-1b at full width and depth through
           ``build_engine`` (the serve CLI's defaults: bs 8, w 4, c 2, d from
           the profile pass), 2 requests; (f2) deepseek-coder-33b reduced to
           8 of its 62 layers + deepseek-coder-1.3b, 1 request; (f3)
           granite-20b reduced to 8 of its 52 layers drafting for itself at
           d 2, 1 request: lockstep, f32, max_new 32, each output equal to
           the greedy decode, one host sync per round
  rwkv6    chain mode on rwkv6-7b at full width and depth (k 4, f32,
           max_new 32, 1 request): (g1) self-draft, parallel; (g2)/(g2s) an
           independent seed-7 draft reduced to 8 of its 32 layers, parallel
           and serial.  rwkv6 calls none of the port's kernels; each output
           must equal the greedy decode with one host sync per round and
           one per request
  families (h1) deepseek-moe-16b at full depth (a dense layer, then 27 moe
           layers of 64 experts, top 6, 2 shared), (h2) mixtral-8x22b cut
           to 4 of its 56 layers (8 experts, top 2, G 6, sliding window),
           (h3) minicpm3-4b at full depth (MLA), (h4) musicgen-large at
           full depth (hd 64; a prefill of the table's embeddings must
           equal the token prefill bit for bit): each drafting for itself
           at d 2 through the tree engine, lockstep, f32, 1 request,
           max_new 24, the MoE paths drop-free (capacity_factor E / k),
           each output equal to the greedy decode with one host sync per
           round, the greedy decode's launches counted with the run's;
           (h5) llama-3.2-vision-90b cut to one unit (4 dense blocks and a
           cross block) through the Model API: prefill 16 tokens with
           seeded stub encoder states, 16 greedy decode steps, then one
           traced spec_forward of the same tokens under a causal chain
           mask, whose argmax must equal the decode at every position
  shapes   every shape at which a path called a kernel, held against its
           plain version again

Each path prints its launches and a kernel trace of two rounds
(``build/traces/trace_<path>.json``).  The last two lines of standard output
are the ``kernels`` JSON line and the ``{"ok": true, "device": ...}`` line;
any failure exits non-zero before them.  It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_OPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}  # f32 CUDA cores / bf16 dense
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
INT4_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}  # f32: tests/test_kernels.py's
SOURCES = {  # kernel -> (its CUDA source, the TPU kernel it replaces)
    "tree_attention": ("src/repro_torch/kernels/csrc/tree_attention.cu",
                       "src/repro/kernels/tree_attention.py:82"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:76"),
    "fused_swiglu": ("src/repro_torch/kernels/csrc/fused_swiglu.cu",
                     "src/repro/kernels/fused_swiglu.py:44"),
    "kv_move_rows": ("src/repro_torch/kernels/csrc/kv_moves.cu",
                     "src/repro/kernels/kv_moves.py:112"),
    "slot_write_rows": ("src/repro_torch/kernels/csrc/slot_write.cu",
                        "src/repro/kernels/kv_moves.py:182"),
    "int4_matmul": ("src/repro_torch/kernels/csrc/int4_matmul.cu",
                    "src/repro/kernels/int4_matmul.py:52"),
}
TREE_SHAPES = [  # (B, n, Hq, Hkv, hd, S): tests/test_kernels.py:24-31 ...
    (2, 4, 8, 2, 64, 96), (1, 8, 4, 4, 32, 128), (2, 3, 6, 3, 80, 200),
    (1, 16, 8, 1, 128, 256), (3, 1, 4, 2, 128, 64),
    # ... and the slice's: llama3-8b decode / expand / verify, llama3-1b expand / fill
    (1, 1, 32, 8, 128, 512), (1, 4, 32, 8, 128, 512), (1, 8, 32, 8, 128, 512),
    (1, 4, 32, 8, 64, 512), (1, 8, 32, 8, 64, 512),
    # ... and the chain paths': zamba2 verify (hd 80, G 1)
    (1, 4, 32, 32, 80, 512),
]
TREE_SERVE_SHAPES = [  # phase (c)'s 2-slot rounds: 8B verify / expand, 1B expand / fill;
    # batch row 1 is checked once with random rows and once parked (every query masked)
    (2, 8, 32, 8, 128, 512), (2, 4, 32, 8, 128, 512), (2, 4, 32, 8, 64, 512),
    (2, 8, 32, 8, 64, 512),
]
PREFIX = 48  # prefix rows of the timed masks: prompt 16 + 32 tokens emitted
# a head size that is no multiple of 8 (the contract is hd % 4 == 0): the bf16
# kernel's 8-byte copies and zero-padded columns, which no model shape reaches
TREE_ODD_HD, DECODE_ODD_HD = (2, 3, 8, 2, 36, 100), (2, 8, 2, 36, 72)
DECODE_SHAPES = [  # (B, Hq, Hkv, hd, S): tests/test_torch_kernels.py's, hd 64/80/128, G 1/4 ...
    (2, 8, 2, 64, 160), (2, 4, 4, 80, 200), (1, 16, 4, 128, 96), (3, 4, 4, 64, 100),
]
DECODE_TIMED = [  # ... and the paths': decode_step of llama3-8b, llama3-1b, zamba2-2.7b
    ("8B-decode", (1, 32, 8, 128, 512)), ("1B-decode", (1, 32, 8, 64, 512)),
    ("zamba2-decode", (1, 32, 32, 80, 512)),
]
TREE_TIMED = [  # the main path's calls of tree_attention
    ("8B-verify", (1, 8, 32, 8, 128, 512)), ("8B-expand", (1, 4, 32, 8, 128, 512)),
    ("1B-expand", (1, 4, 32, 8, 64, 512)), ("1B-fill", (1, 8, 32, 8, 64, 512)),
]
TREE_ROW_ALONE = [  # row i at n must equal row i alone at n = 1: the paths' verify and
    # fill, zamba2's verify (G 1, hd 80) and a TREE_SHAPES case with G 8
    ("8B-verify", (1, 8, 32, 8, 128, 512)), ("1B-fill", (1, 8, 32, 8, 64, 512)),
    ("zamba2-verify", (1, 4, 32, 32, 80, 512)), ("G8", (1, 16, 8, 1, 128, 256)),
]
SWIGLU_SHAPES = [  # (M, K, N) of the main path's calls of fused_swiglu
    ("8B-verify", (8, 4096, 14336)), ("8B-decode", (1, 4096, 14336)),
    ("8B-expand", (4, 4096, 14336)), ("8B-prefill", (16, 4096, 14336)),
    ("1B-expand", (4, 2048, 8192)), ("1B-fill", (8, 2048, 8192)), ("1B-prefill", (16, 2048, 8192)),
    ("1B-decode", (1, 2048, 8192)), ("zamba2-decode", (1, 2560, 10240)),
    ("zamba2-verify", (4, 2560, 10240)), ("zamba2-prefill", (16, 2560, 10240)),
]
SWIGLU_TIMED = ("8B-verify", "8B-expand", "1B-expand", "1B-fill", "8B-prefill", "8B-decode",
                "1B-decode", "zamba2-decode")  # the last three: the chain paths' decode_step
KV_TIMED = [  # (U, M, F) of the main path's kv_move_leaves calls, timed at B 1 and 2
    ("8B-reroot", (32, 73, 1024)), ("8B-compact", (32, 8, 1024)), ("1B-reroot", (16, 73, 512)),
]
SLOT_SHAPES = [  # the serving caches' leaves (k and v) [U, B, S, Hkv, hd]
    ("8B", [(32, 2, 512, 8, 128)] * 2), ("1B", [(16, 2, 512, 8, 64)] * 2),
]
INT4_SHAPES = [  # (M, K, N): tests/test_kernels.py's, and a ragged N (no multiple of 4)
    (8, 256, 96), (32, 128, 300), (5, 384, 128), (3, 256, 301),
]
INT4_TIMED = [  # (label, K, N) of phase (e)'s llama3-8b layer weights, timed at M 1 and 8
    ("8B-wg", 4096, 14336), ("8B-wq", 4096, 4096), ("8B-wk", 4096, 1024), ("8B-wd", 14336, 4096),
]
AWQ_GROUP = 128  # the paper's AWQ group size (repro/quant/awq.py)
AWQ_ROWS = (1, 8, 16)  # phase (e)'s M: a decode step, the 8B verify, a prompt
MAIN_KERNELS = ("tree_attention", "fused_swiglu", "kv_move_rows")  # launched by generate()
SERVE_KERNELS = MAIN_KERNELS + ("slot_write_rows",)  # and by continuous serving
CHAIN_KERNELS = ("tree_attention", "decode_attention", "fused_swiglu")  # by the chain engine
ALL_KERNELS = ("tree_attention", "decode_attention", "fused_swiglu", "kv_move_rows",
               "slot_write_rows", "int4_matmul")
CHAIN_K, CHAIN_NEW = 4, 32  # chain length and new tokens per request of phase (d)
DENSE_NEW = (  # (label, config) of the dense configs of phase (f) and their kernel checks
    ("3B", "llama3-3b"), ("70B", "llama3-70b"), ("ds1.3B", "deepseek-coder-1.3b"),
    ("ds33B", "deepseek-coder-33b"), ("granite", "granite-20b"))
DENSE_NEW_PATHS = {  # (f1)-(f3): target, its depth on the card (None: full), draft (None: self)
    "f1": ("llama3-3b", None, "llama3-1b"),
    "f2": ("deepseek-coder-33b", 8, "deepseek-coder-1.3b"),
    "f3": ("granite-20b", 8, None),
}
DENSE_NEW_TOKENS = 32  # max_new per request of phase (f)
RWKV_DRAFT_LAYERS = 8  # the seed-7 rwkv6-7b draft of (g2)/(g2s), cut from 32
SERVE_C_LAYERS = (16, 8)  # phase (c)'s depth: the first layers of the 8B (of 32) and 1B (of 16)
FAMILY_NEW = (  # (label, config, checks) of the families of phase (h): "attention" holds
    # tree and decode attention at its heads, "kv" kv_move_leaves and slot_write_rows at its
    # cache; fused_swiglu is held at every dense MLP
    ("mixtral", "mixtral-8x22b", {"attention"}), ("dsmoe", "deepseek-moe-16b", {"kv"}),
    ("minicpm3", "minicpm3-4b", {"kv"}), ("musicgen", "musicgen-large", {"attention"}),
    ("vision", "llama-3.2-vision-90b", set()))
FAMILY_PATHS = {  # (h1)-(h4): config, its depth on the card (None: full), the kernels it launches
    "h1": ("deepseek-moe-16b", None, MAIN_KERNELS + ("decode_attention",)),
    "h2": ("mixtral-8x22b", 4, ("tree_attention", "kv_move_rows")),  # no dense MLP; decode by tree
    "h3": ("minicpm3-4b", None, ("fused_swiglu", "kv_move_rows")),  # MLA: no attention kernel
    "h4": ("musicgen-large", None, MAIN_KERNELS + ("decode_attention",)),
}
FAMILY_TOKENS = 24  # max_new of (h1)-(h4)
VISION_LAYERS = 5  # (h5): one unit of llama-3.2-vision-90b, 4 dense blocks + 1 cross, of 100
VISION_STEPS = 16  # (h5): prompt 16, then 16 greedy decode steps


def new_shapes() -> dict:
    """label -> the single-layer shapes of a DENSE_NEW or FAMILY_NEW config
    at full width and S 512 where its paths call a kernel: tree_attention
    (B, n, Hq, Hkv, hd, S) at the verify (n 8) and a draft expansion (n 4)
    and decode_attention (B, Hq, Hkv, hd, S) — of the families only
    mixtral's (G 6) and musicgen's (hd 64), the new head shapes —,
    fused_swiglu (M, K, N) at M 1 and 8 for every dense MLP, the cache's row
    leaves [(U, row width)] for kv_move_leaves (the dense configs and
    deepseek-moe's two groups: k and v of each; minicpm3: the MLA latents),
    and for those two families the serving leaves [U, B 2, S, ...] for
    slot_write_rows."""
    from repro_torch.configs import get_config

    out = {}
    dense = [(label, name, {"attention", "kv"}) for label, name in DENSE_NEW]
    for label, name, checks in dense + list(FAMILY_NEW):
        c = get_config(name)
        hq, hkv, hd = c.n_heads, c.n_kv_heads, c.head_dim
        family = label not in dict(DENSE_NEW)
        m = out[label] = {}
        if "attention" in checks:
            m.update(verify=(1, 8, hq, hkv, hd, 512), expand=(1, 4, hq, hkv, hd, 512),
                     decode=(1, hq, hkv, hd, 512))
        if "dense" in c.layer_kinds:
            m["swiglu"] = [(1, c.d_model, c.d_ff), (8, c.d_model, c.d_ff)]
        if "kv" not in checks:
            continue
        if c.attn_kind == "mla":
            m["kv"] = [(c.n_layers, c.kv_lora_rank), (c.n_layers, c.rope_head_dim)]
        else:
            Us = [c.first_k_dense, c.n_layers - c.first_k_dense] if c.first_k_dense else \
                [c.n_layers]
            m["kv"] = [(U, hkv * hd) for U in Us for _ in "kv"]
        if family:
            m["slot"] = [(U, 2, 512, F) for U, F in m["kv"]]
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


_CLOCK: list = []  # monotonic times: the script's start, then the end of each phase


def timing(phase: str) -> None:
    """Print the seconds since the last phase ended and since the start."""
    from repro_torch.obs.clock import monotonic

    now = monotonic()
    print(f"phase {phase}: {now - _CLOCK[-1]:.1f} s (script so far {now - _CLOCK[0]:.1f} s)",
          flush=True)
    _CLOCK.append(now)


# -----------------------------------------------------------------------------
# timing and bounds
# -----------------------------------------------------------------------------


class Timer:
    """Median device time of ``fn`` over ``reps`` calls: CUDA events around
    each call, the 50 MB L2 flushed before each (the main path finds weights
    and caches cold), and the card held busy for about a millisecond before
    the first event, so that the host has queued all of ``fn``'s launches
    before the card reaches them and the time holds no host overhead."""

    SLEEP_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 21) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return sorted(times)[reps // 2]


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over HBM rate vs
    operations over the peak rate of the inputs' type."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[str(dtype)] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_close(name, got, want, dtype, tols=TOL) -> float:
    torch = sys.modules["torch"]
    tol = tols[str(dtype)]
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"{name}: kernel disagrees with the plain version: max |err| "
             f"{max_err(got, want):.3e} > tol {tol}")
    return max_err(got, want)


# -----------------------------------------------------------------------------
# phases
# -----------------------------------------------------------------------------


def time_row(rows, timer, card, name, label, dtype, err, kernel, plain, library, nbytes, n_ops,
             library_note=""):
    """Time kernel, plain version and library call (None: there is none;
    ``library_note`` says why, or what the call is), print the row, and
    keep the first row of each kernel in ``rows``."""
    b_ms, b_by = bound(nbytes, n_ops, dtype)
    row = dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
               max_abs_err=err, ms=timer(kernel), plain_ms=timer(plain), bound_ms=b_ms,
               bound_by=b_by, library_ms=None if library is None else timer(library),
               shape=f"{label} {str(dtype).removeprefix('torch.')}")
    lib = f"- {library_note}".rstrip() if library is None else \
        f"{row['library_ms']:.4f} ms {library_note}".rstrip()
    print(f"  time {name} {row['shape']}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, library {lib}, bound {b_ms:.6f} ms ({b_by}) "
          f"on {card}", flush=True)
    rows.setdefault(name, row)


def kv_plan(torch, M, n_off):
    """One batch row's move plan as the paths make it: overlapping source
    and destination windows (reversed beyond 8 rows), ``n_off`` entries
    masked off and one negative source.  src/dst int32 [1, M], mask [1, M]."""
    base = 96
    src = torch.arange(base + 7, base + 7 + M, dtype=torch.int32, device="cuda")
    dst = torch.arange(base, base + M, dtype=torch.int32, device="cuda")
    src = src.flip(0) if M > 8 else src
    mask = torch.ones(M, dtype=torch.bool, device="cuda")
    mask[:n_off] = False
    if M > 2:
        src[-1] = -1
    return src[None], dst[None], mask[None]


def kv_plan2(torch, M, parked):
    """Phase (c)'s 2-slot plans: row 0 as ``kv_plan``, row 1 its own
    windows (destinations reversed beyond 8 rows, its last entry masked
    off), or every entry of row 1 masked off (a parked slot)."""
    src0, dst0, mask0 = kv_plan(torch, M, n_off=min(M, 3) if M > 8 else 0)
    src1 = torch.arange(203, 203 + M, dtype=torch.int32, device="cuda")
    dst1 = torch.arange(200, 200 + M, dtype=torch.int32, device="cuda")
    dst1 = dst1.flip(0) if M > 8 else dst1
    mask1 = torch.ones(M, dtype=torch.bool, device="cuda")
    mask1[-1:] = False
    if parked:
        mask1[:] = False
    return (torch.cat([src0, src1[None]]), torch.cat([dst0, dst1[None]]),
            torch.cat([mask0, mask1[None]]))


def kv_active(src, dst, mask, S):
    """(batch rows, sources, destinations) of the active moves, int64."""
    torch = sys.modules["torch"]
    act = mask & (src >= 0) & (src < S) & (dst >= 0) & (dst < S)
    b = torch.arange(src.shape[0], device=src.device)[:, None].expand_as(src)
    return b[act], src[act].long(), dst[act].long()


def kv_library(leaves, src, dst, mask, donate):
    """The PyTorch call that computes the same moves: index assignment on
    each leaf (a parallel assignment: the right side is gathered first),
    after ``clone()`` when copying through."""
    b, s, d = kv_active(src, dst, mask, leaves[0].shape[2])

    def run():
        for x in leaves:
            y = x if donate else x.clone()
            y[:, b, d] = x[:, b, s]

    return run


def kv_move_bytes(leaves, src, dst, mask, donate) -> int:
    """The bytes the moves must move, each input byte read once and each
    output byte written once: in place the active source rows read and
    the destination rows written; copying through every row of the fresh
    output written, and read the rows it needs — the unmoved rows and the
    sources."""
    B, S = leaves[0].shape[1:3]
    b, s, d = kv_active(src, dst, mask, S)
    if donate:
        rows = 2 * len(s)
    else:
        rows = B * S + sum(len((set(range(S)) - set(d[b == r].tolist())) |
                               set(s[b == r].tolist())) for r in range(B))
    return sum(rows * x.shape[0] * x[0, 0, 0].numel() * x.element_size() for x in leaves)


def phase_build():
    from repro_torch.kernels import build

    secs = build.build_all()
    for name in build.SOURCES:
        lines = [ln.strip() for ln in build.BUILD_LOG.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        for ln in lines:
            print(f"  ptxas {name}: {ln}")
        build.lib(name)
    print(f"build: {len(build.SOURCES)} kernel libraries with nvcc for sm_90a in {secs:.1f}s",
          flush=True)


def phase_kernels(torch, timer, card):
    """Each kernel against its plain version on the card, then the times of
    kernel, plain version and library call at the main path's shapes.
    Returns one JSON row per kernel (its first timed shape, float32)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = (torch.float32, torch.bfloat16)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    rows = {}
    new = new_shapes()

    def timed(*args):
        time_row(rows, timer, card, *args)

    print(f"kernels on {card} (tolerance f32 2e-5, bf16 2e-2; int4_matmul f32 1e-4; kv_move "
          "exact; decode_attention bit for bit against tree_attention at n=1):")

    # --- tree_attention --------------------------------------------------------
    cases = [(shape, False) for shape in TREE_SHAPES + [TREE_ODD_HD]] + \
        [(shape, parked) for shape in TREE_SERVE_SHAPES for parked in (False, True)] + \
        [(m[kind], False) for m in new.values() if "verify" in m for kind in ("verify", "expand")]
    for dtype in dtypes:
        for (B, n, hq, hkv, hd, S), parked in cases:
            q, k, v = randn(B, n, hq, hd, dtype=dtype), randn(B, S, hkv, hd, dtype=dtype), \
                randn(B, S, hkv, hd, dtype=dtype)
            mask = torch.rand((B, n, S), generator=gen, device="cuda") < 0.5
            mask[:, 0, :] = False  # a fully masked row must give exact zeros
            if parked:
                mask[-1] = False  # a parked slot: no query of its row sees a key
            got = ops.tree_attention(q, k, v, mask)
            want = ref.tree_attention_ref(q, k, v, mask)
            torch.cuda.synchronize()
            name = f"tree_attention {(B, n, hq, hkv, hd, S)}{' parked' if parked else ''} {dtype}"
            err = check_close(name, got, want, dtype)
            if bool((got[:, 0] != 0).any()) or (parked and bool((got[-1] != 0).any())):
                fail(f"{name}: a fully masked row is not 0")
            print(f"  tree_attention B{B} n{n} Hq{hq} Hkv{hkv} hd{hd} S{S}"
                  f"{', row B-1 parked' if parked else ''} {dtype}: max|err| {err:.2e}")
    def path_mask(B, n, S):
        """A mask as the main path builds it mid-request: a prefix of PREFIX
        rows that every query sees, then the tree rows, each query its own
        row and a random subset of the earlier ones (its ancestors).  No
        query attends a key at or past PREFIX + n."""
        mask = torch.zeros((B, n, S), dtype=torch.bool, device="cuda")
        mask[:, :, :PREFIX] = True
        anc = torch.rand((B, n, n), generator=gen, device="cuda") < 0.5
        mask[:, :, PREFIX:PREFIX + n] = anc.tril(-1) | torch.eye(n, dtype=torch.bool,
                                                                 device="cuda")
        return mask

    # row i of a call equals row i alone at n = 1, bit for bit, under a random
    # mask (every split live) and under the path's mask, there also with the
    # bound PREFIX + n (one live split), which must equal the call without it
    row_alone = TREE_ROW_ALONE + [(f"{label}-verify", m["verify"]) for label, m in new.items()
                                  if "verify" in m]
    for dtype in dtypes:
        for label, (B, n, hq, hkv, hd, S) in row_alone:
            q, k, v = randn(B, n, hq, hd, dtype=dtype), randn(B, S, hkv, hd, dtype=dtype), \
                randn(B, S, hkv, hd, dtype=dtype)
            rand = torch.rand((B, n, S), generator=gen, device="cuda") < 0.5
            for kind, mask, bound in (("random mask", rand, None),
                                      ("path mask", path_mask(B, n, S), PREFIX + n)):
                full = ops.tree_attention(q, k, v, mask)
                name = f"tree_attention {label} {(B, n, hq, hkv, hd, S)} {kind} {dtype}"
                if bound is not None and not torch.equal(
                        ops.tree_attention(q, k, v, mask, kv_bound=bound), full):
                    fail(f"{name}: kv_bound={bound} differs from the call without it")
                for i in range(n):
                    alone = ops.tree_attention(q[:, i:i + 1], k, v, mask[:, i:i + 1],
                                               kv_bound=bound)
                    if not torch.equal(alone[:, 0], full[:, i]):
                        fail(f"{name}: row {i} differs from the same row alone at n=1 by "
                             f"{max_err(alone[:, 0], full[:, i]):.3e} (must be bit for bit)")
            print(f"  tree_attention {label} B{B} n{n} Hq{hq} Hkv{hkv} hd{hd} S{S} {dtype}: each "
                  f"row bit for bit equal to itself alone at n=1 (random and path masks), "
                  f"kv_bound {PREFIX + n} bit for bit equal to none")
    # times under the path's mask, without a bound (the tree engine's calls)
    # and with the bound PREFIX + n (the chain verify's)
    tree_timed = TREE_TIMED + [(f"{label}-{kind}", m[kind]) for label, m in new.items()
                               if "verify" in m for kind in ("verify", "expand")]
    for dtype in dtypes:
        for label, (B, n, hq, hkv, hd, S) in tree_timed:
            q, k, v = randn(B, n, hq, hd, dtype=dtype), randn(B, S, hkv, hd, dtype=dtype), \
                randn(B, S, hkv, hd, dtype=dtype)
            mask = path_mask(B, n, S)
            err = check_close(f"tree_attention {label} {dtype}", ops.tree_attention(q, k, v, mask),
                              ref.tree_attention_ref(q, k, v, mask), dtype)
            es = q.element_size()
            kv_rows = int(mask.any(1).sum())  # each needed K/V row read once
            nbytes = 2 * q.numel() * es + mask.numel() + 2 * kv_rows * hkv * hd * es
            qt, kt, vt, mt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
            timed("tree_attention", f"{label} B{B} n{n} Hq{hq} Hkv{hkv} hd{hd} S{S}", dtype, err,
                  lambda: ops.tree_attention(q, k, v, mask),
                  lambda: ref.tree_attention_ref(q, k, v, mask),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      qt, kt, vt, attn_mask=mt, enable_gqa=True),
                  nbytes, 4 * hd * hq * int(mask.sum()))
            bound = PREFIX + n
            ms = timer(lambda: ops.tree_attention(q, k, v, mask, kv_bound=bound))
            print(f"  time tree_attention {label} {str(dtype).removeprefix('torch.')} with "
                  f"kv_bound {bound} (one live split): kernel {ms:.4f} ms on {card}", flush=True)

    # --- decode_attention ---------------------------------------------------------
    # every case: per-row lengths from {0, 1, S/2 + 3, S} (each in every row
    # position), and the host-int length the main path passes; the result
    # must agree with the plain version and equal tree_attention at n = 1
    # under the mask cols < length bit for bit
    for dtype in dtypes:
        for B, hq, hkv, hd, S in DECODE_SHAPES + [DECODE_ODD_HD] + [s for _, s in DECODE_TIMED] + \
                [m["decode"] for m in new.values() if "decode" in m]:
            q, k, v = randn(B, hq, hd, dtype=dtype), randn(B, S, hkv, hd, dtype=dtype), \
                randn(B, S, hkv, hd, dtype=dtype)
            errs = []
            for i in range(4):
                lens = torch.tensor([[0, 1, S // 2 + 3, S][(i + b) % 4] for b in range(B)],
                                    dtype=torch.int32, device="cuda")
                got = ops.decode_attention(q, k, v, lens)
                mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
                tree = ops.tree_attention(q[:, None], k, v, mask[:, None])[:, 0]
                want = ref.decode_attention_ref(q, k, v, lens)
                torch.cuda.synchronize()
                name = f"decode_attention {(B, hq, hkv, hd, S)} lengths {lens.tolist()} {dtype}"
                errs.append(check_close(name, got, want, dtype))
                if not torch.equal(got, tree):
                    fail(f"{name}: differs from tree_attention at n=1 by "
                         f"{max_err(got, tree):.3e} (must be bit for bit)")
                if bool((got[lens == 0] != 0).any()):
                    fail(f"{name}: a row of length 0 is not 0")
                L = int(lens[0])
                if not torch.equal(ops.decode_attention(q, k, v, L),
                                   ops.decode_attention(q, k, v, lens.new_full((B,), L))):
                    fail(f"{name}: the host-int length {L} differs from the same length per row")
            print(f"  decode_attention B{B} Hq{hq} Hkv{hkv} hd{hd} S{S} {dtype}: lengths 0, 1, "
                  f"{S // 2 + 3}, {S} in every row, max|err| {max(errs):.2e}, bit for bit equal "
                  "to tree_attention at n=1")
    print(f"  decode_attention: every case above bit for bit equal to tree_attention at n=1, "
          f"f32 and bf16, on {card}")
    decode_timed = DECODE_TIMED + [(f"{label}-decode", m["decode"]) for label, m in new.items()
                                   if "decode" in m]
    for dtype in dtypes:  # times at a decode step mid-request (length PREFIX)
        for label, (B, hq, hkv, hd, S) in decode_timed:
            q, k, v = randn(B, hq, hd, dtype=dtype), randn(B, S, hkv, hd, dtype=dtype), \
                randn(B, S, hkv, hd, dtype=dtype)
            L = PREFIX
            lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
            err = check_close(f"decode_attention {label} {dtype}", ops.decode_attention(q, k, v, L),
                              ref.decode_attention_ref(q, k, v, lens), dtype)
            es = q.element_size()
            kt, vt = k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
            timed("decode_attention", f"{label} L{L} B{B} Hq{hq} Hkv{hkv} hd{hd} S{S}", dtype, err,
                  lambda: ops.decode_attention(q, k, v, L),
                  lambda: ref.decode_attention_ref(q, k, v, lens),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      q[:, :, None], kt, vt, enable_gqa=True),
                  2 * q.numel() * es + 2 * B * L * hkv * hd * es, 4 * B * hq * hd * L)

    # --- fused_swiglu -----------------------------------------------------------
    swiglu_new = [(f"{label}-M{shape[0]}", shape) for label, m in new.items()
                  for shape in m.get("swiglu", ())]
    for dtype in dtypes:
        for label, (M, K, N) in SWIGLU_SHAPES + swiglu_new:
            x = randn(M, K, dtype=dtype)
            wg, wu = randn(K, N, dtype=dtype, scale=K ** -0.5), randn(K, N, dtype=dtype, scale=K ** -0.5)
            got, want = ops.fused_swiglu(x, wg, wu), ref.fused_swiglu_ref(x, wg, wu)
            torch.cuda.synchronize()
            err = check_close(f"fused_swiglu {(M, K, N)} {dtype}", got, want, dtype)
            # the K-reduction order must not depend on M: row 0 alone == row 0 in the batch
            if M > 1 and not torch.equal(ops.fused_swiglu(x[:1], wg, wu), got[:1]):
                fail(f"fused_swiglu {(M, K, N)} {dtype}: row 0 differs between M={M} and M=1")
            if not torch.equal(ops.fused_swiglu(x, wg, wu), got):
                fail(f"fused_swiglu {(M, K, N)} {dtype}: two calls on the same input differ")
            print(f"  fused_swiglu {label} M{M} K{K} N{N} {dtype}: max|err| {err:.2e}, row 0 "
                  "alone and a repeated call bit for bit equal")
            if label in SWIGLU_TIMED or (label, (M, K, N)) in swiglu_new:
                es = x.element_size()
                # no single PyTorch call computes silu(x@wg) * (x@wu): the library
                # time is a composite of two cuBLAS products and two elementwise passes
                timed("fused_swiglu", f"{label} M{M} K{K} N{N}", dtype, err,
                      lambda: ops.fused_swiglu(x, wg, wu), lambda: ref.fused_swiglu_ref(x, wg, wu),
                      lambda: torch.nn.functional.silu(x @ wg) * (x @ wu),
                      (M * K + 2 * K * N + M * N) * es, 4 * M * K * N,
                      "(composite: silu(x @ wg) * (x @ wu), 2 cuBLAS + 2 elementwise)")

    # --- kv_move_rows / kv_move_leaves ----------------------------------------------
    def check_moves(name, leaves, src, dst, mask) -> float:
        """Both entry points — ``kv_move_rows`` on each leaf alone and
        ``kv_move_leaves`` on all of them in one launch — in both variants,
        exactly against the plain version: donate=False returns fresh
        tensors and leaves its inputs as they were, donate=True moves in
        place (on copies, so ``leaves`` are kept).  Returns the max error."""
        want = [ref.kv_move_rows_ref(x, src, dst, mask) for x in leaves]
        before = [x.clone() for x in leaves]
        got = {"kv_move_rows donate=False": [ops.kv_move_rows(x, src, dst, mask, donate=False)
                                             for x in leaves],
               "kv_move_leaves donate=False": ops.kv_move_leaves(leaves, src, dst, mask,
                                                                 donate=False)}
        torch.cuda.synchronize()
        if not all(torch.equal(x, b) for x, b in zip(leaves, before)) or any(
                g.data_ptr() == x.data_ptr() for outs in got.values()
                for g, x in zip(outs, leaves)):
            fail(f"{name}: donate=False wrote or returned its input")
        for entry in ("kv_move_rows", "kv_move_leaves"):
            work = [x.clone() for x in leaves]
            if entry == "kv_move_rows":
                moved = [ops.kv_move_rows(x, src, dst, mask, donate=True) for x in work]
            else:
                moved = ops.kv_move_leaves(work, src, dst, mask, donate=True)
            got[f"{entry} donate=True"] = moved
            torch.cuda.synchronize()
            if any(g.data_ptr() != w.data_ptr() for g, w in zip(moved, work)):
                fail(f"{name}: {entry} donate=True did not move in place")
        err = max(max_err(g, w) for outs in got.values() for g, w in zip(outs, want))
        for what, outs in got.items():
            if not all(torch.equal(g, w) for g, w in zip(outs, want)):
                fail(f"{name}: {what} disagrees with the plain version: max |err| {err:.3e} "
                     "(must be exact)")
        print(f"  {name}: both entry points and both variants exact, inputs kept by "
              "donate=False")
        return err

    S = 512
    for dtype in dtypes:  # a second leaf of other U and F shares the launch; rows of 20 or
        # 10 bytes take the register path, 16-byte multiples the bulk copies
        for F0, F1 in ((1024, (2, 36)), (5, (3,))):
            leaves = [randn(32, 1, S, F0, dtype=dtype), randn(16, 1, S, *F1, dtype=dtype)]
            for M in (0, 8, 73):
                check_moves(f"kv_move [U32 F{F0} + U16 F{math.prod(F1)}, B1 S{S}] M={M} {dtype}",
                            leaves, *kv_plan(torch, M, n_off=min(M, 3)))
    for dtype in dtypes:  # the main path's moves at phase (c)'s 2 slots: k and v
        for label, (U, M, Fw) in KV_TIMED:
            leaves = [randn(U, 2, S, Fw, dtype=dtype) for _ in range(2)]
            for parked in (False, True):
                check_moves(f"kv_move {label} k+v U{U} B2 S{S} F{Fw} M{M}, "
                            f"{'row 1 parked' if parked else 'a plan per row'} {dtype}",
                            leaves, *kv_plan2(torch, M, parked))
    for dtype in dtypes:
        for label, (U, M, Fw) in KV_TIMED:
            for B in (1, 2):
                leaves = [randn(U, B, S, Fw, dtype=dtype) for _ in range(2)]  # k and v
                src, dst, mask = kv_plan(torch, M, n_off=min(M, 3) if M > 8 else 0) if B == 1 \
                    else kv_plan2(torch, M, parked=False)
                act = mask & (src >= 0) & (dst >= 0)
                shape = f"{label} U{U} B{B} S{S} F{Fw} M{M} ({int(act.sum())} active)"
                err = check_moves(f"kv_move {shape} {dtype}", leaves, src, dst, mask)
                for donate in (True, False):
                    for use in (leaves[:1], leaves):
                        what = ("in place" if donate else "copy-through") + \
                            (", k+v in one launch" if len(use) == 2 else ", one leaf")
                        note = "(index assignment" + ("" if donate else " after clone()") + \
                            (", per leaf)" if len(use) == 2 else ")")
                        timed("kv_move_rows", f"{shape} {what}", dtype, err,
                              lambda use=use, donate=donate: ops.kv_move_leaves(
                                  use, src, dst, mask, donate=donate),
                              lambda use=use: [ref.kv_move_rows_ref(x, src, dst, mask)
                                               for x in use],
                              kv_library(use, src, dst, mask, donate),
                              kv_move_bytes(use, src, dst, mask, donate), 0, note)
    for dtype in dtypes:  # the configs' caches (full depth), every row leaf, B 1: the
        # compaction (M 8) and a re-root (M 73), timed in place as the paths move them;
        # the families' also copying through
        for label, m in new.items():
            if "kv" not in m:
                continue
            leaves = [randn(U, 1, S, Fw, dtype=dtype) for U, Fw in m["kv"]]
            what = " + ".join(f"U{U} F{Fw}" for U, Fw in m["kv"])
            for M in (8, 73):
                src, dst, mask = kv_plan(torch, M, n_off=min(M, 3) if M > 8 else 0)
                act = mask & (src >= 0) & (dst >= 0)
                shape = f"{label} [{what}] B1 S{S} M{M} ({int(act.sum())} active)"
                err = check_moves(f"kv_move {shape} {dtype}", leaves, src, dst, mask)
                for donate in (True, False) if "slot" in m else (True,):
                    how = "in place" if donate else "copy-through"
                    timed("kv_move_rows", f"{shape} {how}, {len(leaves)} leaves in one launch",
                          dtype, err,
                          lambda donate=donate: ops.kv_move_leaves(leaves, src, dst, mask,
                                                                   donate=donate),
                          lambda: [ref.kv_move_rows_ref(x, src, dst, mask) for x in leaves],
                          kv_library(leaves, src, dst, mask, donate),
                          kv_move_bytes(leaves, src, dst, mask, donate), 0,
                          "(index assignment" + ("" if donate else " after clone()") +
                          ", per leaf)")

    # --- slot_write_rows ----------------------------------------------------------
    def check_slot(name, leaves, donors, slot) -> float:
        """Install (donors) or zero (None) on copies of ``leaves``, in place,
        exactly against the plain version; every other row bit for bit as
        it was.  Returns the max error."""
        want = ref.slot_write_rows_ref(leaves, donors, slot)
        work = [x.clone() for x in leaves]
        got = ops.slot_write_rows(work, donors, slot)
        torch.cuda.synchronize()
        if any(g.data_ptr() != w.data_ptr() for g, w in zip(got, work)):
            fail(f"{name}: the kernel did not write the cache in place")
        err = max(max_err(g, w) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{name}: kernel disagrees with the plain version: max |err| {err:.3e} "
                 "(must be exact)")
        others = [b for b in range(leaves[0].shape[1]) if b != slot]
        if not all(torch.equal(g[:, others], x[:, others]) for g, x in zip(got, leaves)):
            fail(f"{name}: a row other than slot {slot} changed")
        return err

    slot_cases = SLOT_SHAPES + [(label, m["slot"]) for label, m in new.items() if "slot" in m]
    for dtype in dtypes:
        for label, shapes in slot_cases:
            leaves = [randn(*sh, dtype=dtype) for sh in shapes]
            donors = [randn(sh[0], 1, *sh[2:], dtype=dtype) for sh in shapes]
            for slot in range(shapes[0][1]):
                errs = [check_slot(f"slot_write_rows {label} {what} slot {slot} {dtype}",
                                   leaves, d, slot)
                        for what, d in (("install", donors), ("zero", None))]
                print(f"  slot_write_rows {label} L{len(shapes)} {[list(sh) for sh in shapes]} "
                      f"slot {slot} {dtype}: install and zero exact (max|err| {max(errs):.1e}), "
                      "other rows unchanged")
    for dtype in dtypes:
        for label, shapes in slot_cases:
            leaves = [randn(*sh, dtype=dtype) for sh in shapes]
            donors = [randn(sh[0], 1, *sh[2:], dtype=dtype) for sh in shapes]
            slab = sum(x.shape[0] * x[0, 0].numel() * x.element_size() for x in leaves)  # a row
            what = f"L{len(shapes)} {[list(sh) for sh in shapes]}"

            def install_lib(leaves=leaves, donors=donors):
                for big, one in zip(leaves, donors):
                    big[:, 1].copy_(one[:, 0])

            def zero_lib(leaves=leaves):
                for big in leaves:
                    big[:, 1].zero_()

            err = check_slot(f"slot_write_rows {label} install {dtype}", leaves, donors, 1)
            timed("slot_write_rows", f"{label}-install {what} slot 1", dtype, err,
                  lambda: ops.slot_write_rows(leaves, donors, 1),
                  lambda: ref.slot_write_rows_ref(leaves, donors, 1), install_lib, 2 * slab, 0)
            err = check_slot(f"slot_write_rows {label} zero {dtype}", leaves, None, 1)
            timed("slot_write_rows", f"{label}-zero {what} slot 1 (no donor)", dtype, err,
                  lambda: ops.slot_write_rows(leaves, None, 1),
                  lambda: ref.slot_write_rows_ref(leaves, None, 1), zero_lib, slab, 0)

    # --- int4_matmul ----------------------------------------------------------------
    # the reference's shapes, a ragged N, and phase (e)'s timed 8B shapes; times
    # are taken in phase (e) on the path's own weights
    from repro_torch import quant

    cases = INT4_SHAPES + [(M, K, N) for _, K, N in INT4_TIMED for M in (1, 8)]
    for dtype in dtypes:
        for M, K, N in cases:
            x = randn(M, K, dtype=dtype)
            q = quant.quantize_groupwise(randn(K, N, scale=K ** -0.5), AWQ_GROUP)
            err = check_int4(torch, f"int4_matmul {(M, K, N)} {dtype}", x, q, dtype)
            print(f"  int4_matmul M{M} K{K} N{N} g{AWQ_GROUP} {dtype}: max|err| {err:.2e}, row 0 "
                  "alone and a repeated call bit for bit equal")
    return rows


def check_int4(torch, name, x, q, dtype, got=None) -> float:
    """int4_matmul's result ``got`` (computed here when None) against its
    plain version and ``x @ dequantize(q)``; row 0 alone must equal row 0
    of the batch (the K order does not depend on M) and a second call the
    first, bit for bit.  Returns the max error."""
    from repro_torch import quant
    from repro_torch.kernels import ops, ref

    if got is None:
        got = ops.int4_matmul(x, *q[:3], group_size=q.group_size)
    want = ref.int4_matmul_ref(x, *q[:3], q.group_size)
    oracle = (x.float() @ quant.dequantize(q)).to(dtype)
    torch.cuda.synchronize()
    err = check_close(name, got, want, dtype, INT4_TOL)
    check_close(f"{name} against x @ dequantize(q)", got, oracle, dtype, INT4_TOL)
    if x.shape[0] > 1 and not torch.equal(ops.int4_matmul(x[:1], *q[:3], group_size=q.group_size),
                                          got[:1]):
        fail(f"{name}: row 0 differs between M={x.shape[0]} and M=1")
    if not torch.equal(ops.int4_matmul(x, *q[:3], group_size=q.group_size), got):
        fail(f"{name}: two calls on the same input differ")
    return err


def int4pack_library(torch, x, q):
    """torch's groupwise-int4 product (``_weight_int4pack_mm``) on the same
    weight, as the yardstick of int4_matmul: the nibbles repacked by
    ``_convert_weight_to_int4pack`` (even k in the high nibble of [N, K/2]),
    and zero' = (8 - z) * s, since it dequantizes (q - 8) * s + zero'.
    Returns (a function of no arguments, "") or (None, the reason there is
    none)."""
    from repro_torch import quant
    from repro_torch.kernels import ref

    if x.dtype != torch.bfloat16:
        return None, "(no such call in f32)"
    aten = torch.ops.aten
    try:
        qv = quant.unpack_int4(q.qweight).to(torch.int32).t().contiguous()  # [N, K]
        packed = aten._convert_weight_to_int4pack((qv[:, ::2] << 4 | qv[:, 1::2]).to(torch.uint8),
                                                  8)
        sz = torch.stack([q.scales, (8 - q.zeros) * q.scales], -1).to(torch.bfloat16).contiguous()
        got = aten._weight_int4pack_mm(x, packed, q.group_size, sz)
    except (AttributeError, RuntimeError) as e:  # the yardstick only; the port never calls it
        return None, f"(_weight_int4pack_mm: {type(e).__name__}: {str(e).splitlines()[0][:120]})"
    want = ref.int4_matmul_ref(x, *q[:3], q.group_size)
    tol = INT4_TOL[str(x.dtype)]
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        return None, f"(_weight_int4pack_mm disagrees by {max_err(got, want):.3e})"
    return (lambda: aten._weight_int4pack_mm(x, packed, q.group_size, sz)), ""


def phase_awq(torch, timer, rows, weights, card):
    """(e) the AWQ int4 path on the weights ``build_engine`` drew for (a):
    every layer-0 weight of the 8B target and the 1B draft quantized on the
    card, then multiplied at AWQ_ROWS in f32 and bf16; after the launch
    counts are read, each result is held against ``x @ dequantize(q)`` and
    the plain version, with row 0 alone and a repeated call bit for bit,
    and the INT4_TIMED weights are timed at M 1 and 8.  Returns the run's
    launch counts."""
    from repro_torch import quant
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    timed_at = {(label.split("-")[1], K, N): label for label, K, N in INT4_TIMED}
    print(f"awq (e): layer 0 of llama3-8b and llama3-1b, group {AWQ_GROUP}, M {AWQ_ROWS}, f32 "
          f"and bf16 (tolerance f32 1e-4, bf16 2e-2) on {card}", flush=True)
    ops.reset_launch_counts()
    path = []  # (model, weight name, q, [(dtype, M, x, result)])
    for model, params in weights:
        layer = params.layers[0]
        d = layer.attn["wq"].shape[0]
        mats = {k: layer.attn[k].reshape(d, -1) for k in ("wq", "wk", "wv")}
        mats["wo"] = layer.attn["wo"].reshape(-1, d)
        mats.update({k: layer.mlp[k] for k in ("wg", "wu", "wd")})
        for wname, w in mats.items():
            q = quant.quantize_groupwise(w, AWQ_GROUP)
            products = []
            for dtype in (torch.float32, torch.bfloat16):
                for M in AWQ_ROWS:
                    x = torch.randn((M, w.shape[0]), generator=gen, device="cuda").to(dtype)
                    products.append((dtype, M, x, ops.int4_matmul(x, *q[:3], group_size=AWQ_GROUP)))
            path.append((model, wname, q, products))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"awq (e): {sum(len(p[3]) for p in path)} products; kernel launches {counts}", flush=True)
    if counts["int4_matmul"] == 0:
        fail("awq (e): int4_matmul never launched on the AWQ path")
    to_time = []
    for model, wname, q, products in path:
        K, N = 2 * q.qweight.shape[0], q.qweight.shape[1]
        for dtype, M, x, got in products:
            err = check_int4(torch, f"awq (e) {model} {wname} [{K}, {N}] M{M} {dtype}", x, q,
                             dtype, got)
            if model == "8B" and M in (1, 8) and (wname, K, N) in timed_at:
                to_time.append((timed_at[wname, K, N], M, dtype, x, q, err))
        packed_mb = (q.qweight.numel() + 8 * q.scales.numel()) / 1e6
        print(f"  {model} {wname} [{K}, {N}]: {packed_mb:.1f} MB packed with its scales and "
              f"zeros ({K * N * 4 / 1e6:.1f} MB in f32); M {AWQ_ROWS} f32 and bf16 agree, row 0 "
              "alone and a repeated call bit for bit", flush=True)
    # bf16 first: its first row, where torch has a groupwise-int4 call, goes into the kernels line
    order = {label: i for i, (label, _, _) in enumerate(INT4_TIMED)}
    for label, M, dtype, x, q, err in sorted(to_time, key=lambda t: (str(t[2]) != "torch.bfloat16",
                                                                       order[t[0]], t[1])):
        K, N = x.shape[1], q.qweight.shape[1]
        library, note = int4pack_library(torch, x, q)
        es = x.element_size()
        nbytes = q.qweight.numel() + 4 * (q.scales.numel() + q.zeros.numel()) + (M * K + M * N) * es
        time_row(rows, timer, card, "int4_matmul", f"{label} M{M} K{K} N{N} g{AWQ_GROUP}", dtype,
                 err, lambda: ops.int4_matmul(x, *q[:3], group_size=AWQ_GROUP),
                 lambda: ref.int4_matmul_ref(x, *q[:3], AWQ_GROUP), library, nbytes,
                 2 * M * K * N, note)
    return counts


def greedy_decode(torch, model, params, prompt, n, S_max):
    """The port's target-only greedy decode (prefill + decode_step loop).
    Returns (tokens [n], top-2 logit margin per position)."""
    lg, cache = model.prefill(params, prompt, S_max=S_max)
    cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    toks, margins = [cur], [lg[:, -1].topk(2).values]
    for _ in range(n - 1):
        lg, cache = model.decode_step(params, cache, cur, S_max)
        cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(cur)
        margins.append(lg[:, -1].topk(2).values)
    t = torch.cat(toks, 1)[0].tolist()
    m = torch.stack(margins)[:, 0]
    return t, (m[:, 0] - m[:, 1]).tolist()


class SyncCounter:
    """Counts the host syncs made inside the ``with`` block, as torch's sync
    debug mode reports them, and where each was made (the innermost frames
    of the port's code)."""

    def __init__(self, torch):
        self.torch, self.where = torch, []

    def _show(self, message, category, filename, lineno, file=None, line=None):
        # a sync, not the mode's one-time note ("Synchronization debug mode is
        # a prototype feature and does not yet detect all synchronizing ...")
        if "synchroniz" in str(message) and "prototype" not in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if os.path.basename(f.filename) != "warnings.py"]
            ours = [f for f in frames if f.filename.startswith(HERE) and f.filename != __file__]
            self.where.append(f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno} via "
                              + " <- ".join(f"{os.path.relpath(f.filename, HERE)}:{f.lineno}"
                                            for f in reversed(ours[-3:])))

    def __enter__(self):
        self._warn = warnings.catch_warnings()
        self._warn.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        self._warn.__exit__(*exc)
        return False

    @property
    def n(self) -> int:
        return len(self.where)


def count_syncs(torch, sess, prompt, rounds: int):
    """Host syncs per lockstep round, and where each was made."""
    eng = sess.engine
    sess.state = eng._prefill_state(sess.tparams, sess.dparams, prompt)
    torch.cuda.synchronize()
    with SyncCounter(torch) as sc:
        for _ in range(rounds):
            sess.step()
    return sc.n / rounds, sorted(set(sc.where))


KERNEL_CLASSES = (  # substring of a CUDA kernel's name -> the layer it belongs to, first
    # match wins: kv_move_leaves_kernel<uint4, ...> before the weight streams'
    # stream_kernel<SwigluMma/SwigluF32/Int4Mma/Int4Generic>
    ("kv_move", "kv_move_rows"), ("swiglu", "fused_swiglu"), ("int4", "int4_matmul"),
    ("slot_write_rows", "slot_write_rows"),
    ("gemm", "matmul (cuBLAS)"), ("gemv", "matmul (cuBLAS)"),
    ("sort", "sort (top-k)"), ("reduce", "reductions"),
)


def layer_of(kernel_name: str) -> str:
    """The layer a traced CUDA kernel belongs to: both attention kernels are
    ``attention_kernel<T, DPL, kByLength>`` (attention.cuh), decode_attention
    the one with the length mask."""
    name = kernel_name.lower()
    if "attention_kernel" in name:
        return "decode_attention" if "true>" in name else "tree_attention"
    return next((c for key, c in KERNEL_CLASSES if key in name), "other")


def busy_union(intervals):
    """Merged [start, end) intervals of one stream's kernels."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def both_streams_busy_us(kernels) -> tuple[float, int]:
    """Microseconds in which kernels of at least two streams ran at once,
    and the number of streams seen."""
    per_stream: dict = {}
    for e in kernels:
        per_stream.setdefault(e.get("args", {}).get("stream"), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    edges = []
    for iv in per_stream.values():
        for a, b in busy_union(iv):
            edges += [(a, 1), (b, -1)]
    both, depth, last = 0.0, 0, None
    for t, step in sorted(edges):
        if depth >= 2:
            both += t - last
        depth += step
        last = t
    return both, len(per_stream)


def trace_rounds(torch, sess, setup, label: str, tag: str, rounds: int = 2) -> None:
    """Where a round's time goes on the card: a torch.profiler trace of
    ``rounds`` rounds (after ``setup(sess)`` and one warm round), its kernels
    summed by layer, the share of the traced wall time in which no kernel
    ran, and — with the async round's two streams — the share in which
    kernels of both streams ran at once.  The trace is written to
    ``build/traces/trace_<tag>.json`` (its kernels; Perfetto reads it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.clock import monotonic

    setup(sess)
    sess.step()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the profiler's notes on its cycles
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = monotonic()
            for _ in range(rounds):
                sess.step()
            torch.cuda.synchronize()
            wall_ms = (monotonic() - t0) * 1e3
        report_trace(prof, label, tag, rounds, wall_ms)


def report_trace(prof, label: str, tag: str, rounds: int, wall_ms: float) -> None:
    """Write a finished profile's kernels to ``build/traces/trace_<tag>.json``
    and print them summed by layer, with the idle and both-streams shares of
    ``wall_ms``."""
    path = os.path.join(HERE, "build", "traces", f"trace_{tag}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    with open(path, "w") as f:  # keep the kernels only: the full trace is tens of MB
        json.dump({"traceEvents": kernels}, f)
    if not kernels:
        print(f"{label}: device busy share not measured (the profiler recorded no kernel)")
        return
    by_layer: dict = {}
    for e in kernels:
        layer = layer_of(e["name"])
        n, ms = by_layer.get(layer, (0, 0.0))
        by_layer[layer] = (n + 1, ms + e["dur"] / 1e3)
    busy = sum(ms for _, ms in by_layer.values())
    both_us, n_streams = both_streams_busy_us(kernels)
    print(f"{label}: traced {rounds} rounds in {wall_ms:.2f} ms wall, {len(kernels)} kernels on "
          f"{n_streams} stream(s), device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}, "
          f"both streams busy {both_us / 1e3:.3f} ms (share {both_us / 1e3 / wall_ms:.4f}); "
          "by layer: " + ", ".join(f"{k} {ms:.3f} ms/{n}" for k, (n, ms) in
                                   sorted(by_layer.items(), key=lambda kv: -kv[1][1])), flush=True)


def run_path(torch, label, eng, tp, dp, prompts, refs, card, kernels=MAIN_KERNELS):
    """Generate every prompt, check it against the greedy decode, report.
    Each of ``kernels`` must have launched.  Returns the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import monotonic

    sess = eng.session(tp, dp)
    sess.generate(prompts[0][:, :4], max_new=4)  # warm the allocator and kernels
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    toks = rounds = 0
    t0 = monotonic()
    outs, stats_all = [], []
    for prompt in prompts:
        out, st = sess.generate(prompt)
        outs.append(out[0])
        stats_all.append(st)
        toks += len(out[0])
        rounds += st.rounds
    torch.cuda.synchronize()
    wall = monotonic() - t0
    counts = ops.launch_counts()
    syncs, sync_lines = count_syncs(torch, sess, prompts[0], rounds=4)
    for i, (out, (ref_toks, margins)) in enumerate(zip(outs, refs)):
        if out != ref_toks[:len(out)] or len(out) != eng.cfg.max_new:
            j = next((p for p, (a, b) in enumerate(zip(out, ref_toks)) if a != b), len(out))
            fail(f"{label} request {i}: speculative output diverges from the greedy decode at "
                 f"position {j} (spec {out[j:j + 3]}, greedy {ref_toks[j:j + 3]}); the target's "
                 f"top-2 logit margin there is {margins[min(j, len(margins) - 1)]:.3e}")
        if any(not (0 <= t < eng.target.cfg.vocab_size) for t in out):
            fail(f"{label} request {i}: token out of the vocabulary")
    if counts["kv_move_rows"] != 2 * rounds:
        fail(f"{label}: kv_move_rows launched {counts['kv_move_rows']} times in {rounds} "
             "rounds, not twice per round (compaction and re-root, one launch per cache)")
    if syncs != 1.0:
        fail(f"{label}: {syncs:.2f} host syncs per round, not one")
    cr = sum(s.total_emitted for s in stats_all) / max(rounds, 1)
    print(f"{label}: {len(prompts)} requests, {toks} tokens, {rounds} rounds, compression "
          f"{cr:.3f}, mean round {wall / max(rounds, 1) * 1e3:.2f} ms, {toks / wall:.2f} tok/s, "
          f"{syncs:.2f} host syncs per round (d={eng.cfg.d}) on {card}; every output equals "
          f"the greedy decode", flush=True)
    print(f"{label}: host syncs made at {sync_lines}", flush=True)
    print(f"{label}: kernel launches {counts}", flush=True)
    trace_rounds(torch, sess, lambda se: setattr(se, "state", eng._prefill_state(
        tp, dp, prompts[0])), label, tag=label.split()[2].strip("()"))
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        fail(f"{label}: kernels never launched on the main path: {missing}")
    return counts


def serve_continuous(torch, label, tag, eng, tp, dp, trace, refs, card):
    """Serve ``trace`` through ContinuousBatchingRuntime on a wall clock, 2
    slots, traced; check every output against the greedy decode and the
    engine's solo ``generate()``, the slot_write_rows launches (4 per
    request), one host sync per round and the traced draft/verify overlap
    (0 lockstep, > 0 async).  Returns the launch counts of the run, its
    SpecStats, and its mean round (ms), tok/s over the wall and TTFT p50 (ms)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer, phase_breakdown
    from repro_torch.obs.clock import monotonic
    from repro_torch.serving import ContinuousBatchingRuntime, Request, WallClock

    asyn = eng.cfg.async_rounds
    tracer = Tracer()
    rt = ContinuousBatchingRuntime(eng, tp, dp, n_slots=2, clock=WallClock(), tracer=tracer)
    rt.submit_trace(Request(rid=r.rid, prompt=r.prompt, arrival_s=r.arrival_s,
                            max_new=r.max_new) for r in trace)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = monotonic()
    with SyncCounter(torch) as sc:
        results = rt.run()
    torch.cuda.synchronize()
    wall = monotonic() - t0
    counts = ops.launch_counts()
    st = rt.stepper.spec_stats
    summ = rt.stats.summary()
    bd = phase_breakdown(tracer)
    toks = sum(len(v) for v in results.values())
    # a round is its span (dispatch through absorption); the wall also holds
    # the admissions and the idle waits for arrivals
    round_ms = sum(sp.dur for sp in tracer.spans("round")) / max(st.rounds, 1) * 1e3
    admit_ms = sum(sp.dur for sp in tracer.spans("admit_prefill")) * 1e3
    print(f"{label}: {len(results)} requests served, {toks} tokens, {st.rounds} rounds, mean round "
          f"{round_ms:.2f} ms, admissions {admit_ms:.1f} ms in all, wall {wall:.2f} s, "
          f"{toks / wall:.2f} tok/s over the wall, TTFT p50 "
          f"{summ['ttft_p50_s'] * 1e3:.1f} ms, mean occupancy {summ['mean_occupancy']:.2f}, "
          f"async rounds {st.spec_rounds}: {st.spec_commits} commits, "
          f"{st.spec_rounds - st.spec_commits} rollbacks; {sc.n / max(st.rounds, 1):.2f} host "
          f"syncs per round; overlap_draft_verify {bd['overlap_draft_verify_s'] * 1e3:.2f} ms, "
          f"draft serialized {bd['draft_serialized_frac']:.3f} of the round (d={eng.cfg.d}) "
          f"on {card}", flush=True)
    print(f"{label}: host syncs made at {sorted(set(sc.where))}", flush=True)
    print(f"{label}: kernel launches {counts}", flush=True)
    if sorted(results) != [r.rid for r in trace]:
        fail(f"{label}: served {sorted(results)}, not every request of the trace")
    sess = eng.session(tp, dp)
    for r in trace:
        out = results[r.rid]
        ref_toks, margins = refs[r.rid]
        if out != ref_toks[:r.max_new] or len(out) != r.max_new:
            j = next((p for p, (a, b) in enumerate(zip(out, ref_toks)) if a != b), len(out))
            fail(f"{label} request {r.rid}: served output diverges from the greedy decode at "
                 f"position {j} (served {out[j:j + 3]}, greedy {ref_toks[j:j + 3]}); the "
                 f"target's top-2 logit margin there is {margins[min(j, len(margins) - 1)]:.3e}")
        solo, _ = sess.generate(r.prompt.reshape(1, -1), max_new=r.max_new)
        if solo[0] != out:
            fail(f"{label} request {r.rid}: served output differs from the solo generate()")
    print(f"{label}: every output equals the solo generate() and the greedy decode", flush=True)
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    if missing:
        fail(f"{label}: kernels never launched on the serving path: {missing}")
    kv_want = 2 * st.rounds + st.spec_rounds - st.spec_commits  # + a re-root per rollback
    print(f"{label}: kv_move_rows launches {counts['kv_move_rows']} in {st.rounds} rounds: "
          f"compaction and re-root, one launch per cache each, the lookahead's re-root and "
          f"a rollback's ({st.spec_rounds - st.spec_commits}) one each", flush=True)
    if counts["kv_move_rows"] != kv_want:
        fail(f"{label}: kv_move_rows launched {counts['kv_move_rows']} times, not {kv_want}")
    if counts["slot_write_rows"] != 4 * len(trace):
        fail(f"{label}: slot_write_rows launched {counts['slot_write_rows']} times for "
             f"{len(trace)} requests, not 4 per request")
    if sc.n != st.rounds:
        fail(f"{label}: {sc.n} host syncs in {st.rounds} rounds, not one per round")
    if asyn != (bd["overlap_draft_verify_s"] > 0.0):
        fail(f"{label}: overlap_draft_verify_s {bd['overlap_draft_verify_s']} with "
             f"async_rounds={asyn}")
    if asyn and st.spec_rounds != st.rounds:
        fail(f"{label}: {st.spec_rounds} of {st.rounds} rounds took the async path")

    def two_live_rows(se):
        se.state = eng.init_state(2)
        for slot in range(2):
            se.admit_slot(slot, trace[slot].prompt)

    trace_rounds(torch, eng.session(tp, dp), two_live_rows, label, tag=tag)
    return counts, st, (round_ms, toks / wall, summ["ttft_p50_s"] * 1e3)


class ShapeLog:
    """The shapes at which the paths call each kernel wrapper: ``install``
    wraps the wrappers in ``repro_torch.kernels.ops`` (the launch counts
    stay the wrappers' own), ``uninstall`` puts them back."""

    KEYS = {  # wrapper -> the shape of one call, from its arguments
        "tree_attention": lambda q, k, v, mask, kv_bound=None: (
            tuple(q.shape) + tuple(k.shape[1:3])),
        "decode_attention": lambda q, k, v, length: tuple(q.shape) + tuple(k.shape[1:3]),
        "fused_swiglu": lambda x, wg, wu: tuple(x.shape) + (wg.shape[1],),
        "kv_move_rows": lambda arr, src, dst, mask, donate=False: (
            tuple(arr.shape), src.shape[1], bool(donate)),
        "kv_move_leaves": lambda leaves, src, dst, mask, donate=False: (
            tuple(tuple(t.shape) for t in leaves), src.shape[1], bool(donate)),
        "slot_write_rows": lambda leaves, donors, slot: (
            tuple(tuple(t.shape) for t in leaves), donors is None),
        "int4_matmul": lambda x, qweight, scales, zeros, group_size=128: (
            tuple(x.shape) + (qweight.shape[1], group_size)),
    }

    def __init__(self, ops):
        self.ops, self.seen, self.saved = ops, {name: set() for name in self.KEYS}, {}

    def install(self):
        for name, key in self.KEYS.items():
            fn = self.saved[name] = getattr(self.ops, name)

            def logged(*a, _fn=fn, _name=name, _key=key, **kw):
                first = a[0][0] if _name in ("slot_write_rows", "kv_move_leaves") else a[0]
                self.seen[_name].add(_key(*a, **kw) + (str(first.dtype),))
                return _fn(*a, **kw)

            setattr(self.ops, name, logged)

    def uninstall(self):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


class RoundTracer:
    """A ``Tracer`` for ``ChainSession.generate`` that profiles rounds
    [1, 1 + rounds): it starts torch.profiler when round 1 begins and stops
    it, after a device sync, when round ``rounds`` ends."""

    def __init__(self, torch, rounds: int = 2):
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.obs import Tracer
        from repro_torch.obs.clock import monotonic

        outer = self

        class _Tracer(Tracer):
            def begin(self, name, track="main", args=None):
                if name == "round" and outer.begun == 1:
                    torch.cuda.synchronize()
                    outer.prof.start()
                    outer.t0 = monotonic()
                outer.begun += name == "round"
                return super().begin(name, track, args)

            def _finish(self, span):
                super()._finish(span)
                if span.name == "round" and outer.begun == 1 + rounds and outer.wall_ms is None:
                    torch.cuda.synchronize()
                    outer.wall_ms = (monotonic() - outer.t0) * 1e3
                    outer.prof.stop()

        self.rounds, self.begun, self.t0, self.wall_ms = rounds, 0, None, None
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.tracer = _Tracer()


def run_chain(torch, label, tag, eng, tp, dp, prompts, refs, card, kernels=CHAIN_KERNELS):
    """Generate every prompt through ``ChainSpecEngine.session().generate``,
    check it against the greedy decode, count launches and host syncs, and
    trace two rounds of one more request.  Each of ``kernels`` must have
    launched.  Returns the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import monotonic

    c = eng.cfg
    sess = eng.session(tp, dp)
    sess.generate(prompts[0][:, :4], max_new=4)  # warm the allocator and kernels
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs, stats = [], []
    t0 = monotonic()
    with SyncCounter(torch) as sc:
        for prompt in prompts:
            out, st = sess.generate(prompt)
            outs.append(out[0])
            stats.append(st)
    torch.cuda.synchronize()
    wall = monotonic() - t0
    counts = ops.launch_counts()
    rounds = sum(st.rounds for st in stats)
    toks = sum(len(o) for o in outs)
    for i, (out, (ref_toks, margins)) in enumerate(zip(outs, refs)):
        if out != ref_toks[:len(out)] or len(out) != c.max_new:
            j = next((p for p, (a, b) in enumerate(zip(out, ref_toks)) if a != b), len(out))
            fail(f"{label} request {i}: chain output diverges from the greedy decode at "
                 f"position {j} (chain {out[j:j + 3]}, greedy {ref_toks[j:j + 3]}); the target's "
                 f"top-2 logit margin there is {margins[min(j, len(margins) - 1)]:.3e}")
    tot = {f: sum(getattr(st, f) for st in stats)
           for f in ("rounds", "emitted", "accepted", "reused_chains", "draft_chains")}
    syncs = (sc.n - len(prompts)) / max(rounds, 1)  # a request's first token aside
    per_round = {k: round(n / max(rounds, 1), 2) for k, n in counts.items()}
    print(f"{label}: {len(prompts)} request(s), {toks} tokens, ChainStats {tot}, compression "
          f"{tot['emitted'] / max(rounds, 1):.3f}, accepted {tot['accepted']} of "
          f"{rounds * (c.k - 1)} drafts, mean round {wall / max(rounds, 1) * 1e3:.2f} ms, "
          f"{toks / wall:.2f} tok/s, {syncs:.2f} host syncs per round (+1 per request: its first "
          f"token) (k={c.k}, {c.mode}) on {card}; every output equals the greedy decode", flush=True)
    print(f"{label}: host syncs made at {sorted(set(sc.where))}", flush=True)
    print(f"{label}: kernel launches {counts}, per round {per_round}", flush=True)
    if sc.n != rounds + len(prompts):
        fail(f"{label}: {sc.n} host syncs for {rounds} rounds of {len(prompts)} request(s), not "
             "one per round and one per request")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        fail(f"{label}: kernels never launched on the chain path: {missing}")
    rt = RoundTracer(torch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the profiler's notes on its cycles
        _, st = eng.session(tp, dp, tracer=rt.tracer).generate(prompts[0])
    if rt.wall_ms is None:
        fail(f"{label}: the traced request ran {st.rounds} rounds, fewer than 3")
    report_trace(rt.prof, label, tag, rt.rounds, rt.wall_ms)
    return counts


def chain_prompts(vocab: int, n: int):
    from repro_torch.data import make_request_stream

    return list(make_request_stream(vocab, 16, 1, n))


def cut_depth(model, params, n_layers):
    """(model, params) of the first ``n_layers`` layers of a drawn dense
    model, on the same tensors (nothing is copied)."""
    import dataclasses

    from repro_torch.models.api import make_model
    from repro_torch.models.transformer import DecoderLM

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    return make_model(cfg, model.device), DecoderLM(
        params.embed, params.final_norm, params.lm_head, list(params.layers[:n_layers]),
        params.shared_attn)


def phase_serve(torch, card):
    import dataclasses

    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.data import make_request_stream, make_request_trace
    from repro_torch.launch.serve import build_engine, profile_depth
    from repro_torch.obs.clock import monotonic

    t0 = monotonic()
    eng, tp, dp, cfgT = build_engine("llama3-8b", "llama3-1b", smoke=False, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: llama3-8b target ({cfgT.param_count() / 1e9:.2f} B params) + llama3-1b draft, "
          f"f32, seeded weights drawn on the card in {monotonic() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    print(profile_depth(eng, tp, dp, 16), flush=True)
    prompts = list(make_request_stream(cfgT.vocab_size, 16, 1, 3))
    refs = [greedy_decode(torch, eng.target, tp, p, eng.cfg.max_new, eng.S_max_t) for p in prompts]
    counts = {"a": run_path(torch, "main path (a) 8B+1B", eng, tp, dp, prompts, refs, card)}
    # (b) self-draft, built the way examples/quickstart.py builds it (draft = target)
    cfg_b = SpecConfig(bs=8, w=4, c=2, d=2, mode="parallel", max_new=48)
    eng_b = SpecEngine(eng.target, eng.target, cfg_b, S_max_t=512, S_max_d=512)
    counts["b"] = run_path(torch, "main path (b) 8B self-draft", eng_b, tp, tp, prompts[:2],
                           refs[:2], card)

    # (c) continuous batching: a Poisson trace at about one request per second,
    # so that arrivals land mid-round and queue while both slots are busy.  The
    # engines run the first SERVE_C_LAYERS layers of build_engine's weights: (c2)
    # is what build_engine(..., async_rounds=True) builds, at that depth, without
    # drawing them again.  4 requests and the cut depth keep the whole script
    # inside its time limit
    trace = make_request_trace(cfgT.vocab_size, 4, rate_rps=1.0, prompt_len=(8, 16),
                               max_new=32, seed=0)
    Tc, tpc = cut_depth(eng.target, tp, SERVE_C_LAYERS[0])
    Dc, dpc = cut_depth(eng.draft, dp, SERVE_C_LAYERS[1])
    print(f"serve (c): trace of {len(trace)} requests, arrivals "
          f"{[round(r.arrival_s, 3) for r in trace]} s, prompts "
          f"{[int(r.prompt.size) for r in trace]}, max_new 32, 2 slots; reduced: the first "
          f"{Tc.cfg.n_layers} of the 8B's {cfgT.n_layers} layers and {Dc.cfg.n_layers} of the "
          f"1B's {eng.draft.cfg.n_layers}", flush=True)
    refs_c = {r.rid: greedy_decode(torch, Tc, tpc, r.prompt.reshape(1, -1), r.max_new,
                                   eng.S_max_t) for r in trace}

    def engine_c(target, draft, cfg):
        return SpecEngine(target, draft, cfg, S_max_t=512, S_max_d=512)

    runs = [
        ("c1", "continuous (c1) lockstep 8B+1B", engine_c(Tc, Dc, eng.cfg), dpc),
        ("c2", "continuous (c2) async 8B+1B",
         engine_c(Tc, Dc, dataclasses.replace(eng.cfg, async_rounds=True)), dpc),
        ("c3", "continuous (c3) async 8B self-draft",
         engine_c(Tc, Tc, dataclasses.replace(cfg_b, async_rounds=True)), tpc),
        ("c4", "continuous (c4) lockstep 8B self-draft", engine_c(Tc, Tc, cfg_b), tpc),
    ]
    perf = {}
    for tag, label, e, draft_params in runs:
        counts[tag], st, perf[tag] = serve_continuous(torch, label, tag, e, tpc, draft_params,
                                                      trace, refs_c, card)
        if tag == "c2" and st.spec_rounds == st.spec_commits:
            fail(f"{label}: no lookahead rolled back")
        if tag == "c3" and st.spec_commits == 0:
            fail(f"{label}: no lookahead committed")
    for asyn, lock in (("c2", "c1"), ("c3", "c4")):  # async against its lockstep twin
        (ra, ta, fa), (rl, tl, fl) = perf[asyn], perf[lock]
        print(f"serve ({asyn}) async against ({lock}) lockstep: mean round {ra:.2f} / {rl:.2f} ms "
              f"({ra / rl - 1:+.1%}), tok/s {ta:.2f} / {tl:.2f} ({ta / tl - 1:+.1%}), TTFT p50 "
              f"{fa:.1f} / {fl:.1f} ms on {card}", flush=True)
    timing("serve (a)-(c)")

    # (d3) chain mode on the same weights: an attention-only target commits by moving len
    from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine

    prompts_d = chain_prompts(cfgT.vocab_size, 1)
    refs_d = [greedy_decode(torch, eng.target, tp, p, CHAIN_NEW, 512) for p in prompts_d]
    chain = ChainSpecEngine(eng.target, eng.draft,
                            ChainConfig(k=CHAIN_K, mode="parallel", max_new=CHAIN_NEW), 512, 512)
    counts["d3"] = run_chain(torch, "chain (d3) llama3-8b + llama3-1b", "d3", chain, tp, dp,
                             prompts_d, refs_d, card)
    timing("chain (d3)")
    return counts, (("8B", tp), ("1B", dp))


def peaked(params):
    params.lm_head.mul_(4.0)  # peaked logits, as build_engine draws them
    return params


def phase_chain(torch, card):
    """(d1)-(d2): zamba2-2.7b at full width, chain mode."""
    from repro_torch.configs import get_config
    from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
    from repro_torch.models.api import make_model

    cfg = get_config("zamba2-2.7b")
    model = make_model(cfg, "cuda")
    tp, dp = peaked(model.init(0)), peaked(model.init(7))
    n_params = sum(t.numel() for t in tp.parameters())
    print(f"chain: zamba2-2.7b ({n_params / 1e9:.3f} B parameters: {cfg.n_layers} mamba2 layers, "
          f"the shared attention block every {cfg.shared_attn_every}), f32, target seed 0 and "
          f"draft seed 7; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    prompts = chain_prompts(cfg.vocab_size, 2)
    refs = [greedy_decode(torch, model, tp, p, CHAIN_NEW, 512) for p in prompts]

    def engine(mode):
        return ChainSpecEngine(model, model, ChainConfig(k=CHAIN_K, mode=mode, max_new=CHAIN_NEW),
                               512, 512)

    counts = {"d1": run_chain(torch, "chain (d1) zamba2-2.7b self-draft", "d1", engine("parallel"),
                              tp, tp, prompts, refs, card)}
    for mode, tag in (("parallel", "d2"), ("serial", "d2s")):
        counts[tag] = run_chain(torch, f"chain (d2) zamba2-2.7b + seed-7 draft, {mode}", tag,
                                engine(mode), tp, dp, prompts[:1], refs[:1], card)
    return counts


def phase_dense(torch, card):
    """(f1)-(f3): the dense configs of DENSE_NEW_PATHS through the tree
    engine, lockstep, at full width (depth cut where named), f32, target
    seed 0 and draft seed 1 with the lm_heads x4; (f1) through
    ``build_engine`` with the serve CLI's defaults, (f2)/(f3) through the
    same ``SpecEngine``.  Each path's weights go before the next's are drawn.
    Returns the launch counts by path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.data import make_request_stream
    from repro_torch.launch.serve import build_engine, profile_depth
    from repro_torch.models.api import make_model
    from repro_torch.obs.clock import monotonic

    counts = {}
    for tag, (tname, depth, dname) in DENSE_NEW_PATHS.items():
        t0 = monotonic()
        if depth is None:  # full depth: the serve CLI's own engine
            eng, tp, dp, cfgT = build_engine(tname, dname, smoke=False, device="cuda",
                                             max_new=DENSE_NEW_TOKENS)
            print(profile_depth(eng, tp, dp, 16), flush=True)
        else:
            cfgT = dataclasses.replace(get_config(tname), n_layers=depth)
            T = make_model(cfgT, "cuda")
            tp = peaked(T.init(0))
            if dname is None:  # self-draft at d 2
                D, dp, d = T, tp, 2
            else:
                D = make_model(get_config(dname), "cuda")
                dp, d = peaked(D.init(1)), 2
            eng = SpecEngine(T, D, SpecConfig(bs=8, w=4, c=2, d=d, mode="parallel",
                                              max_new=DENSE_NEW_TOKENS), S_max_t=512, S_max_d=512)
            if dname is not None:
                print(profile_depth(eng, tp, dp, 16), flush=True)
        torch.cuda.synchronize()
        full = get_config(tname).n_layers
        cut = "" if depth is None else f" (reduced: {depth} of its {full} layers)"
        print(f"dense ({tag}): {tname}{cut} target, {cfgT.param_count() / 1e9:.2f} B params, "
              f"{'self-draft' if dname is None else dname + ' draft'}, f32, weights drawn on the "
              f"card in {monotonic() - t0:.1f}s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
              "allocated", flush=True)
        n_req = 2 if tag == "f1" else 1
        prompts = list(make_request_stream(cfgT.vocab_size, 16, 1, n_req))
        refs = [greedy_decode(torch, eng.target, tp, p, eng.cfg.max_new, eng.S_max_t)
                for p in prompts]
        draft = "self-draft" if dname is None else f"+ {dname}"
        counts[tag] = run_path(torch, f"dense path ({tag}) {tname} {draft}", eng, tp, dp,
                               prompts, refs, card)
        del eng, tp, dp
        torch.cuda.empty_cache()
    return counts


def phase_rwkv(torch, card):
    """(g1)-(g2s): rwkv6-7b chain mode at full width and depth, f32, target
    seed 0 with the lm_head x4: (g1) drafting for itself, parallel; (g2) an
    independent seed-7 draft of RWKV_DRAFT_LAYERS layers, parallel, and
    (g2s) the same serial.  rwkv6 calls none of the port's kernels.
    Returns the launch counts by path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
    from repro_torch.models.api import make_model

    cfg = get_config("rwkv6-7b")
    model = make_model(cfg, "cuda")
    tp = peaked(model.init(0))
    dcfg = dataclasses.replace(cfg, n_layers=RWKV_DRAFT_LAYERS)
    dmodel = make_model(dcfg, "cuda")
    dp = peaked(dmodel.init(7))
    print(f"chain: rwkv6-7b ({cfg.param_count() / 1e9:.3f} B parameters, {cfg.n_layers} layers, "
          f"d {cfg.d_model}), f32, target seed 0; seed-7 draft reduced to {RWKV_DRAFT_LAYERS} of "
          f"{cfg.n_layers} layers ({dcfg.param_count() / 1e9:.3f} B); "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    prompts = chain_prompts(cfg.vocab_size, 1)
    refs = [greedy_decode(torch, model, tp, p, CHAIN_NEW, 512) for p in prompts]

    def engine(draft, mode):
        return ChainSpecEngine(model, draft, ChainConfig(k=CHAIN_K, mode=mode, max_new=CHAIN_NEW),
                               512, 512)

    counts = {"g1": run_chain(torch, "chain (g1) rwkv6-7b self-draft", "g1",
                              engine(model, "parallel"), tp, tp, prompts, refs, card, kernels=())}
    for mode, tag in (("parallel", "g2"), ("serial", "g2s")):
        counts[tag] = run_chain(torch, f"chain ({tag}) rwkv6-7b + seed-7 draft, {mode}", tag,
                                engine(dmodel, mode), tp, dp, prompts, refs, card, kernels=())
    return counts


def phase_families(torch, card):
    """(h1)-(h5): the MoE, MLA, cross-attention and embeddings-input
    families at full width, f32, seed 0 with the lm_head x4.  (h1)-(h4)
    draft for themselves at d 2 through the tree engine, lockstep, 1
    request of FAMILY_TOKENS: each output equal to the greedy decode, one
    host sync per round, and each of the path's kernels launched by the
    engine's run; the greedy decode it is held against (the Model API's
    ``decode_step``) is counted as a run of its own, "<path>-greedy", which
    must launch decode_attention where the path names it.  The MoE paths run
    drop-free: the greedy decode of one row never drops a routed pair, so a
    verify of 8 rows that drops some could not equal it.  (h5) drives the
    vision model through the Model API.  Each path's weights go before the
    next's are drawn.  Returns the launch counts by path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.data import make_request_stream
    from repro_torch.kernels import ops
    from repro_torch.models.api import make_model
    from repro_torch.obs.clock import monotonic

    counts = {}
    for tag, (name, depth, kernels) in FAMILY_PATHS.items():
        t0 = monotonic()
        full = get_config(name)
        cfg, notes = full, []
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
            notes.append(f"reduced: {depth} of its {full.n_layers} layers")
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
            notes.append(f"capacity_factor {full.capacity_factor} -> {cfg.capacity_factor:.4g} "
                         "(drop-free: the greedy decode of one row never drops, so a verify "
                         "that drops could not equal it)")
        model = make_model(cfg, "cuda")
        tp = peaked(model.init(0))
        eng = SpecEngine(model, model, SpecConfig(bs=8, w=4, c=2, d=2, mode="parallel",
                                                  max_new=FAMILY_TOKENS), S_max_t=512, S_max_d=512)
        torch.cuda.synchronize()
        print(f"family ({tag}): {name}, {cfg.param_count() / 1e9:.2f} B params, self-draft d 2, "
              f"f32, weights drawn on the card in {monotonic() - t0:.1f}s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated"
              + "".join(f"; {n}" for n in notes), flush=True)
        prompts = list(make_request_stream(cfg.vocab_size, 16, 1, 1))
        if tag == "h4":  # frame embeddings that are the table's rows: the token prefill, exactly
            tl, _ = model.prefill(tp, prompts[0], S_max=512)
            el, _ = model.prefill(tp, embeds=tp.embed[torch.as_tensor(prompts[0], device="cuda")
                                                      .long()], S_max=512)
            if not torch.equal(el, tl):
                fail(f"family ({tag}): prefill(embeds=embed(prompt)) differs from "
                     f"prefill(tokens=prompt) by {max_err(el, tl):.3e}")
            print(f"family ({tag}): prefill(embeds=embed(prompt)) bit for bit equal to "
                  "prefill(tokens=prompt)", flush=True)
        ops.reset_launch_counts()
        refs = [greedy_decode(torch, model, tp, p, FAMILY_TOKENS, 512) for p in prompts]
        greedy = counts[f"{tag}-greedy"] = ops.launch_counts()
        print(f"family ({tag}): kernel launches of the greedy decode {greedy}", flush=True)
        if "decode_attention" in kernels and greedy["decode_attention"] == 0:
            fail(f"family ({tag}): the greedy decode never launched decode_attention")
        if tag == "h2":
            print(f"family ({tag}): no decode_attention launch: a config with a sliding window "
                  "decodes through tree_attention at n 1", flush=True)
        counts[tag] = run_path(torch, f"family path ({tag}) {name} self-draft", eng, tp, tp,
                               prompts, refs, card,
                               kernels=tuple(k for k in kernels if k != "decode_attention"))
        del eng, tp, model, refs
        torch.cuda.empty_cache()
    counts["h5"] = vision_path(torch, card)
    return counts


def vision_path(torch, card):
    """(h5): llama-3.2-vision-90b cut to VISION_LAYERS layers (one unit: 4
    dense blocks and a cross block) through the Model API: prefill a 16-token
    prompt with seeded stub encoder states [1, n_enc, d], take VISION_STEPS
    greedy ``decode_step``s, then run the same tokens through one
    ``spec_forward`` from the prompt's cache under a causal chain mask: its
    argmax at every position must be the decode's next token.  The
    spec_forward is traced.  Returns the launch counts."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import kv
    from repro_torch.data import make_request_stream
    from repro_torch.kernels import ops
    from repro_torch.models.api import make_model
    from repro_torch.obs.clock import monotonic

    full = get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full, n_layers=VISION_LAYERS)
    t0 = monotonic()
    model = make_model(cfg, "cuda")
    tp = peaked(model.init(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    enc = torch.randn((1, cfg.n_enc_tokens, cfg.d_model), generator=gen, device="cuda")
    torch.cuda.synchronize()
    print(f"family (h5): llama-3.2-vision-90b (reduced: {VISION_LAYERS} of its {full.n_layers} "
          f"layers, one unit {model.cfg.block_pattern}), {cfg.param_count() / 1e9:.2f} B params, "
          f"f32, stub encoder states [1, {cfg.n_enc_tokens}, {cfg.d_model}] seed 0, weights drawn "
          f"on the card in {monotonic() - t0:.1f}s; {torch.cuda.memory_allocated() / 2**30:.1f} "
          "GiB allocated", flush=True)
    prompt = next(iter(make_request_stream(cfg.vocab_size, 16, 1, 1)))
    P, n, S = prompt.shape[1], VISION_STEPS, 512
    model.prefill(tp, prompt, enc=enc, S_max=S)  # warm the allocator and kernels
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lg, cache = model.prefill(tp, prompt, enc=enc, S_max=S)
    snap = {"len": cache["len"], "groups": kv._unflatten(
        cache["groups"], (x.clone() for x in kv._flatten(cache["groups"])))}
    toks = [lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
    for _ in range(n):
        lg, cache = model.decode_step(tp, cache, toks[-1], S)
        toks.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    fed = torch.cat(toks[:-1], 1)  # [1, n]: the tokens the decode steps took
    pos = (P + torch.arange(n, device="cuda", dtype=torch.int32))[None]
    mask = torch.arange(S, device="cuda")[None, None, :] <= pos[:, :, None]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the profiler's notes on its cycles
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = monotonic()
            sl, _ = model.spec_forward(tp, snap, fed, pos, pos, mask)
            torch.cuda.synchronize()
            wall_ms = (monotonic() - t1) * 1e3
    counts = ops.launch_counts()
    want = torch.cat(toks[1:], 1)[0].tolist()
    got = sl[0].argmax(-1).tolist()
    if got != want:
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        fail(f"family (h5): spec_forward's argmax differs from the decode's token at position "
             f"{j} ({got[j]} against {want[j]})")
    print(f"family (h5): prefill, {n} greedy decode steps and one spec_forward of the same "
          f"{n} tokens under a causal chain mask: argmax equal at all {n} positions on {card}",
          flush=True)
    print(f"family (h5): kernel launches {counts}", flush=True)
    report_trace(prof, "family (h5) spec_forward", "h5", 1, wall_ms)
    missing = [k for k in ("tree_attention", "decode_attention", "fused_swiglu") if counts[k] == 0]
    if missing:
        fail(f"family (h5): kernels never launched on the path: {missing}")
    del tp, model, cache, snap
    torch.cuda.empty_cache()
    return counts


def phase_shapes(torch, log: ShapeLog, card):
    """Hold each kernel against its plain version at every shape a path
    called it with: random inputs (plans, lengths) at that shape, f32 and
    bf16 to the stated tolerance, moves and slot writes exactly."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    n = 0
    for name, keys in log.seen.items():
        for key in sorted(keys, key=str):
            dtype = getattr(torch, key[-1].removeprefix("torch."))
            what = f"{name} at the path shape {key[:-1]} {dtype}"
            if name == "tree_attention":
                B, nq, hq, hd, S, hkv = key[:6]
                q, k, v = randn((B, nq, hq, hd), dtype), randn((B, S, hkv, hd), dtype), \
                    randn((B, S, hkv, hd), dtype)
                mask = torch.rand((B, nq, S), generator=gen, device="cuda") < 0.5
                check_close(what, ops.tree_attention(q, k, v, mask),
                            ref.tree_attention_ref(q, k, v, mask), dtype)
            elif name == "decode_attention":
                B, hq, hd, S, hkv = key[:5]
                q, k, v = randn((B, hq, hd), dtype), randn((B, S, hkv, hd), dtype), \
                    randn((B, S, hkv, hd), dtype)
                lens = torch.randint(0, S + 1, (B,), generator=gen, device="cuda",
                                     dtype=torch.int32)
                got = ops.decode_attention(q, k, v, lens)
                check_close(what, got, ref.decode_attention_ref(q, k, v, lens), dtype)
                mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
                if not torch.equal(got, ops.tree_attention(q[:, None], k, v, mask[:, None])[:, 0]):
                    fail(f"{what}: differs from tree_attention at n=1")
            elif name == "fused_swiglu":
                M, K, N = key[:3]
                x, wg, wu = randn((M, K), dtype), randn((K, N), dtype) * K ** -0.5, \
                    randn((K, N), dtype) * K ** -0.5
                check_close(what, ops.fused_swiglu(x, wg, wu), ref.fused_swiglu_ref(x, wg, wu),
                            dtype)
            elif name in ("kv_move_rows", "kv_move_leaves"):
                shapes, M, donate = key[:3]
                shapes = [shapes] if name == "kv_move_rows" else list(shapes)
                leaves = [randn(sh, dtype) for sh in shapes]
                B, S = shapes[0][1], shapes[0][2]
                src = torch.randint(-1, S, (B, M), generator=gen, device="cuda", dtype=torch.int32)
                dst = torch.stack([torch.randperm(S, generator=gen, device="cuda")[:M]
                                   for _ in range(B)]).to(torch.int32)
                mask = torch.rand((B, M), generator=gen, device="cuda") < 0.8
                want = [ref.kv_move_rows_ref(x, src, dst, mask) for x in leaves]
                got = ops.kv_move_leaves([x.clone() for x in leaves], src, dst, mask,
                                         donate=donate)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"{what}: kernel disagrees with the plain version leaf by leaf "
                         "(must be exact)")
            elif name == "int4_matmul":
                from repro_torch import quant

                M, K, N, g = key[:4]
                q = quant.quantize_groupwise(randn((K, N), torch.float32) * K ** -0.5, g)
                x = randn((M, K), dtype)
                check_close(what, ops.int4_matmul(x, *q[:3], group_size=g),
                            ref.int4_matmul_ref(x, *q[:3], g), dtype, INT4_TOL)
            else:  # slot_write_rows
                shapes, zero = key[:2]
                leaves = [randn(sh, dtype) for sh in shapes]
                donors = None if zero else [randn((sh[0], 1) + sh[2:], dtype) for sh in shapes]
                slot = shapes[0][1] - 1
                want = ref.slot_write_rows_ref(leaves, donors, slot)
                got = ops.slot_write_rows([t.clone() for t in leaves], donors, slot)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"{what}: kernel disagrees with the plain version (must be exact)")
            n += 1
        torch.cuda.synchronize()
    print(f"shapes: {n} shapes that the paths launched, each held against its plain version "
          f"again ({', '.join(f'{k} {len(v)}' for k, v in log.seen.items())}) on {card}",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script needs one CUDA GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import monotonic

    _CLOCK.append(monotonic())

    # full float32 products: with TF32 the greedy-equality check would compare
    # two different arithmetics
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("TF32 is on for float32 products")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"[{smi}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, python {sys.version.split()[0]}")

    phase_build()
    timing("build")
    timer = Timer(torch)
    rows = phase_kernels(torch, timer, card)
    timing("kernels")
    log = ShapeLog(ops)
    log.install()
    counts, weights = phase_serve(torch, card)
    counts["e"] = phase_awq(torch, timer, rows, weights, card)
    del weights  # the 8B and 1B weights go before zamba2's are drawn
    timing("awq (e)")
    counts.update(phase_chain(torch, card))
    torch.cuda.empty_cache()
    timing("chain (d1)-(d2)")
    counts.update(phase_dense(torch, card))
    timing("dense (f1)-(f3)")
    counts.update(phase_rwkv(torch, card))
    torch.cuda.empty_cache()
    timing("chain (g1)-(g2s)")
    counts.update(phase_families(torch, card))
    timing("families (h1)-(h5)")
    log.uninstall()
    phase_shapes(torch, log, card)
    timing("shapes")
    kernels = []
    for name in ALL_KERNELS:
        r = dict(rows[name])
        r["launches"] = sum(c[name] for c in counts.values())
        r["launches_by_run"] = {run: c[name] for run, c in counts.items()}
        r["card"] = smi
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
